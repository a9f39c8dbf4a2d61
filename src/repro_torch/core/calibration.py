"""PTQ calibration (paper §3.4): static activation scales from one batch.
Port of `repro/core/calibration.py` (the artifact path; the sensitivity
pass and `auto_mixed` are not ported).

The flow, as in the reference (docs/calibration.md):

  1. run the model forward under `collecting_activations(tape)`:
     `qlinear.qmatmul` tapes every matmul input under its site address
     (or feed `run_calibration` an `apply_collect` callback),
  2. `calibrate_activation_scales` MSE-searches a static scale per site
     (3σ-seeded) and `CalibrationArtifact` captures the scales plus
     their provenance; `save`/`load` write and read the reference's JSON
     byte for byte,
  3. `apply_calibration(policy, artifact)` overlays the artifact on the
     policy program (`CalibratedProgram`): every covered site resolves
     with `act_scale_mode="static"` and its `static_act_scale`, which the
     `cuda` backend hands to the static-scale matmul kernel (K5) as one
     scalar, so no per-step 3σ std runs,
  4. the serving engine checks up front that every static-mode site has
     a scale (`static_scale_misses`; misses raise
     `MissingStaticScaleError`).

The tape subsamples with one `np.random.default_rng(seed)` shared by all
sites, in the order sites are recorded, exactly as the reference does:
the same inputs recorded in the same order give the same samples.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import functools
import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .ovp import MixedExpertQuant, QuantizedTensor
from .policy import PolicyLike, PolicyProgram, QuantPolicy, as_program
from .quantizer import ovp_search_scale


class ActTape:
    """Activation tape threaded through calibration runs: at most
    `max_per_site` float32 samples per site, drawn without replacement
    from one numpy generator."""

    def __init__(self, max_per_site: int = 65536, seed: int = 0):
        self.max_per_site = max_per_site
        self.rng = np.random.default_rng(seed)
        self.samples: Dict[str, np.ndarray] = {}

    def record(self, name: str, x) -> None:
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32).numpy()
        flat = np.asarray(x, dtype=np.float32).reshape(-1)
        if flat.size > self.max_per_site:
            idx = self.rng.choice(flat.size, self.max_per_site, replace=False)
            flat = flat[idx]
        prev = self.samples.get(name)
        if prev is not None:
            both = np.concatenate([prev, flat])
            if both.size > self.max_per_site:
                idx = self.rng.choice(both.size, self.max_per_site,
                                      replace=False)
                both = both[idx]
            self.samples[name] = both
        else:
            self.samples[name] = flat


_ACTIVE_TAPE: Optional[ActTape] = None


@contextlib.contextmanager
def collecting_activations(tape: ActTape):
    """Install `tape` as the process-wide activation tape: while active,
    every `qlinear.qmatmul` records its input under the call's site
    address, so one `model.forward(...)` yields a tape keyed exactly like
    the quantized tree."""
    global _ACTIVE_TAPE
    prev, _ACTIVE_TAPE = _ACTIVE_TAPE, tape
    try:
        yield tape
    finally:
        _ACTIVE_TAPE = prev


def tap(site: str, x) -> None:
    """Record one matmul input on the active tape (no-op when inactive or
    when the site is anonymous)."""
    tape = _ACTIVE_TAPE
    if tape is None or not site:
        return
    tape.record(site, x)


def calibrate_activation_scales(tape: ActTape, normal_dtype="int4",
                                n_grid: int = 24, device="cpu"
                                ) -> Dict[str, torch.Tensor]:
    """Per-site static scales via the OVP MSE search (3σ-seeded), keyed
    by the tape's sites in sorted order, searched on `device`.
    `normal_dtype` is one dtype string or a ``site -> dtype`` callable."""
    dtype_for = normal_dtype if callable(normal_dtype) \
        else (lambda _site: normal_dtype)
    scales = {}
    for name, sample in sorted(tape.samples.items()):
        s = sample[:-1] if sample.size % 2 else sample  # pairs need even
        scales[name] = ovp_search_scale(torch.as_tensor(s, device=device),
                                        dtype_for(name), n_grid=n_grid)
    return scales


def run_calibration(apply_collect: Callable, params, batches: Iterable,
                    normal_dtype: str = "int4",
                    max_per_site: int = 65536) -> Dict[str, torch.Tensor]:
    """apply_collect(params, batch) -> (out, acts: dict[str, tensor]):
    tape every returned activation over the batches, return the static
    scale per site."""
    tape = ActTape(max_per_site=max_per_site)
    for batch in batches:
        _, acts = apply_collect(params, batch)
        for name, x in acts.items():
            tape.record(name, x)
    return calibrate_activation_scales(tape, normal_dtype)


_ARTIFACT_KIND = "olive-calibration"
_ARTIFACT_VERSION = 1


class MissingStaticScaleError(ValueError):
    """A static-mode site has no calibrated activation scale. `.sites`
    lists the offending addresses; the message is one
    `missing_static_scale sites=[...]` line."""

    def __init__(self, sites):
        self.sites = sorted(sites)
        super().__init__(f"missing_static_scale sites={self.sites}")


@dataclasses.dataclass(frozen=True)
class CalibrationArtifact:
    """Per-site static activation scales plus their provenance.

    `scales` maps site addresses (or `fnmatch` globs over them) to the
    calibrated scale, in author order: the first matching key wins.
    `normal_dtype` is the A-side dtype the search targeted, `program`
    the policy the tape ran under, `meta` free-form strings."""

    scales: Tuple[Tuple[str, float], ...]
    normal_dtype: str = "int4"
    program: str = ""
    meta: Tuple[Tuple[str, str], ...] = ()

    @classmethod
    def from_scales(cls, scales: Dict[str, object],
                    normal_dtype: str = "int4", program: str = "",
                    **meta) -> "CalibrationArtifact":
        return cls(scales=tuple((k, float(v)) for k, v in scales.items()),
                   normal_dtype=normal_dtype, program=program,
                   meta=tuple(sorted((k, str(v)) for k, v in meta.items())))

    def as_dict(self) -> Dict[str, float]:
        """Keys -> scales, the first occurrence winning on duplicates."""
        d: Dict[str, float] = {}
        for k, v in self.scales:
            d.setdefault(k, v)
        return d

    def sites(self) -> List[str]:
        return [k for k, _ in self.scales]

    def resolve(self, site: str) -> Optional[float]:
        """Scale for one site: the FIRST key that equals it or matches it
        as a case-insensitive glob, in author order."""
        low = site.lower()
        for pattern, s in self.scales:
            if pattern == site or fnmatch.fnmatchcase(low,
                                                      pattern.lower()):
                return s
        return None

    def save(self, path: str) -> str:
        payload = {
            "kind": _ARTIFACT_KIND, "version": _ARTIFACT_VERSION,
            "normal_dtype": self.normal_dtype, "program": self.program,
            "meta": dict(self.meta),
            "scales": self.as_dict(),
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            # no sort_keys: glob-key precedence is positional
            json.dump(payload, f, indent=2)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationArtifact":
        with open(path) as f:
            payload = json.load(f)
        if payload.get("kind") != _ARTIFACT_KIND:
            raise ValueError(f"{path}: not a calibration artifact "
                             f"(kind={payload.get('kind')!r})")
        if not isinstance(payload.get("scales"), dict):
            raise ValueError(f"{path}: artifact has no 'scales' dict")
        return cls(scales=tuple((str(k), float(v)) for k, v
                                in payload["scales"].items()),
                   normal_dtype=str(payload.get("normal_dtype", "int4")),
                   program=str(payload.get("program", "")),
                   meta=tuple(sorted((str(k), str(v)) for k, v in
                                     payload.get("meta", {}).items())))


@dataclasses.dataclass(frozen=True)
class CalibratedProgram(PolicyProgram):
    """A `PolicyProgram` with a `CalibrationArtifact` overlaid per site:
    `resolve(site)` resolves the base program first, then, when the
    artifact covers the concrete site, sets `act_scale_mode="static"` and
    `static_act_scale` on the resolved policy. `replace_all` and
    `with_backend` keep the overlay."""
    artifact: CalibrationArtifact = CalibrationArtifact(scales=())

    def resolve(self, site: str) -> QuantPolicy:
        return _calibrated_resolve(self, site)

    def replace_all(self, **kw) -> "CalibratedProgram":
        base = PolicyProgram.replace_all(self, **kw)
        return CalibratedProgram(rules=base.rules, default=base.default,
                                 name=base.name, artifact=self.artifact)


@functools.lru_cache(maxsize=65536)
def _calibrated_resolve(program: CalibratedProgram,
                        site: str) -> QuantPolicy:
    pol = PolicyProgram.resolve(program, site)
    s = program.artifact.resolve(site)
    if s is None:
        return pol
    return dataclasses.replace(pol, act_scale_mode="static",
                               static_act_scale=float(s))


def apply_calibration(policy: PolicyLike,
                      artifact: CalibrationArtifact) -> CalibratedProgram:
    """Overlay an artifact on a policy: covered sites resolve static with
    their scale, the rest keep the base program's behaviour. A second
    artifact stacks in front (its keys win where both cover a site)."""
    prog = as_program(policy)
    if isinstance(prog, CalibratedProgram):
        artifact = dataclasses.replace(
            artifact, scales=artifact.scales + prog.artifact.scales)
    return CalibratedProgram(rules=prog.rules, default=prog.default,
                             name=prog.name, artifact=artifact)


def calibrate_model(model, params, batches: Iterable,
                    normal_dtype: Optional[str] = None, n_grid: int = 24,
                    max_per_site: int = 65536) -> CalibrationArtifact:
    """Run the model's prefill forward (no cache) on each batch with the
    tape installed, MSE-search a static scale per taped site on the
    params' device, and wrap the result as an artifact.

    `normal_dtype` defaults to each site's A-side dtype under the model's
    policy (8-bit activations int8, 4-bit the policy's `a_normal_dtype`).
    Run it on the raw (pre-`quantize_params`) tree: the taped values are
    then the fp activations the paper calibrates on, under the same site
    addresses the quantized tree has. The port's layers are unrolled, so
    the sites are `layers/<i>/...` as the reference's unrolled twin
    tapes them."""
    from repro_torch.backends.base import act_normal_dtype

    from .qlinear import tree_paths
    if normal_dtype is None:
        policy_prog = as_program(model.policy)

        def normal_dtype(site):
            pol = policy_prog.resolve(site)
            return act_normal_dtype(pol) if pol.abits \
                else pol.a_normal_dtype
    device = next(w.device for _, w in tree_paths(params)
                  if isinstance(w, torch.Tensor))
    tape = ActTape(max_per_site=max_per_site)
    n_batches = 0
    with collecting_activations(tape):
        for batch in batches:
            model.forward(params, batch, mode="prefill")
            n_batches += 1
    scales = calibrate_activation_scales(tape, normal_dtype, n_grid=n_grid,
                                         device=device)
    prog = getattr(model.policy, "name", "") or type(model.policy).__name__
    dtypes = {normal_dtype(s) for s in scales} if callable(normal_dtype) \
        else {normal_dtype}
    return CalibrationArtifact.from_scales(
        scales, normal_dtype=dtypes.pop() if len(dtypes) == 1 else "mixed",
        program=prog, n_batches=n_batches, max_per_site=max_per_site)


def static_scale_misses(params, policy: PolicyLike) -> List[str]:
    """Quantized-weight sites whose resolved policy quantizes activations
    at a static scale but has none calibrated. Expert stacks (3-D or
    `MixedExpertQuant` leaves under `.../experts/...`) run weight-only
    (`layers._expert_ein` forces `abits=0`) and are skipped, as in the
    reference. The serving engine raises `MissingStaticScaleError` on a
    non-empty result."""
    from .qlinear import tree_paths

    def needs_scale(pol: QuantPolicy) -> bool:
        return (pol.enabled and pol.abits > 0
                and pol.act_scale_mode == "static"
                and pol.static_act_scale is None)

    misses = []
    for path, w in tree_paths(params):
        if isinstance(w, MixedExpertQuant) or (
                isinstance(w, QuantizedTensor) and w.data.ndim > 2):
            if "/experts/" in f"/{path}/":
                continue
        if isinstance(w, QuantizedTensor):
            misses += [path] if needs_scale(policy.resolve(path)) else []
        elif isinstance(w, MixedExpertQuant):
            misses += [f"{path}/{e}" for e in range(w.n_experts)
                       if needs_scale(policy.resolve(f"{path}/{e}"))]
    return misses


def uses_static_scales(policy: PolicyLike) -> bool:
    """True when any rule (or the default) quantizes activations under
    `act_scale_mode="static"`, or a calibration overlay can force sites
    static: the gate for the engine's validation."""
    prog = as_program(policy)
    pols = [prog.default] + [r.policy for r in prog.rules]
    quantizing = [p for p in pols if p.enabled and p.abits > 0]
    if any(p.act_scale_mode == "static" for p in quantizing):
        return True
    return bool(quantizing) and isinstance(prog, CalibratedProgram) \
        and bool(prog.artifact.scales)
