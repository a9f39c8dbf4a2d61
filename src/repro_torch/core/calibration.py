"""PTQ calibration (paper §3.4): static activation scales from one batch,
and the per-site sensitivity pass that emits a mixed-precision program.
Port of `repro/core/calibration.py`.

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

`calibrate_model` runs steps 1-2 on a whole fp32 tree;
`calibrate_streamed` draws the model one layer at a time, feeds every
batch through each layer as soon as it is drawn, quantizes it and drops
its fp32 weights, so a model whose fp32 tree does not fit the card
calibrates there, with the same artifact.

The sensitivity pass: `record_weights` tapes every linear weight (whole,
or one layer at a time), `site_sensitivity` measures each site's SQNR
at its best low-precision scale, and `auto_mixed` promotes the least
faithful sites to W8 within a bit budget.

The tape subsamples with one `np.random.default_rng(seed)` shared by all
sites, in the order sites are recorded, exactly as the reference does:
the same inputs recorded in the same order give the same samples. The
draws depend on the record sizes alone, so `ActTape.plan` can make them
up front in a whole pass's order (its sizes come from a `SizeTape`, fed
by a pass over `device="meta"` weights) and the records may then come in
any order. A record draws its indices on the host and gathers them on
the tensor's device: only the sample is copied to the host.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import fnmatch
import functools
import json
import math
import os
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .ovp import MixedExpertQuant, QuantizedTensor, ovp_fake_quant
from .policy import (OLIVE_W4A4, OLIVE_W8A8, PolicyLike, PolicyProgram,
                     QuantPolicy, Rule, as_program)
from .quantizer import ovp_search_scale


class ActTape:
    """Activation tape threaded through calibration runs: at most
    `max_per_site` float32 samples per site, drawn without replacement
    from one numpy generator."""

    def __init__(self, max_per_site: int = 65536, seed: int = 0):
        self.max_per_site = max_per_site
        self.rng = np.random.default_rng(seed)
        self.samples: Dict[str, np.ndarray] = {}
        self._planned: Dict[str, collections.deque] = {}

    def _draw(self, n: int, n_prev: Optional[int]):
        """The index draws of one record of `n` values onto a site that
        holds `n_prev` samples (None: a new site): a subsample of the
        record, then of the concatenation, each when over the cap."""
        k = self.max_per_site
        first = self.rng.choice(n, k, replace=False) if n > k else None
        both = None if n_prev is None else n_prev + min(n, k)
        merge = self.rng.choice(both, k, replace=False) \
            if both is not None and both > k else None
        return first, merge

    def plan(self, records: Iterable[Tuple[str, int]]) -> "ActTape":
        """Make now the draws of a whole pass whose records are `records`
        ((site, size) in that pass's order); each later `record` of a
        site takes that site's next draws, so the samples are the
        pass's whatever order the sites come in. A record the plan does
        not hold, or of another size, raises."""
        held: Dict[str, int] = {}
        for name, n in records:
            prev = held.get(name)
            self._planned.setdefault(name, collections.deque()).append(
                (n,) + self._draw(n, prev))
            m = min(n, self.max_per_site)
            held[name] = m if prev is None \
                else min(prev + m, self.max_per_site)
        return self

    def record(self, name: str, x) -> None:
        on_device = isinstance(x, torch.Tensor)
        flat = x.detach().reshape(-1) if on_device \
            else np.asarray(x, dtype=np.float32).reshape(-1)
        n = flat.numel() if on_device else flat.size
        prev = self.samples.get(name)
        if self._planned:
            queue = self._planned.get(name)
            if not queue or queue[0][0] != n:
                raise ValueError(f"tape record {name!r} of {n} values is "
                                 f"not the plan's next record of that site")
            _, first, merge = queue.popleft()
        else:
            first, merge = self._draw(n, None if prev is None else prev.size)
        if first is not None:
            flat = flat[torch.as_tensor(first, device=flat.device)] \
                if on_device else flat[first]
        if on_device:
            flat = flat.to("cpu", torch.float32).numpy()
        if prev is not None:
            both = np.concatenate([prev, flat])
            self.samples[name] = both if merge is None else both[merge]
        else:
            self.samples[name] = flat


class SizeTape:
    """A tape that keeps only the (site, size) of each record, in order:
    the input of `ActTape.plan`. Fed by a pass over weights on
    `device="meta"`, it costs no memory and no arithmetic."""

    def __init__(self):
        self.records: List[Tuple[str, int]] = []

    def record(self, name: str, x) -> None:
        self.records.append((name, x.numel()))


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


@contextlib.contextmanager
def tape_suspended():
    """No tape inside the block (the active one, if any, comes back
    after): what the reference's encoder, run under `jax.lax.scan`
    (which traces its body even eagerly), never records."""
    global _ACTIVE_TAPE
    prev, _ACTIVE_TAPE = _ACTIVE_TAPE, None
    try:
        yield
    finally:
        _ACTIVE_TAPE = prev


def tap(site: str, x) -> None:
    """Record one matmul input on the active tape (no-op when inactive or
    when the site is anonymous)."""
    tape = _ACTIVE_TAPE
    if tape is None or not site:
        return
    tape.record(site, x)


def _sorted_paths(tree, prefix: str = ""):
    """(path, leaf) pairs in the reference's flatten order: dict keys
    sorted (`jax.tree_util` sorts them), lists in index order."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [pair for k, v in items
            for pair in _sorted_paths(v, f"{prefix}/{k}" if prefix
                                      else str(k))]


def record_weights(params, tape=None, min_size: int = 4096,
                   prefix: str = ""):
    """Tape every linear-weight leaf (2-D, or a 3-D expert stack, of at
    least `min_size` values) under its site address, in the reference's
    order: the weight-side twin of the activation tape, on the addresses
    `quantize_params` resolves. `prefix` is the site address of
    `params` (`layers/<i>` when fed one layer at a time, with the tape
    planned over the whole tree: `record_weights(meta_tree,
    SizeTape()).records`). Samples are gathered on the weights'
    device."""
    from .qlinear import is_linear_weight
    tape = tape if tape is not None else ActTape()
    for path, w in _sorted_paths(params, prefix):
        if is_linear_weight(path, w) and w.numel() >= min_size:
            tape.record(path, w)
    return tape


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


def _site_act_dtypes(policy: PolicyLike) -> Callable[[str], str]:
    """site -> the A-side dtype its activations quantize to under
    `policy` (8-bit activations int8, 4-bit the `a_normal_dtype`)."""
    from repro_torch.backends.base import act_normal_dtype
    prog = as_program(policy)

    def normal_dtype(site):
        pol = prog.resolve(site)
        return act_normal_dtype(pol) if pol.abits else pol.a_normal_dtype
    return normal_dtype


def _artifact(model, tape: ActTape, normal_dtype, n_grid: int, device,
              n_batches: int, max_per_site: int) -> CalibrationArtifact:
    """MSE-search a static scale per taped site on `device`, as an
    artifact with the model's provenance."""
    if normal_dtype is None:
        normal_dtype = _site_act_dtypes(model.policy)
    scales = calibrate_activation_scales(tape, normal_dtype, n_grid=n_grid,
                                         device=device)
    prog = getattr(model.policy, "name", "") or type(model.policy).__name__
    dtypes = {normal_dtype(s) for s in scales} if callable(normal_dtype) \
        else {normal_dtype}
    return CalibrationArtifact.from_scales(
        scales, normal_dtype=dtypes.pop() if len(dtypes) == 1 else "mixed",
        program=prog, n_batches=n_batches, max_per_site=max_per_site)


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
    tapes them. An encoder-decoder's encoder layers stay off the tape
    (`Model.encode`), as the reference's scanned encoder does: its
    frontend projection, decoder and head sites are taped, and under
    `apply_calibration` the encoder keeps the base policy."""
    from .qlinear import tree_paths
    device = next(w.device for _, w in tree_paths(params)
                  if isinstance(w, torch.Tensor))
    tape = ActTape(max_per_site=max_per_site)
    n_batches = 0
    with collecting_activations(tape):
        for batch in batches:
            model.forward(params, batch, mode="prefill")
            n_batches += 1
    return _artifact(model, tape, normal_dtype, n_grid, device, n_batches,
                     max_per_site)


def calibrate_streamed(model, generator: torch.Generator,
                       batches: Sequence, device,
                       quantize: Callable[[dict, str], dict],
                       normal_dtype: Optional[str] = None, n_grid: int = 24,
                       max_per_site: int = 65536):
    """`calibrate_model` on the tree `model.init(generator, device)`
    draws, without that tree: the weights are drawn in `Model.init`'s
    order (embedding and head, an encoder-decoder's encoder, then the
    layers); the encoder, as soon as it is drawn, runs on every batch's
    "frames" (its frontend projection taped, its layers not, as in
    `calibrate_model`), is quantized by `quantize(layers, ENCODER)` and
    dropped; each layer, as soon as it is drawn, takes every batch's
    hidden states forward under the tape, is quantized by
    `quantize(tree, "layers/<i>")` and its fp32 weights are dropped; the
    head is taped last, then the embedding and head are quantized
    (`quantize(tree, "")`). The tape is planned over a forward of the
    same model on `device="meta"`, so its samples, and the artifact's
    JSON, are byte for byte `calibrate_model`'s on the whole tree, at any
    number of batches. Returns (params, artifact): the params equal
    `quantize` of the whole tree (a frontend's projection is quantized
    with the embedding and head)."""
    from repro_torch.models.model import block_forward
    from .qlinear import ENCODER
    batches = list(batches)
    sizes = SizeTape()
    meta = model.init(None, device="meta")
    with collecting_activations(sizes):
        for batch in batches:
            model.forward(meta, {key: val.to("meta")
                                 for key, val in batch.items()},
                          mode="prefill")
    del meta
    tape = ActTape(max_per_site=max_per_site).plan(sizes.records)
    pieces = model.init_stream(generator, device)
    _, rest = next(pieces)
    hidden = [model.embed(rest, batch["tokens"]) for batch in batches]
    positions = [torch.arange(x.shape[1], device=x.device)[None]
                 .expand(x.shape[0], x.shape[1]) for x in hidden]
    enc_out = [None] * len(batches)
    layers, encoder = [], None
    with collecting_activations(tape):
        for prefix, block in pieces:
            if prefix == ENCODER:
                enc_out = [model.encode(dict(rest, **{ENCODER: block}),
                                        batch["frames"])
                           for batch in batches]
                encoder = quantize(block, ENCODER)
                del block
                continue
            hidden = [block_forward(block, x, pos, model.cfg, model.policy,
                                    site=prefix, enc_out=enc)[0]
                      for x, pos, enc in zip(hidden, positions, enc_out)]
            layers.append(quantize(block, prefix))
            del block       # before the next layer is drawn
        for x in hidden:
            model.head(rest, x)
    artifact = _artifact(model, tape, normal_dtype, n_grid, device,
                         len(batches), max_per_site)
    params = dict(quantize(rest, ""), layers=layers)
    if encoder is not None:
        params[ENCODER] = encoder
    return params, artifact


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


def site_sensitivity(tape: ActTape, normal_dtype: str = "int4",
                     n_grid: int = 16, device="cpu") -> Dict[str, float]:
    """Per-site SQNR (dB) of the best `normal_dtype` OVP round trip of
    the site's samples, searched on `device`, keyed in sorted order. The
    lowest SQNR loses the most signal at low precision: the first
    candidate for more bits."""
    out = {}
    for name, sample in sorted(tape.samples.items()):
        s = sample[:-1] if sample.size % 2 else sample
        x = torch.as_tensor(s, device=device)
        scale = ovp_search_scale(x, normal_dtype, n_grid=n_grid)
        mse = float(((ovp_fake_quant(x, scale, normal_dtype) - x) ** 2)
                    .mean())
        power = float((x * x).mean())
        out[name] = 10.0 * math.log10(max(power, 1e-30) / max(mse, 1e-30))
    return out


def auto_mixed(sensitivity: Dict[str, float], budget_bits: float = 4.5,
               low: Optional[QuantPolicy] = None,
               high: Optional[QuantPolicy] = None) -> PolicyProgram:
    """A mixed-precision program from a sensitivity map: sites rank by
    ascending SQNR and the most sensitive get `high` (default W8A8 OVP)
    while the mean weight width over the quantized sites stays within
    `budget_bits`; the rest resolve through the compiled `low` program
    (default W4A4 OVP with its embed/router exclusions, which outrank
    sensitivity: a site `low` keeps at full precision is never
    promoted). Rules are the literal site addresses."""
    low = OLIVE_W4A4 if low is None else low
    high = OLIVE_W8A8 if high is None else high
    base = PolicyProgram.from_policy(low, name="auto_mixed")
    candidates = {k: v for k, v in sensitivity.items()
                  if base.resolve(k).enabled}
    if not candidates:
        return base
    span = high.wbits - low.wbits
    frac_high = 0.0 if span <= 0 else \
        min(max((budget_bits - low.wbits) / span, 0.0), 1.0)
    n_high = int(frac_high * len(candidates))
    ranked = sorted(candidates, key=lambda k: candidates[k])
    return base.with_rules([Rule(site, high) for site in ranked[:n_high]])
