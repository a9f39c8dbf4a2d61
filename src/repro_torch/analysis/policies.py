"""Policy pass: resolve preset programs against the config zoo.

The site universe is built the way serving builds it: every arch in
`repro_torch.configs.ARCHS` at reduced size, its params drawn on the
"meta" device (shapes only: no weight is drawn and no memory is
touched), `qlinear.tree_paths` + `is_linear_weight` keeping exactly the
sites the quantizer resolves, plus the per-layer `layers/<i>/attn/kv`
cache addresses of attention archs. The port's layers are always
unrolled (`layers/<i>/...`), as the reference's are under a
layer-addressed program; its encoder is a list of blocks that all
resolve at the reference's stacked address `enc_blocks/<leaf>`, so the
encoder's sites are taken once, without the index. The universe equals
the reference's `site_universes()` (tests/test_torch_analysis.py).

Checks over every preset `PolicyProgram` (flat presets compile to an
all-"compat" rule fan and are exempt, see `core.policy.Rule`):

- **POL_DEAD_RULE**: an authored rule matches no site of any arch.
- **POL_SHADOWED**: an authored rule matches sites, but an earlier rule
  matches first on every one of them.
- **POL_DEAD_GLOB**: a calibration-artifact scale key (exact or fnmatch
  glob) matches no site.

Fixture modules may define `analysis_programs() -> [(name, program)]`
and `analysis_artifacts() -> [(name, {key: scale})]`.
"""
from __future__ import annotations

import fnmatch
import functools
import importlib.util
import re
from pathlib import Path
from typing import Dict, List, Sequence, Set

from . import Finding


@functools.lru_cache(maxsize=None)
def _universes():
    from repro_torch.configs import ARCHS
    from repro_torch.core.qlinear import ENCODER, is_linear_weight, tree_paths
    from repro_torch.models.model import build_model

    universes = {}
    for name, cfg in ARCHS.items():
        cfg = cfg.reduced()
        params = build_model(cfg, remat=False).init(None, device="meta")
        if ENCODER in params:       # one stacked address for every block
            params[ENCODER] = params[ENCODER][0]
        sites = [path for path, w in tree_paths(params)
                 if is_linear_weight(path, w)]
        layer_ids = {m.group(1) for s in sites
                     for m in [re.match(r"layers/(\d+)/", s)] if m}
        if any("attn/" in s for s in sites):
            sites += [f"layers/{i}/attn/kv" for i in sorted(layer_ids)]
        universes[name] = tuple(sites)
    return universes


def site_universes() -> Dict[str, List[str]]:
    """{arch name: [site, ...]} for the whole zoo (memoized: the zoo's
    shapes do not change in a process)."""
    return {name: list(sites) for name, sites in _universes().items()}


def _first_match(program, site: str) -> int:
    for i, rule in enumerate(program.rules):
        if rule.matches(site):
            return i
    return -1


def _check_program(name: str, programs_by_arch,
                   universes: Dict[str, List[str]]) -> List[Finding]:
    """`programs_by_arch` maps an arch name to the program made for that
    arch (a layer-addressed preset depends on n_layers)."""
    findings: List[Finding] = []
    # an authored rule is (index in the program, pattern); the programs
    # of the archs share their structure, so the indexes line up
    matched: Dict[int, Set[str]] = {}
    reached: Set[int] = set()
    patterns: Dict[int, str] = {}
    for arch, sites in universes.items():
        program = programs_by_arch[arch]
        authored = {i for i, r in enumerate(program.rules)
                    if r.origin != "compat"}
        for i in authored:
            patterns[i] = program.rules[i].pattern
        for site in sites:
            hit = _first_match(program, site)
            for i in authored:
                if program.rules[i].matches(site):
                    matched.setdefault(i, set()).add(f"{arch}:{site}")
            if hit in authored:
                reached.add(hit)
    for i, pattern in sorted(patterns.items()):
        if i not in matched:
            findings.append(Finding(
                "POL_DEAD_RULE", f"{name}[{i}]",
                f"rule pattern {pattern!r} matches no site of any arch "
                f"in the config zoo"))
        elif i not in reached:
            findings.append(Finding(
                "POL_SHADOWED", f"{name}[{i}]",
                f"rule pattern {pattern!r} matches sites but an earlier "
                f"rule always wins (first-match precedence)"))
    return findings


def _check_artifact(name: str, scales,
                    all_sites: List[str]) -> List[Finding]:
    findings: List[Finding] = []
    keys = scales.keys() if hasattr(scales, "keys") else \
        [k for k, _ in scales]
    for key in keys:
        low = key.lower()
        if not any(key == s or fnmatch.fnmatchcase(s.lower(), low)
                   for s in all_sites):
            findings.append(Finding(
                "POL_DEAD_GLOB", f"{name}[{key}]",
                f"calibration scale key {key!r} matches no site of any "
                f"arch in the config zoo"))
    return findings


def _load_fixture(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"_analysis_fixture_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check(fixtures: Sequence[str] = ()) -> List[Finding]:
    from repro_torch.configs import ARCHS
    from repro_torch.core.policy import PROGRAM_PRESETS

    universes = site_universes()
    all_sites = [s for sites in universes.values() for s in sites]
    findings: List[Finding] = []
    for name, make in PROGRAM_PRESETS.items():
        programs_by_arch = {arch: make(cfg.reduced().n_layers)
                    for arch, cfg in ARCHS.items()}
        findings.extend(_check_program(name, programs_by_arch, universes))
    for f in fixtures:
        if not str(f).endswith(".py"):
            continue
        mod = _load_fixture(Path(f))
        for name, program in getattr(mod, "analysis_programs",
                                     lambda: [])():
            programs_by_arch = {arch: program for arch in universes}
            findings.extend(_check_program(name, programs_by_arch, universes))
        for name, scales in getattr(mod, "analysis_artifacts",
                                    lambda: [])():
            findings.extend(_check_artifact(name, scales, all_sites))
    return findings
