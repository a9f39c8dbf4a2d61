"""The port's policy programs against the reference's (`repro.core.policy`):

- every preset (flat and program), with and without `--policy-rules`,
  built in the launcher's order (`get_program` or `get_policy`, then
  `with_rules(parse_rules(...))`, then the launcher's `replace_all`
  rewrite), resolves every site of `qwen1.5-0.5b-smoke` and
  `qwen3-moe-30b-a3b-smoke` to the reference's fields: each weight and
  norm leaf, each `layers/<i>/attn/kv`, and each per-expert sub-site
  `.../experts/w?/<e>`. The backend is the one field that differs by
  design (the port's default is `cuda`, the reference's `xla`); `qat`
  (QAT's flag) is compared with the rest;
- `kv_bits`, `enabled`, `compute_dtype`, `backends` and resolution on the
  reference's own cases (`tests/test_policy_program.py`: rule
  precedence, `with_rules`, a layer-uniform `layers/` rule, a per-layer
  KV rule, rules over a program preset, the presets);
- `quantize_params` under `olive_mixed_w48` on weights carried across
  from numpy: the same `normal_dtype` on every leaf and byte-equal codes,
  scales within the 1e-6 relative of the PTQ tests (XLA's std sums in
  another order, ROADMAP section 3);
- a per-expert rule gives `MixedExpertQuant` stacks with the reference's
  `expert_ids` and groups.
Exact otherwise.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import policy as jpol
from repro.core.ovp import MixedExpertQuant as JMixed
from repro.core.qlinear import quantize_params as _j_quantize_params
from repro.core.qlinear import tree_paths as j_tree_paths
from repro.models.model import build_model as j_build_model
from repro.models.model import unroll_params
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.core import qlinear as tq
from repro_torch.core.ovp import MixedExpertQuant, QuantizedTensor
from repro_torch.models.model import build_model as t_build_model

from _torch_dist import one_torch_thread  # noqa: F401

j_quantize_params = jax.jit(_j_quantize_params, static_argnums=1)
ARCHS = ("qwen1.5-0.5b-smoke", "qwen3-moe-30b-a3b-smoke")
QUANTS = sorted(tpol.PRESETS) + sorted(tpol.PROGRAM_PRESETS)
RULES = (None, "layers/0/attn/kv=olive_serve,*mlp*=olive_w4a4,"
               "*experts/*/[0-3]=olive_w8a8,layers/1/attn/wo=fp")


def _program(pol, quant, rules, n_layers, rewrite):
    """The launcher's policy: a program preset or any preset with rules
    becomes a program, else the flat preset; then the CPU rewrite."""
    name = None if quant == "fp" else quant
    if quant in pol.PROGRAM_PRESETS or rules:
        policy = pol.get_program(name, n_layers=n_layers)
        if rules:
            policy = policy.with_rules(pol.parse_rules(rules))
    else:
        policy = pol.get_policy(name)
    return policy.replace_all(compute_dtype="float32", abits=0) \
        if rewrite else policy


def _fields(pol):
    return {f.name: getattr(pol, f.name)
            for f in dataclasses.fields(pol) if f.name != "backend"}


def _sites(arch):
    """Every site of the port's tree at smoke size, the KV-cache sites and
    the per-expert sub-sites."""
    cfg = t_get_config(arch)
    params = t_build_model(cfg).init(torch.Generator().manual_seed(0),
                                     device="cpu")
    sites = []
    for path, leaf in tq.tree_paths(params):
        sites.append(path)
        if leaf.ndim == 3:
            sites += [f"{path}/{e}" for e in range(leaf.shape[0])]
    return sites + [f"layers/{i}/attn/kv" for i in range(cfg.n_layers)]


@pytest.mark.parametrize("rules", RULES, ids=("presets", "rules"))
@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_site_resolves_as_reference(arch, quant, rules):
    n = t_get_config(arch).n_layers
    sites = _sites(arch)
    assert any("/experts/wg/7" in s for s in sites) == ("moe" in arch)
    for rewrite in (False, True):
        got = _program(tpol, quant, rules, n, rewrite)
        ref = _program(jpol, quant, rules, n, rewrite)
        for site in sites:
            t, j = got.resolve(site), ref.resolve(site)
            assert _fields(t) == {k: getattr(j, k) for k in _fields(t)}, \
                (site, rewrite)
            assert t.backend == "cuda" and j.backend == "xla"
        if rules or quant in tpol.PROGRAM_PRESETS:
            assert got.name == ref.name
            assert [r.pattern for r in got.rules] == \
                [r.pattern for r in ref.rules]


W4 = dict(method="olive", wbits=4, abits=0, compute_dtype="float32")
W8 = dict(method="olive", wbits=8, abits=0, w_normal_dtype="int8",
          compute_dtype="float32")


def _layout_cases(pol):
    """The reference's program cases, built in one package."""
    w4, w8 = pol.QuantPolicy(**W4), pol.QuantPolicy(**W8)
    base = pol.PolicyProgram.from_policy(w4)
    return {
        "precedence": pol.PolicyProgram(rules=[
            pol.Rule("layers/0/*", w8), pol.Rule("layers/*", w4),
            pol.Rule("layers/0/*", w4.off())], default=w4.off()),
        "with_rules": base.with_rules([("*attn/wq*", w8)]),
        "appended": base.with_rules([("*attn/wq*", w8)], front=False),
        "uniform_layers_rule": base.with_rules([("layers/*/attn/wq", w8)]),
        "probe_blind": base.with_rules([("layers/2/mlstm/w_down", w8)]),
        "first_last": base.with_rules([("layers/0/*", w8),
                                       ("layers/3/*", w8)]),
        "kv_per_layer": base.with_rules([
            ("layers/1/attn/kv", dataclasses.replace(w4, kv_bits=4))]),
        "preset_rules": pol.get_program("olive_mixed_w48", 4).with_rules(
            pol.parse_rules("layers/1/attn/kv=olive_serve,*mlp*=fp")),
        "backend_rule": base.with_rules([
            ("*attn*", dataclasses.replace(w4, backend="eager"))]),
        "off": pol.get_program("olive_mixed_w48", 4).replace_all(
            method="none"),
        "mixed_w48": pol.get_program("olive_mixed_w48", 6),
        "owq": pol.get_program("olive_owq_style", 4),
        "serve": pol.get_program("olive_serve"),
        "fp": pol.get_program(None),
    }


@pytest.mark.parametrize("case", sorted(_layout_cases(tpol)))
def test_program_protocol_matches_reference(case):
    got, ref = _layout_cases(tpol)[case], _layout_cases(jpol)[case]
    assert (got.kv_bits, got.enabled, got.compute_dtype) == \
        (ref.kv_bits, ref.enabled, ref.compute_dtype)
    rename = {"xla": "cuda"}
    assert got.backends() == {rename.get(b, b) for b in ref.backends()}
    assert got.backend == rename.get(ref.backend, ref.backend)
    for n in (1, 4, 6):
        assert got.varies_across_layers(n) == ref.varies_across_layers(n)
        assert got.addresses_layers(n) == ref.addresses_layers(n)
    for site in ("layers/0/attn/wq", "LAYERS/0/mlp/wg", "layers/2/attn/wq",
                 "layers/3/attn/wk", "layers/1/attn/kv", "embed/table",
                 "layers/5/mlp/wd", "layers/2/mlstm/w_down"):
        t, j = got.resolve(site), ref.resolve(site)
        assert _fields(t) == {k: getattr(j, k) for k in _fields(t)}, site


def test_reference_program_cases():
    """The reference's own assertions, on the port."""
    c = _layout_cases(tpol)
    prec = c["precedence"]
    assert prec.resolve("layers/0/attn/wq").wbits == 8
    assert prec.resolve("layers/2/attn/wq").wbits == 4
    assert not prec.resolve("embed/table").enabled
    assert prec.resolve("LAYERS/0/mlp/wg").wbits == 8
    assert c["with_rules"].resolve("layers/1/attn/wq").wbits == 8
    assert c["with_rules"].resolve("layers/1/attn/wk").wbits == 4
    assert c["appended"].resolve("layers/1/attn/wq").wbits == 4
    assert c["uniform_layers_rule"].resolve("layers/3/attn/wq").wbits == 8
    assert c["first_last"].resolve("layers/3/mlp/wd").wbits == 8
    assert c["first_last"].resolve("layers/2/mlp/wd").wbits == 4
    kv = c["kv_per_layer"]
    assert kv.kv_bits == 4 and kv.resolve("layers/1/attn/kv").kv_bits == 4
    assert kv.resolve("layers/0/attn/kv").kv_bits == 0
    pr = c["preset_rules"]
    assert pr.resolve("layers/1/attn/kv").kv_bits == 4
    assert not pr.resolve("layers/0/mlp/wg").enabled
    assert pr.resolve("layers/0/attn/wq").wbits == 8
    rules = tpol.parse_rules("layers/0/*=olive_w8a8, *mlp*=fp")
    assert rules[0].pattern == "layers/0/*" and rules[0].policy.wbits == 8
    assert not rules[1].policy.enabled
    with pytest.raises(ValueError):
        tpol.parse_rules("no-equals-sign")
    (int8,) = tpol.parse_rules("layers/0/*=int8")  # a baseline preset
    assert (int8.policy.method, int8.policy.wbits) == ("int", 8)
    assert int8.pattern == "layers/0/*" and int8.policy == tpol.INT8
    with pytest.raises(KeyError):
        tpol.parse_rules("layers/0/*=int3")     # in no preset
    prog = c["mixed_w48"]
    assert prog.resolve("layers/0/attn/wq").wbits == 8
    assert prog.resolve("layers/5/attn/wq").wbits == 8
    assert prog.resolve("layers/3/attn/wq").wbits == 4
    assert not prog.resolve("embed/table").enabled


def _carried(arch):
    """The reference's raw smoke tree unrolled to `layers/<i>`, and the
    same arrays in the port."""
    jcfg = j_get_config(arch)
    params = j_build_model(jcfg, jpol.QuantPolicy(compute_dtype="float32"),
                           remat=False).init(jax.random.PRNGKey(0))
    params = unroll_params(jcfg, params)
    return params, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _same_qt(t, j):
    assert t.normal_dtype == j.normal_dtype
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale),
                               rtol=1e-6)


def test_mixed_w48_tree_matches_reference():
    jparams, tparams = _carried("qwen1.5-0.5b-smoke")
    n = t_get_config("qwen1.5-0.5b-smoke").n_layers
    jq = j_quantize_params(jparams, _program(jpol, "olive_mixed_w48", None,
                                             n, True))
    tq_ = tq.quantize_params(tparams, _program(tpol, "olive_mixed_w48",
                                               None, n, True))
    ref = {p: leaf for p, leaf in j_tree_paths(jq)
           if hasattr(leaf, "normal_dtype")}
    got = {p: leaf for p, leaf in tq.tree_paths(tq_)
           if isinstance(leaf, QuantizedTensor)}
    assert sorted(got) == sorted(ref)
    assert {ref[p].normal_dtype for p in ref} == {"int8"}  # 2 layers: W8
    for path in ref:
        _same_qt(got[path], ref[path])


def test_owq_style_tree_matches_reference():
    jparams, tparams = _carried("qwen1.5-0.5b-smoke")
    jq = j_quantize_params(jparams, _program(jpol, "olive_owq_style", None,
                                             2, True))
    tq_ = tq.quantize_params(tparams, _program(tpol, "olive_owq_style",
                                               None, 2, True))
    ref = dict(j_tree_paths(jq))
    got = dict(tq.tree_paths(tq_))
    dtypes = {}
    for path, leaf in ref.items():
        if hasattr(leaf, "normal_dtype"):
            _same_qt(got[path], leaf)
            dtypes[path.split("/")[-1]] = leaf.normal_dtype
    assert dtypes == {"wq": "int8", "wk": "int8", "wv": "int4",
                      "wo": "int4", "wg": "int4", "wu": "int4", "wd": "int4"}


def test_per_expert_rule_groups_match_reference():
    rules = "*experts/*/[0-3]=olive_w8a8,*experts/wd/7=fp"
    jparams, tparams = _carried("qwen3-moe-30b-a3b-smoke")
    jq = j_quantize_params(jparams, _program(jpol, "olive_serve", rules, 2,
                                             True))
    tq_ = tq.quantize_params(tparams, _program(tpol, "olive_serve", rules,
                                               2, True))
    n_mixed = 0
    for i, layer in enumerate(jq["layers"]):
        for leaf in ("wg", "wu", "wd"):
            jm = layer["moe"]["experts"][leaf]
            tm = tq_["layers"][i]["moe"]["experts"][leaf]
            assert isinstance(jm, JMixed) and isinstance(tm, MixedExpertQuant)
            assert tm.expert_ids == jm.expert_ids
            assert tm.n_experts == jm.n_experts
            for tg, jg in zip(tm.groups, jm.groups):
                if isinstance(jg, jax.Array):       # the expert left fp
                    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
                else:
                    _same_qt(tg, jg)
            n_mixed += 1
    assert n_mixed == 6
    wd = tq_["layers"][0]["moe"]["experts"]["wd"]
    assert wd.expert_ids == ((0, 1, 2, 3), (4, 5, 6), (7,))
    assert [g.normal_dtype if isinstance(g, QuantizedTensor) else "fp"
            for g in wd.groups] == ["int8", "int4", "fp"]
