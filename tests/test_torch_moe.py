"""The port's MoE layer and stacked-expert PTQ against the JAX reference,
on inputs made with numpy from a seed:

- `moe_layer` at smoke size (qwen3-moe-30b-a3b-smoke: 8 experts top-2,
  renormalised; grok-1-314b-smoke: 8 experts top-2, not renormalised),
  fp32 and W4 weights (the reference's PTQ carried across): routed
  expert indices equal, output within 1e-5 of max|ref| (fp32 summation
  order of the router and the expert einsums), Switch aux loss within
  1e-6 relative; also with tied router probabilities (zero rows), where
  the lower expert must win as in `jax.lax.top_k`;
- a capacity factor that drops tokens: the same tokens lose an expert
  on both sides;
- a per-expert mixed W4/W8 program (the reference's
  `tests/test_grouped_kernel.py::test_mixed_in_moe_layer`): the same
  expert groups, equal codes, and the layer's output within 1e-5;
- stacked PTQ (`quantize_weight` on an (E, K, N) stack, in chunks of
  experts): codes equal to the reference's vmapped quantize, scales
  within 1e-6 relative (XLA's std sums in another order, ROADMAP queue 3);
- layer-streamed init + PTQ (`Model.init(..., quantize=...)`) equal to
  init-then-`quantize_params`, leaf for leaf;
- the fill `moe_layer` passes to the expert einsums (min(counts, cap),
  with the slots past it zero), and that no consumer reads a row past
  it: with K6's plain version writing NaN there, the output is
  unchanged, finite, and within 1e-5 of the reference.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import policy as jpol
from repro.core.ovp import MixedExpertQuant as JMixed
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.core.qlinear import quantize_weight as j_quantize_weight
from repro.models import layers as jlayers
from repro_torch import backends as tbackends
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.core import qlinear as tq
from repro_torch.core.ovp import MixedExpertQuant, QuantizedTensor
from repro_torch.kernels import ovp_matmul as tmm
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model as t_build_model

from _torch_dist import one_torch_thread  # noqa: F401

F32 = dict(compute_dtype="float32")


def _to_port(tree):
    """A reference (sub)tree, raw or quantized, on the CPU in the port."""
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    return params_from_numpy({"sub": np_tree}, device="cpu")["sub"]


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _moe(arch, seed=0):
    jcfg = j_get_config(arch)
    p = jlayers.moe_params(jax.random.PRNGKey(seed), jcfg.d_model,
                           jcfg.d_ff, jcfg.n_experts)
    return jcfg, t_get_config(arch), p


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _ref_topi(p, x, cfg):
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"]["w_gate"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b-smoke",
                                  "grok-1-314b-smoke"])
@pytest.mark.parametrize("quant", ["fp32", "w4"])
def test_moe_layer_matches_reference(arch, quant):
    jcfg, tcfg, p = _moe(arch)
    x = _x((2, 16, jcfg.d_model), seed=1)
    if quant == "fp32":
        jp, tp = jpol.QuantPolicy(**F32), tpol.QuantPolicy(**F32)
    else:
        jp = dataclasses.replace(jpol.OLIVE_W4, backend="pallas_interpret",
                                 **F32)
        tp = dataclasses.replace(tpol.OLIVE_W4, **F32)
        p = j_quantize_params(p, dataclasses.replace(jp, backend="xla"))
        assert p["experts"]["wg"].data.ndim == 3
    ref, ref_aux = jlayers.moe_layer(p, jnp.asarray(x), jcfg, jp)
    tp_params = _to_port(p)
    _, _, topi = tlayers.route(tp_params, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(topi.numpy(), _ref_topi(p, x, jcfg))
    got, aux = tlayers.moe_layer(tp_params, torch.from_numpy(x), tcfg, tp)
    assert got.shape == x.shape
    assert _rel(got.numpy(), ref) <= 1e-5
    assert abs(float(aux) - float(ref_aux)) <= 1e-6 * abs(float(ref_aux))


def test_router_ties_pick_the_lower_expert():
    """A row of zeros gives every expert the same probability; the
    reference's `jax.lax.top_k` then picks experts 0..k-1 in order, and
    so must the port (torch.topk picks others). Output and aux within
    the tolerances above."""
    jcfg, tcfg, p = _moe("qwen3-moe-30b-a3b-smoke", seed=2)
    x = _x((2, 16, jcfg.d_model), seed=3)
    x[0, :4] = 0.0
    x[1, 7] = 0.0
    jp, tp = jpol.QuantPolicy(**F32), tpol.QuantPolicy(**F32)
    tparams = _to_port(p)
    _, _, topi = tlayers.route(tparams, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(topi.numpy(), _ref_topi(p, x, jcfg))
    assert topi[0, 0].tolist() == list(range(tcfg.top_k))
    ref, ref_aux = jlayers.moe_layer(p, jnp.asarray(x), jcfg, jp)
    got, aux = tlayers.moe_layer(tparams, torch.from_numpy(x), tcfg, tp)
    assert _rel(got.numpy(), ref) <= 1e-5
    assert abs(float(aux) - float(ref_aux)) <= 1e-6 * abs(float(ref_aux))


def _dropped(y_small, y_full):
    """(row, token) pairs whose output lost an expert to the capacity."""
    diff = np.abs(np.asarray(y_small) - np.asarray(y_full)).max(axis=-1)
    return {tuple(i) for i in np.argwhere(
        diff > 1e-4 * np.abs(np.asarray(y_full)).max())}


def test_capacity_drops_the_same_tokens():
    """cf 0.5 with T 32, top-2 of 8 experts: cap = max(int(0.5·32·2/8),
    4) = 4 slots per expert for about 8 assignments each, so tokens drop
    (by their stable rank inside each expert); a cf of 100 drops none."""
    jcfg, tcfg, p = _moe("qwen3-moe-30b-a3b-smoke", seed=4)
    x = _x((2, 32, jcfg.d_model), seed=5)
    jp, tp = jpol.QuantPolicy(**F32), tpol.QuantPolicy(**F32)
    tparams = _to_port(p)
    outs = {}
    for cf in (0.5, 100.0):
        ref, _ = jlayers.moe_layer(p, jnp.asarray(x), jcfg, jp,
                                   capacity_factor=cf)
        got, _ = tlayers.moe_layer(tparams, torch.from_numpy(x), tcfg, tp,
                                   capacity_factor=cf)
        assert _rel(got.numpy(), ref) <= 1e-5
        outs[cf] = (np.asarray(ref), got.numpy())
    ref_drop = _dropped(outs[0.5][0], outs[100.0][0])
    got_drop = _dropped(outs[0.5][1], outs[100.0][1])
    assert ref_drop and got_drop == ref_drop


def _mixed_program(pol, backend):
    base = dataclasses.replace(pol.OLIVE_W4A4, abits=0, backend=backend,
                               **F32)
    w8 = dataclasses.replace(pol.OLIVE_W8A8, abits=0, backend=backend,
                             **F32)
    return pol.PolicyProgram(rules=(pol.Rule("experts/*/0", w8),),
                             default=base)


def test_mixed_w4_w8_experts_in_moe_layer():
    class Cfg:
        n_experts, top_k, norm_topk, capacity_factor = 4, 2, False, 1.5

    p = jlayers.moe_params(jax.random.PRNGKey(9), 64, 128, 4)
    x = _x((2, 16, 64), seed=9)
    jprog = _mixed_program(jpol, "pallas_interpret")
    tprog = _mixed_program(tpol, "cuda")
    qp = j_quantize_params(p, jprog)
    assert isinstance(qp["experts"]["wg"], JMixed)
    mine = tq.quantize_params(_to_port(p), tprog)
    for leaf in ("wg", "wu", "wd"):
        jm, tm = qp["experts"][leaf], mine["experts"][leaf]
        assert isinstance(tm, MixedExpertQuant)
        assert tm.expert_ids == jm.expert_ids == ((0,), (1, 2, 3))
        for jg, tg in zip(jm.groups, tm.groups):
            assert tg.normal_dtype == jg.normal_dtype
            np.testing.assert_array_equal(tg.data.numpy(),
                                          np.asarray(jg.data))
            np.testing.assert_allclose(tg.scale.numpy(), np.asarray(jg.scale),
                                       rtol=1e-6)
    ref, _ = jlayers.moe_layer(qp, jnp.asarray(x), Cfg, jprog)
    got, _ = tlayers.moe_layer(_to_port(qp), torch.from_numpy(x), Cfg,
                               tprog)
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("kind,granularity", [("int4", "channel"),
                                              ("flint4", "channel"),
                                              ("int8", "channel"),
                                              ("int4", "tensor")])
def test_stacked_ptq_matches_vmapped_reference(kind, granularity,
                                               monkeypatch):
    """Chunks of 2 experts (STACK_CHUNK = 2·K·N) over a stack of 5, so
    the chunked path and its ragged last chunk run."""
    wbits = 8 if kind == "int8" else 4
    kw = dict(method="olive", wbits=wbits, w_normal_dtype=kind,
              w_granularity=granularity, **F32)
    w = (np.random.default_rng(11).standard_t(3, size=(5, 64, 48)) * 0.05) \
        .astype(np.float32)
    monkeypatch.setattr(tq, "STACK_CHUNK", 2 * 64 * 48)
    ref = j_quantize_weight(jnp.asarray(w), jpol.QuantPolicy(**kw))
    got = tq.quantize_weight(torch.from_numpy(w), tpol.QuantPolicy(**kw))
    assert isinstance(got, QuantizedTensor)
    assert (got.normal_dtype, got.pair_axis, got.orig_dim) == \
        (ref.normal_dtype, ref.pair_axis, ref.orig_dim)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    assert got.scale.shape == tuple(np.shape(ref.scale))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(ref.scale),
                               rtol=1e-6)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    elif isinstance(tree, QuantizedTensor):
        yield f"{prefix}/data", tree.data
        yield f"{prefix}/scale", tree.scale
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b-smoke",
                                  "qwen1.5-0.5b-smoke"])
def test_layer_streamed_init_equals_init_then_quantize(arch):
    cfg = t_get_config(arch)
    policy = tpol.OLIVE_SERVE.replace_all(abits=0, **F32)
    model = t_build_model(cfg, policy)
    whole = tq.quantize_params(
        model.init(torch.Generator().manual_seed(3), device="cpu"), policy)
    streamed = model.init(
        torch.Generator().manual_seed(3), device="cpu",
        quantize=lambda tree, prefix: tq.quantize_params(
            tree, policy, prefix=prefix))
    a, b = dict(_leaves(whole)), dict(_leaves(streamed))
    assert a.keys() == b.keys()
    assert any("experts/wg/data" in k for k in a) == (cfg.family == "moe")
    for key in a:
        assert torch.equal(a[key], b[key]), key


def _w4_moe(seed):
    """Smoke Qwen3 MoE params quantized W4 by the reference, on both
    sides, with the reference's xla policy and the port's cuda one."""
    jcfg, tcfg, p = _moe("qwen3-moe-30b-a3b-smoke", seed=seed)
    jp = dataclasses.replace(jpol.OLIVE_W4, backend="xla", **F32)
    tp = dataclasses.replace(tpol.OLIVE_W4, **F32)
    p = j_quantize_params(p, jp)
    return jcfg, tcfg, p, jp, tp


@pytest.mark.parametrize("t,cf", [(16, 1.25), (32, 0.5)])
def test_moe_fill_is_min_counts_cap_and_slots_past_it_are_zero(
        monkeypatch, t, cf):
    """The fill `moe_layer` hands each expert einsum is min(counts, cap)
    of the routing (cf 0.5 at T 32 clamps: cap 4 for about 8 picks an
    expert); the dispatched slots past it are zero and those below it
    are the tokens."""
    _, tcfg, p, _, tp = _w4_moe(seed=6)
    x = _x((2, t, tcfg.d_model), seed=7)
    tparams = _to_port(p)
    seen = []
    real = tbackends.dispatch

    def spy(xg, w, policy, act_scale=None, fill=None):
        seen.append((xg.clone(), None if fill is None else fill.clone()))
        return real(xg, w, policy, act_scale=act_scale, fill=fill)

    monkeypatch.setattr(tbackends, "dispatch", spy)
    tlayers.moe_layer(tparams, torch.from_numpy(x), tcfg, tp,
                      capacity_factor=cf)
    e, k = tcfg.n_experts, tcfg.top_k
    cap = max(int(cf * t * k / e), 4)
    _, _, topi = tlayers.route(tparams, torch.from_numpy(x), tcfg)
    counts = torch.nn.functional.one_hot(topi, e).sum(dim=(1, 2))
    want = torch.clamp(counts, max=cap)
    assert len(seen) == 3 and (want > 0).any()
    if cf == 0.5:
        assert (counts > cap).any()
    for _, fill in seen:
        assert fill is not None and torch.equal(fill.long(), want)
    xg = seen[0][0]                                     # the wg lhs
    live = torch.arange(cap) < want[..., None]          # (B, E, cap)
    assert xg.shape[1:3] == (e, cap)
    assert torch.equal(xg[~live], torch.zeros_like(xg[~live]))
    assert bool((xg[live].abs().sum(dim=-1) > 0).all())


def test_rows_past_the_fill_are_never_read(monkeypatch):
    """With K6's plain version writing NaN past the fill (the kernel
    leaves those rows unwritten), `moe_layer`'s output is unchanged and
    finite and still matches the reference within 1e-5 of max|ref|: no
    consumer reads a row past the fill."""
    jcfg, tcfg, p, jp, tp = _w4_moe(seed=8)
    x = _x((2, 16, jcfg.d_model), seed=9)
    tparams = _to_port(p)
    clean, _ = tlayers.moe_layer(tparams, torch.from_numpy(x), tcfg, tp)
    real = tmm.grouped_ovp_matmul_plain
    poisoned = []

    def nan_past_fill(*args, fill=None, **kw):
        out = real(*args, fill=fill, **kw)
        assert fill is not None
        live = torch.arange(out.shape[2]) < fill[..., None]
        poisoned.append(int((~live).sum()))
        return torch.where(live[..., None], out, float("nan"))

    monkeypatch.setattr(tmm, "grouped_ovp_matmul_plain", nan_past_fill)
    got, _ = tlayers.moe_layer(tparams, torch.from_numpy(x), tcfg, tp)
    assert len(poisoned) == 3 and min(poisoned) > 0
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, clean)
    ref, _ = jlayers.moe_layer(p, jnp.asarray(x), jcfg, jp)
    assert _rel(got.numpy(), ref) <= 1e-5
