"""The port's quantization baselines (`repro_torch.core.baselines`) and the
`int8`, `int4` and `ant4` presets against the reference's
(`repro.core.baselines`, `repro.core.policy`).

- Every baseline on the same seeded numpy inputs (unit normals with 1 %
  of the values scaled by 6, so the searches and the outlier paths have
  something to do). Exact (bit for bit) where the operation order
  matches: the uniform int searches, flint4, ANT, GOBO, AdaptivFloat at
  4 bits and the victim pruning. Two differ by design, at a stated
  tolerance: `clip_outliers` clips at mu ± 3σ, whose std XLA sums in
  another order (atol 1e-6 on values of about 1), and `adaptivfloat`'s
  E4M3 steps, where XLA's `exp2` of an integer exponent is an ulp off
  and torch's is exact (rtol 1e-6). The inputs have no ties in the
  reference's own answer (the searches' MSEs are distinct).
- The two 40-point grids and GOBO's 16 quantiles bit for bit against
  `jnp.geomspace` / `jnp.linspace`.
- `prune_random` by its rate (within 4 binomial sigmas of `frac`) and
  its zeros (every pruned value exactly 0, every other one unchanged).
- Smoke-model logits of `qwen1.5-0.5b-smoke` under the three presets,
  prefill + 3 decode steps on the reference's weights: the launcher's
  rewrite (fp32 compute, `abits=0`), and `int4` with its 4-bit
  activations kept (the dynamic max-scaled activation fake-quant). Each
  in both of the reference's layouts: scanned (the launcher's flat
  preset: one scale over the stack of a linear's layers, which the
  port's PTQ of a whole tree reproduces, `qlinear.stacks_layers`) and
  unrolled (a program with a `layers/` rule: each layer alone). Both
  sides quantize the carried raw weights (equal bit for bit; the
  reference's PTQ runs op by op, as its launcher runs it: under one
  `jax.jit` XLA rewrites the scale's division and moves it by an ulp),
  and the logits agree to atol 1e-4, the model tests' tolerance (the
  shared loop of `_torch_parity.py`). The scanned layout's shared grid
  is shown apart, against each layer quantized alone.
- The launcher serving `--quant int4` on the CPU, slab and paged, its
  weights those of the scanned layout's PTQ.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import baselines as jb
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as _j_quantize_params
from repro.models.model import build_model as j_build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import baselines as tb
from repro_torch.core import policy as tpol
from repro_torch.core import qlinear as tq
from repro_torch.core.ovp import QuantizedTensor
from repro_torch.launch import serve
from repro_torch.models.model import build_model as t_build_model

from _torch_parity import jax_greedy, port_forced
from _torch_dist import one_torch_thread  # noqa: F401

ARCH = "qwen1.5-0.5b-smoke"
B, T, MAX_LEN, STEPS = 2, 8, 32, 3


def _inputs(seed, shape=(64, 96)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < 0.01] *= 6.0
    return x


def _both(fn_j, fn_t, x, *args):
    return (np.asarray(fn_j(jnp.asarray(x), *args)),
            fn_t(torch.from_numpy(x), *args).numpy())


EXACT = [("uniform_int_fake_quant", (4,)), ("uniform_int_fake_quant", (8,)),
         ("uniform_int_fake_quant", (4, "max")),
         ("uniform_int_fake_quant", (8, "max")),
         ("uniform_int_dynamic_act", (4,)), ("uniform_int_dynamic_act", (8,)),
         ("flint4_fake_quant", ()), ("ant_fake_quant", ()),
         ("adaptivfloat_fake_quant", ()), ("prune_victims", ()),
         ("prune_victims", (2.5, 0))]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name,args", EXACT,
                         ids=[f"{n}{a}" for n, a in EXACT])
def test_baseline_matches_reference_bit_for_bit(name, args, seed):
    ref, got = _both(getattr(jb, name), getattr(tb, name), _inputs(seed),
                     *args)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gobo_matches_reference(seed):
    x = _inputs(seed)
    ref, ref_stats = jb.gobo_fake_quant(jnp.asarray(x))
    got, got_stats = tb.gobo_fake_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got_stats["bytes"] == ref_stats["bytes"]
    assert got_stats["outlier_frac"] == pytest.approx(
        ref_stats["outlier_frac"], rel=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clip_and_adaptivfloat_e4m3_within_stated_tolerance(seed):
    x = _inputs(seed)
    ref, got = _both(jb.clip_outliers, tb.clip_outliers, x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    ref, got = _both(jb.adaptivfloat_fake_quant, tb.adaptivfloat_fake_quant,
                     x, 8, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_search_grids_are_the_references_bit_for_bit():
    for hexes, (lo, hi) in ((tb._INT_GRID, (0.05, 1.0)),
                            (tb._FLINT4_GRID, (0.08, 1.1))):
        got = tb._hex_tensor(hexes, "cpu").numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jnp.geomspace(lo, hi, 40)))
        # numpy's float32 grid is not the reference's: the constants
        # are needed
        assert not np.array_equal(
            got, np.geomspace(lo, hi, 40).astype(np.float32))
    np.testing.assert_array_equal(
        tb._hex_tensor(tb._GOBO_QS4, "cpu").numpy(),
        np.asarray(jnp.linspace(0.5 / 16, 1 - 0.5 / 16, 16)))


def test_search_picks_the_first_of_equal_candidates():
    """A tensor of zeros has the same MSE (0) at every candidate; the
    search keeps the first, as `jnp.argmin` does."""
    x = np.zeros((8, 8), np.float32)
    for name in ("uniform_int_fake_quant", "flint4_fake_quant"):
        args = (4,) if name.startswith("uniform") else ()
        ref, got = _both(getattr(jb, name), getattr(tb, name), x, *args)
        np.testing.assert_array_equal(got, ref)
    cands = torch.tensor([3.0, 1.0, 2.0, 1.0])
    assert tb._argmin_of(cands, lambda c: (c - 1.0) ** 2) == 1.0
    hits = []
    tb._argmin_of(cands, lambda c: hits.append(float(c)) or c * 0)
    assert hits == [3.0, 1.0, 2.0, 1.0]


@pytest.mark.parametrize("frac", [0.1, 0.5])
def test_prune_random_rate_and_zeros(frac):
    x = torch.from_numpy(np.abs(_inputs(3, (256, 256))) + 0.5)
    gen = torch.Generator().manual_seed(0)
    y = tb.prune_random(x, frac, gen)
    pruned = y == 0
    n = x.numel()
    rate = float(pruned.sum()) / n
    assert abs(rate - frac) <= 4 * (frac * (1 - frac) / n) ** 0.5
    assert torch.equal(y[~pruned], x[~pruned])
    # the same generator state gives the same mask
    again = tb.prune_random(x, frac, torch.Generator().manual_seed(0))
    assert torch.equal(again, y)


# --------------------------------------------------------------------------
# The presets on the smoke model
# --------------------------------------------------------------------------
LAYOUTS = ("scanned", "unrolled")


def _rewrite(policy, keep_abits):
    kw = dict(compute_dtype="float32")
    if not keep_abits:
        kw["abits"] = 0
    return policy.replace_all(**kw)


def _policy(pol_mod, quant, keep_abits, layout):
    """The preset as the launcher's `--quant` gives it (a flat policy:
    the reference keeps its layer stack scanned), or as a program with a
    rule on the layers' KV sites that resolves as the preset does (the
    reference unrolls its layers)."""
    pol = pol_mod.get_policy(quant)
    if layout == "unrolled":
        pol = pol_mod.get_program(quant).with_rules(
            [("layers/*/attn/kv", pol)])
    return _rewrite(pol, keep_abits)


@functools.lru_cache(maxsize=None)
def _reference_raw(layout):
    """The reference's smoke weights, drawn in `layout`."""
    jcfg = j_get_config(ARCH)
    model = j_build_model(jcfg, _policy(jpol, "int4", True, layout),
                          remat=False)
    assert model.unrolled == (layout == "unrolled")
    return jcfg, model.init(jax.random.PRNGKey(0), dtype=jnp.float32)


def _to_port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


LINEARS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("quant,keep_abits", [("int8", False),
                                              ("int4", False),
                                              ("ant4", False),
                                              ("int4", True)])
def test_smoke_logits_match_reference(quant, keep_abits, layout):
    jcfg, raw = _reference_raw(layout)
    jp = _policy(jpol, quant, keep_abits, layout)
    tp = _policy(tpol, quant, keep_abits, layout)
    assert tq.stacks_layers(tp, jcfg.n_layers) == (layout == "scanned")
    jq = _j_quantize_params(raw, jp)        # op by op, as its launcher
    tq_ = tq.quantize_params(_to_port(raw), tp)
    # the fake-quantized weights: every linear changed, bit for bit equal
    # to the reference's (scanned: one scale over the stack of layers)
    got, ref = dict(tq.tree_paths(tq_)), dict(tq.tree_paths(_to_port(jq)))
    assert sorted(got) == sorted(ref)
    n_quant = 0
    for path, leaf in ref.items():
        np.testing.assert_array_equal(got[path].numpy(), leaf.numpy(),
                                      err_msg=path)
        n_quant += path.startswith("layers/") and \
            path.split("/")[-1] in LINEARS
    assert n_quant == 7 * jcfg.n_layers
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab, size=(B, T)).astype(np.int32)
    want, fed = jax_greedy(j_build_model(jcfg, jp, remat=False), jq, toks,
                           MAX_LEN, STEPS)
    out = port_forced(t_build_model(t_get_config(ARCH), tp), tq_, toks, fed,
                      MAX_LEN)
    assert out.shape == want.shape == (B, STEPS + 1, jcfg.padded_vocab)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-4)


def test_scanned_layout_shares_one_scale_across_layers():
    """Under a flat int4 preset each linear's layers share one grid (the
    stack's), which quantizing each layer alone does not give: the
    layouts differ, as the reference's do."""
    _, raw = _reference_raw("scanned")
    params = _to_port(raw)
    pol = _policy(tpol, "int4", False, "scanned")
    stacked = tq.quantize_params(params, pol)
    alone = [tq.quantize_params(layer, pol, prefix=f"layers/{i}")
             for i, layer in enumerate(params["layers"])]
    for leaf in ("wq", "wo"):
        grids = [torch.unique(layer["attn"][leaf].abs())
                 for layer in stacked["layers"]]
        step = min(float(g[g > 0].min()) for g in grids)
        for g in grids:     # every value a multiple of one step
            np.testing.assert_allclose(
                (g / step).numpy(), np.round((g / step).numpy()),
                rtol=0, atol=1e-4)
        assert any(not torch.equal(a["attn"][leaf], b["attn"][leaf])
                   for a, b in zip(alone, stacked["layers"]))


LAYOUT_CASES = [("int4", None), ("olive_serve", None),
                ("olive_serve", "*mlp*=int8"), ("int4", "layers/0/*=int8"),
                ("olive_mixed_w48", None)]


def _launcher_policy(pol_mod, quant, rules, n_layers):
    if quant in pol_mod.PROGRAM_PRESETS or rules:
        prog = pol_mod.get_program(quant, n_layers=n_layers)
        return prog.with_rules(pol_mod.parse_rules(rules)) if rules \
            else prog
    return pol_mod.get_policy(quant)


@pytest.mark.parametrize("quant,rules", LAYOUT_CASES)
def test_stacks_layers_follows_the_reference_layout(quant, rules):
    """PTQ stacks a baseline's layers exactly when the reference keeps
    the launcher's policy scanned and the policy holds a baseline."""
    jcfg = j_get_config(ARCH)
    n = jcfg.n_layers
    jp = _launcher_policy(jpol, quant, rules, n)
    scanned = not j_build_model(jcfg, jp, remat=False).unrolled
    baseline = quant == "int4" or "int8" in (rules or "")
    assert tq.stacks_layers(_launcher_policy(tpol, quant, rules, n), n) \
        == (scanned and baseline)


def test_program_stacks_only_its_baseline_sites():
    """`olive_serve` with `*mlp*=int8` rules keeps the reference scanned:
    the MLP linears fake-quantize over their stack of layers, the
    attention linears quantize OVP one layer at a time. The port's tree
    equals the reference's."""
    jcfg, raw = _reference_raw("scanned")
    pols = [_rewrite(_launcher_policy(mod, "olive_serve", "*mlp*=int8",
                                      jcfg.n_layers), False)
            for mod in (jpol, tpol)]
    ref = dict(tq.tree_paths(_to_port(_j_quantize_params(raw, pols[0]))))
    got = dict(tq.tree_paths(tq.quantize_params(_to_port(raw), pols[1])))
    assert sorted(got) == sorted(ref)
    n_ovp = 0
    for path, leaf in ref.items():
        if isinstance(leaf, QuantizedTensor):
            n_ovp += 1
            assert got[path].normal_dtype == leaf.normal_dtype
            np.testing.assert_array_equal(got[path].data.numpy(),
                                          leaf.data.numpy(), err_msg=path)
            np.testing.assert_allclose(got[path].scale.numpy(),
                                       leaf.scale.numpy(), rtol=1e-6)
        else:
            np.testing.assert_array_equal(got[path].numpy(), leaf.numpy(),
                                          err_msg=path)
    assert n_ovp == 4 * jcfg.n_layers
    before = dict(tq.tree_paths(_to_port(raw)))
    for leaf in ("wg", "wu", "wd"):
        assert len(torch.unique(got[f"layers/0/mlp/{leaf}"])) <= 256 < \
            len(torch.unique(before[f"layers/0/mlp/{leaf}"]))


def test_quantize_weight_fake_quantizes_in_place_of_codes():
    w = torch.from_numpy(_inputs(4, (128, 64)))
    for quant in ("int8", "int4", "ant4"):
        pol = tpol.get_policy(quant)
        q = tq.quantize_weight(w, pol)
        assert isinstance(q, torch.Tensor) and q.shape == w.shape
        assert q.dtype == torch.float32 and not torch.equal(q, w)
        assert len(torch.unique(q)) <= (256 if pol.wbits == 8 else 16)
    x = torch.from_numpy(_inputs(5, (3, 128)))
    pol = dataclasses.replace(tpol.INT4, compute_dtype="float32")
    np.testing.assert_array_equal(
        tq.qmatmul(x, w, pol).numpy(),
        torch.matmul(tb.uniform_int_dynamic_act(x, 4), w).numpy())
    np.testing.assert_array_equal(
        tq.qmatmul(x, w, dataclasses.replace(pol, abits=0)).numpy(),
        torch.matmul(x, w).numpy())


@pytest.mark.parametrize("extra", [[], ["--paged", "16", "--prefill-chunk",
                                        "16"]], ids=["slab", "paged"])
def test_launcher_serves_int4_on_cpu(extra):
    res = serve.run(["--arch", ARCH, "--quant", "int4", "--requests", "3",
                     "--max-new", "4", "--slots", "2", "--max-len", "64"]
                    + extra, device="cpu")
    assert res["tokens"] == 12 and len(res["completed"]) == 3
    pol = res["policy"]
    assert (pol.method, pol.wbits, pol.abits, pol.kv_bits) == \
        ("int", 4, 0, 0)
    layer = res["params"]["layers"][0]
    for leaf in ("wq", "wk", "wv", "wo"):
        w = layer["attn"][leaf]
        assert isinstance(w, torch.Tensor) and len(torch.unique(w)) <= 16
    # the launcher's PTQ is the scanned layout's, on the whole tree
    fresh = res["model"].init(torch.Generator().manual_seed(0),
                              device="cpu")
    want = tq.quantize_params(fresh, pol)
    for got_layer, want_layer in zip(res["params"]["layers"],
                                     want["layers"]):
        for leaf in LINEARS[:4]:
            assert torch.equal(got_layer["attn"][leaf],
                               want_layer["attn"][leaf])
    # the head stays unquantized, the caches fp32
    assert len(torch.unique(res["params"]["lm_head"]["w_out"])) > 16
    kv = res["engine"].caches["layers"][0]["kv"]
    assert "k" in kv and kv["k"].dtype == torch.float32
