"""The port's encoder-decoder (SeamlessM4T-large-v2's smoke config: 2
encoder and 2 decoder layers, d 64, 4 heads of 16, GELU MLPs) against
the JAX package, with the reference's random init (`PRNGKey(0)`) and PTQ
carried across (`convert.params_from_numpy` unstacks the vmapped
`enc_blocks`).

- `Model.forward` under `olive_serve` (W4 + KV4 on the self caches, the
  cross caches fp; fp32 compute) and unquantized: the reference's `xla`
  backend against the port's `eager`, a prefill of 10 random 32-d
  frames and a 6-token prompt into cross caches of 16 slots (the tail
  past src_len 10 unwritten), then 6 decode steps fed the reference's
  greedy tokens (`_torch_parity`); atol 1e-4, the model tests'
  tolerance.
- The encoder's sites: the port's PTQ of the carried-over fp32 tree
  quantizes the same leaves as the reference's, with the same codes and
  scales; each encoder layer resolves its policy at the one address
  `enc_blocks/<leaf>` (a program rule on `enc_blocks/mlp/*` makes every
  encoder layer's MLP W8 in both packages), gates `min_size` on the
  stack's size, as the reference does on its (n_enc_layers, K, N) leaf;
  the forward's calibration tape records no encoder site, as the
  reference's, which scans its encoder (`jax.lax.scan` traces its body),
  while its frontend projection, run before the scan, is taped.
- The launcher refuses the arch with a ValueError before any weight is
  drawn (the reference engine fails at its first prefill with a
  KeyError on `frames`), also for a baseline preset; the engine refuses
  an encoder-decoder too.
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
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.core.qlinear import tree_paths as j_tree_paths
from repro.models.model import build_model as j_build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import calibration as tcal
from repro_torch.core import policy as tpol
from repro_torch.core.ovp import QuantizedTensor
from repro_torch.core.qlinear import quantize_params as t_quantize_params
from repro_torch.core.qlinear import tree_paths as t_tree_paths
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serve import engine as teng

from _torch_parity import jax_greedy, port_forced
from _torch_dist import one_torch_thread  # noqa: F401

ARCH = "seamless-m4t-large-v2-smoke"
B, T, S, ENC_LEN, MAX_LEN, STEPS = 2, 6, 10, 16, 32, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread (the suite's workers
    share the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policies(quant: bool):
    if quant:       # the launcher's olive_serve: W4 + KV4
        jp = dataclasses.replace(jpol.OLIVE_SERVE, abits=0)
        tp = tpol.OLIVE_SERVE.replace_all(abits=0)
    else:
        jp, tp = jpol.QuantPolicy(), tpol.QuantPolicy()
    return (dataclasses.replace(jp, compute_dtype="float32", backend="xla"),
            dataclasses.replace(tp, compute_dtype="float32",
                                backend="eager"))


@functools.lru_cache(maxsize=None)
def _reference(quant: bool):
    """The reference's smoke model, its fp32 weights and (under
    olive_serve) its W4 PTQ of them."""
    jp, _ = _policies(quant)
    model = j_build_model(j_get_config(ARCH), jp, remat=False)
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    qparams = jax.jit(j_quantize_params, static_argnums=1)(
        params, dataclasses.replace(jp, kv_bits=0)) if quant else params
    return model, params, qparams


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


@pytest.mark.parametrize("quant", [True, False], ids=["olive_serve", "fp32"])
def test_model_logits_match_reference(quant):
    model, _, params = _reference(quant)
    cfg = model.cfg
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    frames = rng.standard_normal((B, S, cfg.frontend_dim)) \
        .astype(np.float32)
    kw = dict(inputs={"frames": frames}, enc_len=ENC_LEN)
    ref, fed = jax_greedy(model, params, toks, MAX_LEN, STEPS, **kw)
    _, tp = _policies(quant)
    tparams = _port(params)
    assert len(tparams["enc_blocks"]) == cfg.n_enc_layers
    assert sorted(tparams["layers"][0]) == ["attn", "ln1", "ln2", "lnx",
                                            "mlp", "xattn"]
    assert sorted(tparams["enc_blocks"][0]["mlp"]) == ["bd", "bi", "wd",
                                                       "wi"]
    got = port_forced(tmodel.build_model(t_get_config(ARCH), tp), tparams,
                      toks, fed, MAX_LEN, **kw)
    assert got.shape == ref.shape == (B, STEPS + 1, cfg.padded_vocab)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_caches_self_kv4_and_fp_cross():
    model = tmodel.build_model(t_get_config(ARCH), tpol.OLIVE_SERVE)
    layer = model.init_caches(2, 32, enc_len=ENC_LEN,
                              device="cpu")["layers"][0]
    assert sorted(layer) == ["kv", "xkv"]
    assert sorted(layer["kv"]) == ["k_data", "k_scl", "v_data", "v_scl"]
    assert sorted(layer["xkv"]) == ["k", "src_len", "v"]
    assert layer["xkv"]["k"].shape == (2, ENC_LEN, 4, 16)
    assert layer["xkv"]["k"].dtype == torch.float32


def _quantized(tree, reference):
    """{port path: (codes, scales)} of the quantized leaves; a
    `reference` tree's stacked leaves (the vmapped encoder, the scanned
    period-1 decoder `blocks/0`) split per layer under the port's paths
    (`enc_blocks/<i>/...`, `layers/<i>/...`)."""
    out = {}
    for path, leaf in tree:
        data = np.asarray(leaf.data)
        scale = np.asarray(leaf.scale)
        head, _, rest = path.partition("/")
        if reference and head in ("enc_blocks", "blocks"):
            if head == "blocks":
                head, rest = "layers", rest.split("/", 1)[1]
            for i in range(data.shape[0]):
                out[f"{head}/{i}/{rest}"] = (data[i], scale[i])
        else:
            out[path] = (data, scale)
    return out


@pytest.mark.parametrize("rules", ["", "enc_blocks/mlp/*=olive_w8a8"],
                         ids=["olive_serve", "encoder_mlp_w8"])
def test_encoder_quantizes_at_its_stack_sites(rules):
    """The port's PTQ of the carried-over fp32 tree against the
    reference's PTQ: the same quantized leaves, codes equal, scales
    within rtol 1e-6 (per-channel searches may land an ulp apart)."""
    jprog = jpol.get_program("olive_serve")
    tprog = tpol.get_program("olive_serve")
    if rules:
        jprog = jprog.with_rules(jpol.parse_rules(rules))
        tprog = tprog.with_rules(tpol.parse_rules(rules))
    jprog = jprog.replace_all(abits=0, kv_bits=0)
    tprog = tprog.replace_all(abits=0, kv_bits=0)
    _, params, _ = _reference(False)
    jq = jax.jit(j_quantize_params, static_argnums=1)(params, jprog)
    tq = t_quantize_params(_port(params), tprog)
    want = _quantized([(p, w) for p, w in j_tree_paths(jq)
                       if hasattr(w, "data")], True)
    got = _quantized([(p, w) for p, w in t_tree_paths(tq)
                      if isinstance(w, QuantizedTensor)], False)
    assert sorted(got) == sorted(want)
    assert any(site.startswith("enc_blocks/1/") for site in got)
    for site, (codes, scale) in want.items():
        assert np.array_equal(got[site][0], codes), site
        np.testing.assert_allclose(got[site][1], scale, rtol=1e-6)
    enc_mlp = [w.normal_dtype for p, w in t_tree_paths(tq["enc_blocks"])
               if isinstance(w, QuantizedTensor) and "/mlp/" in f"/{p}"]
    assert enc_mlp == ["int8" if rules else "int4"] * 4


def test_encoder_min_size_gates_the_stack():
    """min_size between one encoder layer's wq (64 x 64) and the stack's
    (2 x 64 x 64): the reference quantizes its stacked leaf, and so does
    the port every layer's slice."""
    pol = tpol.OLIVE_SERVE.replace_all(abits=0, kv_bits=0)
    _, params, _ = _reference(False)
    jq = jax.jit(j_quantize_params, static_argnums=(1, 2))(
        params, dataclasses.replace(jpol.OLIVE_SERVE, abits=0, kv_bits=0),
        8192)
    tq = t_quantize_params(_port(params), pol, min_size=8192)
    assert hasattr(jq["enc_blocks"]["attn"]["wq"], "data")
    assert all(isinstance(layer["attn"]["wq"], QuantizedTensor)
               for layer in tq["enc_blocks"])
    one = t_quantize_params(_port(params)["enc_blocks"][0], pol,
                            min_size=8192, prefix="layers/0")
    assert not isinstance(one["attn"]["wq"], QuantizedTensor)


def test_forward_tapes_the_encoder_at_its_stack_sites():
    cfg = t_get_config(ARCH)
    model = tmodel.build_model(cfg, tpol.QuantPolicy(
        compute_dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tape = tcal.SizeTape()
    with tcal.collecting_activations(tape):
        model.forward(params, {"tokens": torch.zeros((1, 3),
                                                     dtype=torch.int64),
                               "frames": torch.zeros((1, 5, 32))})
    sites = [site for site, _ in tape.records]
    enc = [s for s in sites if s.startswith("enc_blocks/")]
    assert sites[0] == "frontend_proj/w_in"
    assert enc == []
    assert sites[1:] == [f"layers/{i}/{leaf}" for i in range(cfg.n_layers)
                         for leaf in ("attn/wq", "attn/wk", "attn/wv",
                                      "attn/wo", "xattn/wq", "xattn/wk",
                                      "xattn/wv", "xattn/wo", "mlp/wi",
                                      "mlp/wd")] + ["lm_head/w_out"]


@pytest.mark.parametrize("quant", ["olive_serve", "int4"])
def test_launcher_refuses_before_drawing_weights(quant, monkeypatch):
    def drawn(*args, **kwargs):
        raise AssertionError("weights drawn before the refusal")

    monkeypatch.setattr(tmodel.Model, "init_stream", drawn)
    with pytest.raises(ValueError, match="encoder-decoder"):
        tserve.run(["--arch", ARCH, "--quant", quant], device="cpu")


def test_engine_refuses_an_encoder_decoder():
    model = tmodel.build_model(t_get_config(ARCH), tpol.QuantPolicy())
    with pytest.raises(ValueError, match="feeds tokens only"):
        teng.ServingEngine(model, {}, teng.EngineCfg(batch_slots=1,
                                                     max_len=16),
                           device="cpu")
