"""The port's VLM (InternVL2-1B's smoke config: 2 dense layers, d 64, 4
heads over 2 KV heads, a ViT stub frontend of 4 patch embeddings of
32-d) against the JAX package, with the reference's random init
(`PRNGKey(0)`) and PTQ carried across.

- `Model.forward` with `patch_embeds`: the projected patches go in front
  of the token embeddings (not scaled by sqrt(d)), the prefill runs
  positions 0..P+T-1, and the decode steps run at P + T + i; under
  `olive_serve` (W4 + KV4, fp32 compute: the reference's `xla` against
  the port's `eager`) and unquantized, a 6-token prompt + 6 decode steps
  fed the reference's greedy tokens (`_torch_parity`); atol 1e-4, the
  model tests' tolerance.
- The serving engine on tokens alone, as the reference's serves this
  arch: greedy tokens and finish reasons identical to the reference
  engine's with no tolerance, slab and paged (page 16, chunk 16), 5
  prompts of 4-31 tokens, 6 new tokens each, olive_serve.
- The launcher serves the smoke arch on the CPU, slab and paged.
- `--calibrate`: the artifact's sites are the reference launcher's (its
  synthetic (2, 64) batch from seed 0 through `calibrate_model`), the
  streamed calibration carries the top-level `frontend_proj` piece into
  the served params, and on the reference's weights the port's
  `calibrate_model` gives the reference's scales within rtol 1e-6.
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
from repro.core import calibration as jcal
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models.model import build_model as j_build_model
from repro.serve import engine as jeng
from repro.serve import paging as jpg
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import calibration as tcal
from repro_torch.core import policy as tpol
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serve import engine as teng
from repro_torch.serve import paging as tpg

from _torch_parity import jax_greedy, port_forced
from _torch_dist import one_torch_thread  # noqa: F401

ARCH = "internvl2-1b-smoke"
B, T, MAX_LEN, STEPS = 2, 6, 32, 6
SLOTS, E_MAX_LEN, MAX_NEW = 2, 64, 6
STATIC = dict(compute_dtype="float32", act_scale_mode="static")


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


@functools.lru_cache(maxsize=None)
def _port_params(quant: bool):
    return params_from_numpy(jax.tree_util.tree_map(
        np.asarray, _reference(quant)[2]), device="cpu")


@pytest.mark.parametrize("quant", [True, False], ids=["olive_serve", "fp32"])
def test_model_logits_with_patches_match_reference(quant):
    model, _, params = _reference(quant)
    cfg = model.cfg
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.n_frontend_tokens,
                                   cfg.frontend_dim)).astype(np.float32)
    kw = dict(inputs={"patch_embeds": patches},
              offset=cfg.n_frontend_tokens)
    ref, fed = jax_greedy(model, params, toks, MAX_LEN, STEPS, **kw)
    _, tp = _policies(quant)
    tparams = _port_params(quant)
    assert sorted(tparams["frontend_proj"]) == ["b_in", "w_in"]
    got = port_forced(tmodel.build_model(t_get_config(ARCH), tp), tparams,
                      toks, fed, MAX_LEN, **kw)
    assert got.shape == ref.shape == (B, STEPS + 1, cfg.padded_vocab)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_prefill_with_patches_is_longer_by_the_patches():
    cfg = t_get_config(ARCH)
    model = tmodel.build_model(cfg, tpol.QuantPolicy(
        compute_dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.arange(5)[None]
    patches = torch.randn((1, cfg.n_frontend_tokens, cfg.frontend_dim),
                          generator=torch.Generator().manual_seed(1))
    with_p, _ = model.forward(params, {"tokens": toks,
                                       "patch_embeds": patches})
    alone, _ = model.forward(params, {"tokens": toks})
    assert with_p.shape[1] == cfg.n_frontend_tokens + alone.shape[1]
    assert not torch.allclose(with_p[:, -1], alone[:, -1])


# --------------------------------------------------------------------------
# The engine and the launcher, on tokens
# --------------------------------------------------------------------------
def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=int(rng.integers(4, 32)))
            .astype(np.int32) for _ in range(5)]


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    done = eng.run_until_drained()
    return {r.uid: (list(r.out_tokens), r.finish_reason) for r in done}


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_engine_greedy_tokens_identical(paged):
    model, _, params = _reference(True)
    prompts = _prompts(model.cfg.vocab)
    pool = dict(page_pool=jpg.PagePoolCfg(16), prefill_chunk=16) \
        if paged else {}
    ref = _serve(jeng.ServingEngine(model, params, jeng.EngineCfg(
        batch_slots=SLOTS, max_len=E_MAX_LEN, **pool)), prompts)
    _, tp = _policies(True)
    if paged:
        pool = dict(page_pool=tpg.PagePoolCfg(16), prefill_chunk=16)
    eng = teng.ServingEngine(tmodel.build_model(t_get_config(ARCH), tp),
                             _port_params(True), teng.EngineCfg(
                                 batch_slots=SLOTS, max_len=E_MAX_LEN,
                                 **pool), device="cpu")
    got = _serve(eng, prompts)
    assert got == ref
    assert all(len(toks) == MAX_NEW for toks, _ in got.values())
    assert eng.paged == paged


@pytest.mark.parametrize("extra", [[], ["--paged", "16", "--prefill-chunk",
                                        "16"]], ids=["slab", "paged"])
def test_launcher_serves_smoke_on_cpu(extra):
    res = tserve.run(["--arch", ARCH, "--quant", "olive_serve",
                      "--requests", "3", "--max-new", "4", "--slots", "2",
                      "--max-len", "64"] + extra, device="cpu")
    assert res["tokens"] == 12 and len(res["completed"]) == 3
    cfg = res["model"].cfg
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.rope_theta) == (4, 2, 1e6)
    assert res["params"]["frontend_proj"]["w_in"].shape == (32, 64)
    assert res["engine"].paged == bool(extra)


# --------------------------------------------------------------------------
# --calibrate
# --------------------------------------------------------------------------
def _launcher_batch(vocab):
    return np.random.default_rng(0).integers(0, vocab, size=(2, 64)) \
        .astype(np.int32)


def test_launcher_calibrate_holds_the_reference_sites_and_scales(tmp_path):
    cfg = j_get_config(ARCH)
    jmodel = j_build_model(cfg, jpol.OLIVE_SERVE.replace_all(**STATIC),
                           remat=False)
    jparams = _reference(False)[1]
    batch = _launcher_batch(cfg.vocab)
    jart = jcal.calibrate_model(jmodel, jparams,
                                [{"tokens": jnp.asarray(batch)}])
    res = tserve.run(["--arch", ARCH, "--quant", "olive_serve",
                      "--requests", "2", "--max-new", "2", "--slots", "2",
                      "--max-len", "32", "--calibrate", "--calibration",
                      str(tmp_path / "c.json")], device="cpu")
    assert res["artifact"].sites() == jart.sites()
    assert "frontend_proj" in res["params"]
    assert [len(r.out_tokens) for r in res["completed"]] == [2, 2]
    # the scales, on the reference's weights
    tmodel_ = tmodel.build_model(t_get_config(ARCH),
                                 tpol.OLIVE_SERVE.replace_all(**STATIC))
    tart = tcal.calibrate_model(tmodel_, _port_params(False),
                                [{"tokens": torch.from_numpy(batch)}])
    assert tart.sites() == jart.sites()
    for site in jart.sites():
        np.testing.assert_allclose(tart.resolve(site), jart.resolve(site),
                                   rtol=1e-6, err_msg=site)


def test_streamed_calibration_equals_the_whole_tree():
    """`calibrate_streamed` on the launcher's draw (the first piece
    carries `frontend_proj`) against `calibrate_model` on the whole
    tree from the same seed: the same artifact, and the same params."""
    cfg = t_get_config(ARCH)
    policy = tpol.OLIVE_SERVE.replace_all(**STATIC)
    model = tmodel.build_model(cfg, policy)
    batches = [{"tokens": torch.from_numpy(_launcher_batch(cfg.vocab))}]

    def quantize(tree, prefix):
        return tserve.quantize_params(tree, policy, prefix=prefix)

    params, art = tcal.calibrate_streamed(
        model, torch.Generator().manual_seed(0), batches, "cpu", quantize)
    whole = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(params["frontend_proj"]["w_in"],
                       whole["frontend_proj"]["w_in"])
    assert art.as_dict() == tcal.calibrate_model(model, whole,
                                                 batches).as_dict()
