"""The port's serving engine on the hybrid family (RecurrentGemma: RG-LRU
blocks and local attention over a ring KV cache) against the JAX
package's, with the reference's random init (`PRNGKey(0)`) and PTQ
carried across.

- Greedy tokens and finish reasons identical to the reference engine's,
  with no tolerance: `recurrentgemma-9b-smoke`, 8 prompts of 4-31 tokens
  (the launcher's workload), 4 slots, max_len 64, 16 new tokens,
  olive_serve on `xla` / `eager`. Neither engine buckets (`_bucket_ok`
  false), and the prefill cache holds the same keys, the prompts' exact
  lengths, in the same LRU order.
- A decode step writes the recurrent state in place: the `rec` leaves
  keep their `data_ptr()` and change value.
- A page pool and the launcher's `--paged` raise the reference's
  ValueError, the launcher before any weight is drawn; a baseline
  preset (`--quant int4`) serves, each linear fake-quantized over the
  stack of its period position (the reference's `blocks/<j>`), and an
  `encdec_attn` block in a config without an encoder (`enc_dec` false)
  raises naming it.
- The async front end serves the smoke arch through the launcher, and
  a pure-rglru model (`d_rnn` 0, so d_model wide) on the slab path, as
  the reference's `test_async_recurrent_slab_arch`.
"""
from __future__ import annotations

import asyncio
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
from repro.models.model import build_model as j_build_model
from repro.serve import engine as jeng
from repro.serve import paging as jpg
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serve import engine as teng
from repro_torch.serve import paging as tpg
from repro_torch.serve.frontend import AsyncFrontend

from _torch_dist import one_torch_thread  # noqa: F401

ARCH = "recurrentgemma-9b-smoke"
SLOTS, E_MAX_LEN, MAX_NEW = 4, 64, 16


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
def _reference(n_layers: int, quant: bool):
    """The reference's smoke model at `n_layers`, its weights and (under
    olive_serve) its W4 PTQ."""
    jcfg = dataclasses.replace(j_get_config(ARCH), n_layers=n_layers)
    jp, _ = _policies(quant)
    model = j_build_model(jcfg, jp, remat=False)
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant:
        params = jax.jit(j_quantize_params, static_argnums=1)(
            params, dataclasses.replace(jp, kv_bits=0))
    return jcfg, model, params


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------
def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=int(rng.integers(4, 32)))
            .astype(np.int32) for _ in range(8)]


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    done = eng.run_until_drained()
    return {r.uid: (list(r.out_tokens), r.finish_reason) for r in done}


def _port_engine(params, **cfg):
    _, tp = _policies(True)
    return teng.ServingEngine(tmodel.build_model(t_get_config(ARCH), tp),
                              params, teng.EngineCfg(**cfg), device="cpu")


def test_engine_greedy_tokens_identical():
    jcfg, model, params = _reference(6, True)
    prompts = _prompts(jcfg.vocab)
    ref_eng = jeng.ServingEngine(model, params, jeng.EngineCfg(
        batch_slots=SLOTS, max_len=E_MAX_LEN))
    ref = _serve(ref_eng, prompts)
    eng = _port_engine(_port(params), batch_slots=SLOTS, max_len=E_MAX_LEN)
    got = _serve(eng, prompts)
    assert got == ref
    assert all(len(toks) == MAX_NEW for toks, _ in got.values())
    assert not eng._bucket_ok and not ref_eng._bucket_ok
    assert list(eng._prefill_cache) == list(ref_eng._prefill_cache)
    assert sorted(eng._prefill_cache) == sorted({len(p) for p in prompts})
    assert eng.trace_audit() == ref_eng.trace_audit()


def test_decode_step_writes_recurrent_state_in_place():
    _, _, params = _reference(6, True)
    eng = _port_engine(_port(params), batch_slots=2, max_len=E_MAX_LEN)
    for n in (5, 9):
        eng.submit(np.arange(n, dtype=np.int32) + 3, max_new_tokens=6)
    eng.step()                          # admits both, one decode step
    rec = [layer["rec"] for layer in eng.caches["layers"] if "rec" in layer]
    leaves = [leaf for site in rec for leaf in site.values()]
    ptrs = [leaf.data_ptr() for leaf in leaves]
    before = [leaf.clone() for leaf in leaves]
    eng.step()
    assert [leaf.data_ptr() for leaf in leaves] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(leaves, before))


def _reference_error(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_paged_serving_raises_the_reference_error():
    jcfg, model, params = _reference(6, True)
    want = _reference_error(lambda: jeng.ServingEngine(
        model, params, jeng.EngineCfg(page_pool=jpg.PagePoolCfg(16))))
    assert "ring/recurrent state does not page" in want
    got = _reference_error(lambda: _port_engine(
        _port(params), page_pool=tpg.PagePoolCfg(16)))
    assert got == want
    tm = tmodel.build_model(t_get_config(ARCH), tpol.OLIVE_SERVE)
    assert _reference_error(
        lambda: tm.init_paged_caches(8, 16, 2, 4, device="cpu")) == \
        _reference_error(lambda: model.init_paged_caches(8, 16, 2, 4))


def test_launcher_paged_raises_before_drawing_weights(monkeypatch):
    def drawn(*args, **kwargs):
        raise AssertionError("weights drawn before the page-pool check")

    monkeypatch.setattr(tmodel.Model, "init_stream", drawn)
    with pytest.raises(ValueError, match="ring/recurrent state does not "
                                         "page"):
        tserve.run(["--arch", ARCH, "--quant", "olive_serve", "--paged",
                    "16"], device="cpu")


def test_launcher_refuses_a_baseline_over_mixed_blocks():
    """No longer refused (the name is kept from when it was): a flat
    baseline fake-quantizes each linear over the stack of its period
    position, the reference's `blocks/<j>`, so the launcher serves
    `--quant int4` over mixed block types, its weights the per-period
    PTQ of the tree its seed draws (held to the reference's in
    `test_torch_baselines_families.py`)."""
    from repro_torch.core.qlinear import quantize_params, tree_paths
    res = tserve.run(["--arch", ARCH, "--quant", "int4", "--requests", "2",
                      "--max-new", "3", "--slots", "2", "--max-len", "64"],
                     device="cpu")
    assert res["tokens"] == 6 and len(res["completed"]) == 2
    cfg = t_get_config(ARCH)
    want = quantize_params(tmodel.build_model(cfg).init(
        torch.Generator().manual_seed(0), device="cpu"), res["policy"],
        period=len(cfg.block_pattern))
    got = dict(tree_paths(res["params"]))
    for path, leaf in tree_paths(want):
        assert torch.equal(got[path], leaf), path


@pytest.mark.parametrize("btype", ["encdec_attn"])
def test_unported_block_types_raise(btype):
    cfg = dataclasses.replace(t_get_config(ARCH),
                              block_pattern=("rglru", btype))
    with pytest.raises(ValueError, match="has no encoder"):
        tmodel.build_model(cfg)


# --------------------------------------------------------------------------
# The launcher and the async front end
# --------------------------------------------------------------------------
def test_launcher_serves_smoke_async():
    res = tserve.run(["--arch", ARCH, "--quant", "olive_serve",
                      "--requests", "4", "--max-new", "5", "--slots", "2",
                      "--max-len", "64", "--async"], device="cpu")
    assert res["tokens"] == 20 and len(res["completed"]) == 4
    assert res["metrics"]["requests"] == 4
    assert res["metrics"]["finish_reasons"] == {"max_new_tokens": 4}
    assert all(r.finish_reason == "max_new_tokens" for r in res["completed"])
    assert not res["engine"]._bucket_ok


def test_async_recurrent_slab_arch():
    """A pure-rglru model (d_rnn 0: d_model wide) through the front end
    on the slab path, exact-length prefill."""
    cfg = tbase.ArchConfig(name="fe-rg", family="hybrid", n_layers=2,
                           d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                           vocab=256, head_dim=16, block_pattern=("rglru",))
    model = tmodel.build_model(cfg, tpol.QuantPolicy(compute_dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert params["layers"][0]["rec"]["wx"].shape == (64, 64)
    eng = teng.ServingEngine(model, params, teng.EngineCfg(
        batch_slots=1, max_len=64), device="cpu")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (5, 8)]

    async def go():
        async with AsyncFrontend(eng) as fe:
            streams = [fe.submit(p, max_new_tokens=2) for p in prompts]
            for s in streams:
                async for _ in s:
                    pass
        return streams

    streams = asyncio.run(go())
    assert all(len(s.tokens) == 2 for s in streams)
    assert all(s.finish_reason == "max_new_tokens" for s in streams)
    assert sorted(eng._prefill_cache) == [5, 8]
