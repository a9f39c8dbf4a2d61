"""The port's serving engine on the xLSTM family (xLSTM-350M: mLSTM and
sLSTM blocks, recurrent state only) against the JAX package's, with the
reference's random init (`PRNGKey(0)`) and PTQ carried across.

- Greedy tokens and finish reasons identical to the reference engine's,
  with no tolerance: `xlstm-350m-smoke`, 8 prompts of 4-31 tokens (the
  launcher's workload), 4 slots, max_len 64, 16 new tokens, olive_serve
  on `xla` / `eager`. Neither engine buckets (`_bucket_ok` false), and
  the prefill cache holds the same keys, the prompts' exact lengths, in
  the same LRU order.
- A decode step writes the recurrent state in place: every mLSTM and
  sLSTM leaf (the nested `mem` ones included) keeps its `data_ptr()`
  and changes value.
- A request admitted into a slot that served another request gives the
  tokens it gives in a fresh engine: the row reset and the splice cover
  the nested leaves.
- A page pool and the launcher's `--paged` raise the reference's
  ValueError, the launcher before any weight is drawn; a baseline
  preset (`--quant int4`) serves, each linear fake-quantized over the
  stack of its period position (the reference's `blocks/<j>`).
- The async front end serves the smoke arch through the launcher.
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
from repro.models.model import build_model as j_build_model
from repro.serve import engine as jeng
from repro.serve import paging as jpg
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.serve import engine as teng
from repro_torch.serve import paging as tpg

from _torch_dist import one_torch_thread  # noqa: F401

ARCH = "xlstm-350m-smoke"
SLOTS, E_MAX_LEN, MAX_NEW = 4, 64, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread (the suite's workers
    share the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's smoke model, its weights and its olive_serve W4
    PTQ (`xla`, fp32 compute)."""
    jp = dataclasses.replace(jpol.OLIVE_SERVE, abits=0,
                             compute_dtype="float32", backend="xla")
    model = j_build_model(j_get_config(ARCH), jp, remat=False)
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = jax.jit(j_quantize_params, static_argnums=1)(
        params, dataclasses.replace(jp, kv_bits=0))
    return model, params


@functools.lru_cache(maxsize=None)
def _port_params():
    _, params = _reference()
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=int(rng.integers(4, 32)))
            .astype(np.int32) for _ in range(8)]


def _serve(eng, prompts, max_new=MAX_NEW):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    done = eng.run_until_drained()
    return {r.uid: (list(r.out_tokens), r.finish_reason) for r in done}


def _port_engine(**cfg):
    tp = dataclasses.replace(tpol.OLIVE_SERVE.replace_all(abits=0),
                             compute_dtype="float32", backend="eager")
    return teng.ServingEngine(tmodel.build_model(t_get_config(ARCH), tp),
                              _port_params(), teng.EngineCfg(**cfg),
                              device="cpu")


def test_engine_greedy_tokens_identical():
    model, params = _reference()
    prompts = _prompts(model.cfg.vocab)
    ref_eng = jeng.ServingEngine(model, params, jeng.EngineCfg(
        batch_slots=SLOTS, max_len=E_MAX_LEN))
    ref = _serve(ref_eng, prompts)
    eng = _port_engine(batch_slots=SLOTS, max_len=E_MAX_LEN)
    got = _serve(eng, prompts)
    assert got == ref
    assert all(len(toks) == MAX_NEW for toks, _ in got.values())
    assert not eng._bucket_ok and not ref_eng._bucket_ok
    assert list(eng._prefill_cache) == list(ref_eng._prefill_cache)
    assert sorted(eng._prefill_cache) == sorted({len(p) for p in prompts})
    assert eng.trace_audit() == ref_eng.trace_audit()


def _state_leaves(eng):
    return [leaf for layer in eng.caches["layers"]
            for site in (layer.get("mlstm"), layer.get("slstm"))
            if site is not None
            for leaf in list(site["mem"].values())
            + ([site["conv"]] if "conv" in site else [])]


def test_decode_step_writes_recurrent_state_in_place():
    eng = _port_engine(batch_slots=2, max_len=E_MAX_LEN)
    for n in (5, 9):
        eng.submit(np.arange(n, dtype=np.int32) + 3, max_new_tokens=6)
    eng.step()                          # admits both, one decode step
    leaves = _state_leaves(eng)
    assert len(leaves) == 2 * 4 + 2 * 4       # mLSTM c, n, m, conv; sLSTM
    assert {id(x) for x in leaves} <= {id(x) for x in teng._leaves(
        eng.caches)}
    ptrs = [leaf.data_ptr() for leaf in leaves]
    before = [leaf.clone() for leaf in leaves]
    eng.step()
    assert [leaf.data_ptr() for leaf in leaves] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(leaves, before))


def test_reused_slot_serves_as_a_fresh_engine():
    """One slot serves A, then B (reset row cache, splice over A's state);
    B's tokens equal a fresh engine's."""
    rng = np.random.default_rng(3)
    first, second = (rng.integers(0, 512, size=n).astype(np.int32)
                     for n in (23, 11))
    eng = _port_engine(batch_slots=1, max_len=E_MAX_LEN)
    got = _serve(eng, [first, second], max_new=9)
    fresh = _serve(_port_engine(batch_slots=1, max_len=E_MAX_LEN),
                   [second], max_new=9)
    assert got[2] == fresh[1]
    assert got[1] != got[2]


def _reference_error(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_paged_serving_raises_the_reference_error():
    model, params = _reference()
    want = _reference_error(lambda: jeng.ServingEngine(
        model, params, jeng.EngineCfg(page_pool=jpg.PagePoolCfg(16))))
    assert "ring/recurrent state does not page" in want
    got = _reference_error(lambda: _port_engine(
        page_pool=tpg.PagePoolCfg(16)))
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


@pytest.mark.parametrize("use_async", [False, True], ids=["drained",
                                                          "async"])
def test_launcher_serves_smoke(use_async):
    res = tserve.run(["--arch", ARCH, "--quant", "olive_serve",
                      "--requests", "4", "--max-new", "5", "--slots", "2",
                      "--max-len", "64"] + (["--async"] if use_async
                                            else []), device="cpu")
    assert res["tokens"] == 20 and len(res["completed"]) == 4
    assert all(r.finish_reason == "max_new_tokens" for r in res["completed"])
    assert not res["engine"]._bucket_ok
    if use_async:
        assert res["metrics"]["requests"] == 4
        assert res["metrics"]["finish_reasons"] == {"max_new_tokens": 4}
    st = res["engine"].stats()
    assert st["prefills_run"] == 4 and st["prefill_chunks_run"] == 0


def test_launcher_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tserve.run(["--arch", ARCH, "--quant", "olive_serve"])
