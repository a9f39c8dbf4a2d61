"""The serving CLI's remaining pieces in the port: the mixed-expert
dispatch that a captured step can run, the launcher's `--async`,
`--stream`, `--metrics-out`, `--policy-rules` and program presets, and a
mixed W4/W8 program with packed and fp KV caches in one engine against
the reference's engine.

- `backends.dispatch` over a `MixedExpertQuant` builds no tensor from
  host data (it reads the index tensors the stack built once, on its
  device) and gives the outputs of the per-call construction it
  replaces, bit for bit;
- `launch.serve.run([... '--async', '--stream', '--metrics-out', path],
  device='cpu')` prints each token, writes a trace that the reference's
  `load_trace` reads, and serves the tokens of the drained loop;
  `--stream` without `--async` is an error;
- `--quant olive_mixed_w48`, `olive_owq_style` and `--policy-rules`
  serve the smoke models, with the W8 leaves and cache kinds the
  program resolves;
- the committed `bench_lm_30.npz` fixture (4 layers) quantized by the
  reference under `olive_mixed_w48` with packed KV caches on layers 0
  and 3 (fp caches between), served slab and paged with 16-token chunks:
  greedy tokens and finish reasons equal to the reference engine's, no
  tolerance. The port runs `eager`, where the reference's dense decode
  rounds a packed cache to bfloat16 (tests/test_torch_engine.py).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from benchmarks import common
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as _j_quantize_params
from repro.models.model import build_model as j_build_model
from repro.models.model import unroll_params
from repro.serve import engine as jeng
from repro.serve import paging as jpg
from repro.serve.metrics import load_trace as j_load_trace
from repro_torch import backends
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.core import qlinear as tq
from repro_torch.core.ovp import MixedExpertQuant, QuantizedTensor
from repro_torch.launch import serve
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serve import engine as teng
from repro_torch.serve import load_trace
from repro_torch.serve import paging as tpg

from _torch_dist import one_torch_thread  # noqa: F401

SMOKE = ["--arch", "qwen1.5-0.5b-smoke", "--requests", "3", "--max-new",
         "3", "--slots", "2", "--max-len", "64"]
W8 = dataclasses.replace(tpol.OLIVE_W8A8, abits=0, compute_dtype="float32")
W4 = dataclasses.replace(tpol.OLIVE_W4A4, abits=0, compute_dtype="float32")


def _mixed_stack(seed=0, e=6, k=64, n=48):
    """A (6, 64, 48) stack: experts 1 and 4 at W8, 5 left fp, the rest
    W4, so three groups in first-appearance order."""
    prog = tpol.PolicyProgram(rules=(("experts/wg/[14]", W8),
                                     ("experts/wg/5", tpol.FP)), default=W4)
    w = torch.from_numpy(np.random.default_rng(seed)
                         .standard_normal((e, k, n)).astype(np.float32))
    return tq.quantize_params({"experts": {"wg": w}}, prog,
                              min_size=1)["experts"]["wg"], prog


def _per_call_dispatch(x, w, policy, fill):
    """The mixed dispatch as it was, with index tensors made from the
    stack's Python lists at every call."""
    outs = []
    for qt, ids in zip(w.groups, w.expert_ids):
        idx = torch.as_tensor(ids, dtype=torch.int64)
        xg = torch.index_select(x, x.ndim - 3, idx)
        if isinstance(qt, QuantizedTensor):
            fg = None if fill is None else torch.index_select(
                fill, fill.ndim - 1, idx)
            outs.append(backends.dispatch(xg, qt, policy, fill=fg))
        else:
            outs.append(torch.matmul(xg, qt))
    cat = torch.cat(outs, dim=-3)
    flat = [e for ids in w.expert_ids for e in ids]
    order = torch.as_tensor(sorted(range(len(flat)), key=flat.__getitem__))
    return torch.index_select(cat, cat.ndim - 3, order)


@pytest.mark.parametrize("with_fill", [False, True])
def test_mixed_dispatch_builds_no_host_tensor(with_fill, monkeypatch):
    w, _ = _mixed_stack()
    assert isinstance(w, MixedExpertQuant)
    assert w.expert_ids == ((0, 2, 3), (1, 4), (5,))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 6, 4, 64))
                         .astype(np.float32))
    fill = torch.from_numpy(rng.integers(0, 5, (2, 6))) if with_fill \
        else None
    want = _per_call_dispatch(x, w, W4, fill)
    index, order = w.group_index, w.order
    host_built = []
    as_tensor, tensor = torch.as_tensor, torch.tensor

    def watch(make):
        def wrapped(data, *args, **kw):
            if not isinstance(data, torch.Tensor):
                host_built.append(data)
            return make(data, *args, **kw)
        return wrapped

    monkeypatch.setattr(torch, "as_tensor", watch(as_tensor))
    monkeypatch.setattr(torch, "tensor", watch(tensor))
    got = backends.dispatch(x, w, W4, fill=fill)
    monkeypatch.undo()
    assert host_built == []
    assert w.group_index is index and w.order is order
    if fill is None:
        assert torch.equal(got, want)
    else:       # rows past the fill may be left unwritten: compare filled
        rows = torch.arange(4)[None, None, :] < fill[..., None]
        assert torch.equal(got[rows], want[rows])


def test_mixed_stack_index_tensors_follow_the_stack():
    """The stack's index tensors sit on its weights' device and are made
    again when a stack is rebuilt (`convert`, `dataclasses.replace`);
    they take no part in equality."""
    w, _ = _mixed_stack()
    assert [t.tolist() for t in w.group_index] == [[0, 2, 3], [1, 4], [5]]
    assert w.order.tolist() == [0, 3, 1, 2, 4, 5]
    assert w.order.dtype == torch.int64 and w.order.device == w.groups[
        0].data.device
    raw = {"groups": [dict(data=g.data.numpy(), scale=g.scale.numpy(),
                           normal_dtype=g.normal_dtype,
                           pair_axis=g.pair_axis, orig_dim=g.orig_dim)
                      for g in w.groups[:2]],
           "expert_ids": [[0, 2, 3], [1, 4]], "n_experts": 5}
    conv = params_from_numpy({"m": raw}, device="cpu")["m"]
    assert isinstance(conv, MixedExpertQuant)
    assert conv.order.tolist() == [0, 3, 1, 2, 4]
    again = dataclasses.replace(w)
    assert again.order is not w.order and torch.equal(again.order, w.order)


def test_async_stream_metrics_out(tmp_path, capsys):
    path = str(tmp_path / "trace.jsonl")
    args = SMOKE + ["--quant", "olive_serve", "--paged", "16",
                    "--prefill-chunk", "16"]
    res = serve.run(args + ["--async", "--stream", "--metrics-out", path],
                    device="cpu")
    out = capsys.readouterr().out
    for r in res["completed"]:
        assert f"[stream] uid={r.uid} first token={r.out_tokens[0]}" in out
        assert f"[stream] uid={r.uid} done ({len(r.out_tokens)} tokens, " \
               f"{r.finish_reason})" in out
    ref, got = j_load_trace(path), load_trace(path)
    assert ref == got
    snap = res["metrics"]
    assert got["summary"] == snap
    assert snap["requests"] == 3 and snap["fallbacks"] == 0
    assert snap["steps"] == len(got["steps"]) == res["engine"].steps_run
    assert snap["tokens"] == res["tokens"] == 9
    assert got["meta"]["paged"] and got["meta"]["prefill_chunk"] == 16
    drained = serve.run(args, device="cpu")
    assert drained["metrics"] is None
    assert [r.out_tokens for r in drained["completed"]] == \
        [r.out_tokens for r in res["completed"]]


def test_drained_loop_writes_the_trace(tmp_path):
    path = str(tmp_path / "drained.jsonl")
    res = serve.run(SMOKE + ["--quant", "olive_serve", "--metrics-out",
                             path], device="cpu")
    trace = j_load_trace(path)
    assert trace["summary"] == res["metrics"]
    assert [r["uid"] for r in trace["requests"]] == \
        [r.uid for r in res["completed"]]
    assert trace["meta"]["paged"] is False


def test_stream_requires_async(capsys):
    with pytest.raises(SystemExit):
        serve.run(SMOKE + ["--stream"], device="cpu")
    assert "--stream requires --async" in capsys.readouterr().err


def _dtypes(params, leaf):
    return [layer["attn"][leaf].normal_dtype for layer in params["layers"]]


@pytest.mark.parametrize("quant,rules,paged,want", [
    ("olive_mixed_w48", None, False,
     {"wq": ["int8", "int8"], "wd": ["int8", "int8"], "kv": [0, 0]}),
    ("olive_owq_style", None, True,
     {"wq": ["int8", "int8"], "wv": ["int4", "int4"], "kv": [0, 0]}),
    ("olive_serve", "layers/1/*=olive_w8a8,layers/0/mlp/wd=olive_w8a8",
     True, {"wq": ["int4", "int8"], "wd": ["int8", "int8"], "kv": [4, 0]}),
])
def test_program_presets_and_rules_serve(quant, rules, paged, want):
    args = SMOKE + ["--quant", quant]
    args += ["--policy-rules", rules] if rules else []
    args += ["--paged", "16", "--prefill-chunk", "16"] if paged else []
    backends.reset_dispatch_stats()
    res = serve.run(args, device="cpu")
    params, eng = res["params"], res["engine"]
    assert res["tokens"] == 9
    assert not any("fallback" in k for k in backends.dispatch_stats())
    for leaf in ("wq", "wv"):
        if leaf in want:
            assert _dtypes(params, leaf) == want[leaf]
    if "wd" in want:
        assert [layer["mlp"]["wd"].normal_dtype
                for layer in params["layers"]] == want["wd"]
    kinds = [4 if "k_data" in layer["kv"] else 0
             for layer in eng.caches["layers"]]
    assert kinds == want["kv"]
    assert res["policy"].kv_bits == max(want["kv"])


def test_launcher_builds_programs_in_reference_order():
    """A preset, then the rules in front of it, then the rewrite: a rule
    overrides the preset at its sites only."""
    res = serve.run(SMOKE + ["--quant", "olive_mixed_w48", "--policy-rules",
                             "layers/1/mlp/*=olive_w4a4"], device="cpu")
    pol = res["policy"]
    assert pol.name == "olive_mixed_w48"
    assert [r.pattern for r in pol.rules[:3]] == [
        "layers/1/mlp/*", "layers/0/*", "layers/1/*"]
    assert pol.resolve("layers/1/mlp/wd").wbits == 4
    assert pol.resolve("layers/1/attn/wq").wbits == 8
    assert {r.policy.abits for r in pol.rules} | {pol.default.abits} == {0}
    assert [layer["mlp"]["wd"].normal_dtype
            for layer in res["params"]["layers"]] == ["int8", "int4"]


KV_RULES = "layers/0/attn/kv=olive_serve,layers/3/attn/kv=olive_serve"


@functools.lru_cache(maxsize=None)
def _mixed_fixture():
    """(reference cfg, its `olive_mixed_w48` + KV-rule program, the W4/W8
    tree it quantized, the port's cfg and program)."""
    jcfg = common._lm_cfg()
    _, params, _ = common.trained_lm(steps=30)

    def program(pol):
        return pol.get_program("olive_mixed_w48", 4).with_rules(
            pol.parse_rules(KV_RULES)).replace_all(compute_dtype="float32",
                                                   abits=0)

    jprog = program(jpol)
    qparams = jax.jit(_j_quantize_params, static_argnums=1)(
        unroll_params(jcfg, params), jprog)
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    tcfg = ArchConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                         if k in fields})
    return jcfg, jprog, qparams, tcfg, program(tpol)


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new_tokens=5)
    return {r.uid: (list(r.out_tokens), r.finish_reason)
            for r in eng.run_until_drained()}


@pytest.mark.parametrize("chunk", [None, 16])
def test_mixed_program_engine_matches_reference(chunk):
    jcfg, jprog, qparams, tcfg, tprog = _mixed_fixture()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32)
               for n in (5, 40, 9, 14)]
    page = dict(page_pool=jpg.PagePoolCfg(16), prefill_chunk=chunk) \
        if chunk else {}
    ref = _serve(jeng.ServingEngine(
        j_build_model(jcfg, jprog, remat=False), qparams,
        jeng.EngineCfg(batch_slots=2, max_len=64, **page)), prompts)
    tpage = dict(page_pool=tpg.PagePoolCfg(16), prefill_chunk=chunk) \
        if chunk else {}
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                               device="cpu")
    assert [layer["attn"]["wq"].normal_dtype
            for layer in params["layers"]] == ["int8", "int4", "int4",
                                               "int8"]
    eng = teng.ServingEngine(t_build_model(tcfg, tprog), params,
                             teng.EngineCfg(batch_slots=2, max_len=64,
                                            backend="eager", **tpage),
                             device="cpu")
    assert ["k_data" in layer["kv"] for layer in eng.caches["layers"]] == \
        [True, False, False, True]
    assert _serve(eng, prompts) == ref
