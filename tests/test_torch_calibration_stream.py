"""The port's layer-streamed calibration (`calibrate_streamed`), on the
CPU at smoke size, a dense and a MoE arch: it draws the weights one
layer at a time, feeds every batch through each layer as it is drawn,
and quantizes it; its artifact must be byte for byte `calibrate_model`'s
on the whole tree from the same seed, at one batch and at two (where a
layer-major forward records the sites in another order than the whole
one, so the tape's draws are planned), and its params equal
`quantize_params` of the whole tree. The tape's host gather gives the
samples of a whole copy to the host, and the launcher's `--calibrate`
takes the streamed path, with one layer's fp32 weights alive at a time.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro_torch.configs import get_config
from repro_torch.core import calibration as tcal
from repro_torch.core import policy as tpol
from repro_torch.core.ovp import QuantizedTensor
from repro_torch.core.qlinear import quantize_params, tree_paths
from repro_torch.launch import serve
from repro_torch.models import model as model_mod
from repro_torch.models.model import block_forward, build_model

from _torch_dist import one_torch_thread  # noqa: F401

ARCHS = ("qwen1.5-0.5b-smoke", "qwen3-moe-30b-a3b-smoke")
# the launcher's policy under --calibrate
POLICY = tpol.OLIVE_SERVE.replace_all(compute_dtype="float32",
                                      act_scale_mode="static")
CAP = 1000      # below the smoke sites' sizes, so the tape draws


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many small torch ops, whose intra-op threads only
    contend with the suite's other workers: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(vocab: int, n: int):
    rng = np.random.default_rng(3)
    return [{"tokens": torch.as_tensor(rng.integers(0, vocab, (2, 16)))}
            for _ in range(n)]


def _assert_params_equal(got, want):
    got, want = tree_paths(got), tree_paths(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert type(a) is type(b), path
        if isinstance(a, QuantizedTensor):
            assert dataclasses.replace(a, data=None, scale=None) == \
                dataclasses.replace(b, data=None, scale=None), path
            assert torch.equal(a.data, b.data), path
            assert torch.equal(a.scale, b.scale), path
        else:
            assert torch.equal(a, b), path


@pytest.mark.parametrize("n_batches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_artifact_is_the_whole_tree_one(arch, n_batches, tmp_path):
    cfg = get_config(arch)
    model = build_model(cfg, POLICY)
    batches = _batches(cfg.vocab, n_batches)
    params = model.init(torch.Generator().manual_seed(7), device="cpu")
    whole = tcal.calibrate_model(model, params, batches, max_per_site=CAP)
    want_params = quantize_params(params,
                                  tcal.apply_calibration(POLICY, whole))
    del params
    got_params, streamed = tcal.calibrate_streamed(
        model, torch.Generator().manual_seed(7), batches, "cpu",
        lambda tree, prefix: quantize_params(tree, POLICY, prefix=prefix),
        max_per_site=CAP)
    paths = [whole.save(str(tmp_path / "whole.json")),
             streamed.save(str(tmp_path / "streamed.json"))]
    blobs = [open(p, "rb").read() for p in paths]
    assert blobs[0] == blobs[1]
    assert len(whole.sites()) == cfg.n_layers * (
        7 if cfg.family == "dense" else 4) + 1
    _assert_params_equal(got_params, want_params)


def test_two_batches_need_the_plan():
    """Without the plan, a layer-major feed of two batches draws other
    samples than the whole forward: the plan is what makes them equal."""
    cfg = get_config(ARCHS[0])
    model = build_model(cfg, POLICY)
    batches = _batches(cfg.vocab, 2)
    params = model.init(torch.Generator().manual_seed(7), device="cpu")
    whole = tcal.ActTape(max_per_site=CAP)
    with tcal.collecting_activations(whole):
        for batch in batches:
            model.forward(params, batch)
    sizes = tcal.SizeTape()
    with tcal.collecting_activations(sizes):
        for batch in batches:
            model.forward(params, batch)
    tapes = {"plain": tcal.ActTape(max_per_site=CAP),
             "planned": tcal.ActTape(max_per_site=CAP).plan(sizes.records)}
    pos = torch.arange(16)[None].expand(2, 16)
    for tape in tapes.values():
        hidden = [model.embed(params, batch["tokens"]) for batch in batches]
        with tcal.collecting_activations(tape):
            for i, block in enumerate(params["layers"]):   # layer-major
                hidden = [block_forward(block, x, pos, cfg, POLICY,
                                        site=f"layers/{i}")[0]
                          for x in hidden]
    site = "layers/0/attn/wq"
    assert np.array_equal(tapes["planned"].samples[site],
                          whole.samples[site])
    assert not np.array_equal(tapes["plain"].samples[site],
                              whole.samples[site])


def _whole_copy_record(tape, name, x):
    """The tape's record before the host gather: the whole tensor copied
    to the host, then subsampled."""
    flat = x.detach().to("cpu", torch.float32).numpy().reshape(-1)
    if flat.size > tape.max_per_site:
        flat = flat[tape.rng.choice(flat.size, tape.max_per_site,
                                    replace=False)]
    prev = tape.samples.get(name)
    if prev is not None:
        both = np.concatenate([prev, flat])
        if both.size > tape.max_per_site:
            both = both[tape.rng.choice(both.size, tape.max_per_site,
                                        replace=False)]
        tape.samples[name] = both
    else:
        tape.samples[name] = flat


def test_host_gather_samples_equal_the_whole_copy():
    """Tensors of float32 and bfloat16, contiguous or not, over and under
    the cap, a site recorded three times: the gather on the tensor's
    device gives the whole copy's samples and the reference tape's; a
    planned tape fed the same records in another site order too."""
    rng = np.random.default_rng(11)
    base = torch.from_numpy(rng.standard_normal((40, 60)).astype(np.float32))
    seq = [("a", base), ("b", base.T), ("a", base[:, :7]),
           ("c", base.to(torch.bfloat16)), ("b", base[:5]),
           ("a", base[::2, ::3].contiguous())]
    new, old = tcal.ActTape(max_per_site=300, seed=2), \
        tcal.ActTape(max_per_site=300, seed=2)
    ref = jcal.ActTape(max_per_site=300, seed=2)
    planned = tcal.ActTape(max_per_site=300, seed=2).plan(
        [(name, x.numel()) for name, x in seq])
    for name, x in seq:
        new.record(name, x)
        _whole_copy_record(old, name, x)
        ref.record(name, x.to(torch.float32).numpy())
    for name, x in sorted(seq, key=lambda r: r[0]):   # all of a, then b..
        planned.record(name, x)
    for site in ("a", "b", "c"):
        for tape in (old, planned):
            assert np.array_equal(new.samples[site], tape.samples[site])
        assert np.array_equal(new.samples[site],
                              np.asarray(ref.samples[site]))
    with pytest.raises(ValueError, match="plan"):
        planned.record("a", base)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_calibrate_streams_one_layer_at_a_time(arch, tmp_path,
                                                        monkeypatch):
    """`--calibrate` through the launcher: `calibrate_model` (the whole
    tree) never runs, every layer is quantized in order, and when each
    is, and when the next is drawn, the fp32 weights that quantization
    replaced in earlier layers are all gone: one drawn layer alive at a
    time, beside the embedding, the head and what stays fp32 to serve
    (norms, biases, the router)."""
    drawn, alive_at, alive_before_draw = [], [], []
    quantize, draw = serve.quantize_params, model_mod.block_params

    def alive():
        return sum(any(r() is not None for r in refs) for refs in drawn)

    def drawing(*args, **kw):
        alive_before_draw.append(alive())
        return draw(*args, **kw)

    def tracking(tree, policy, prefix=""):
        out = quantize(tree, policy, prefix=prefix)
        if prefix.startswith("layers/"):
            alive_at.append(1 + alive())
            drawn.append([weakref.ref(w) for (_, w), (_, q)
                          in zip(tree_paths(tree), tree_paths(out))
                          if q is not w])
        return out

    def whole_tree(*a, **k):
        raise AssertionError("--calibrate built the whole fp32 tree")

    monkeypatch.setattr(serve, "quantize_params", tracking)
    monkeypatch.setattr(model_mod, "block_params", drawing)
    monkeypatch.setattr(serve, "calibrate_model", whole_tree)
    res = serve.run(["--arch", arch, "--quant", "olive_serve",
                     "--requests", "2", "--max-new", "2", "--slots", "2",
                     "--max-len", "32", "--calibrate", "--calibration",
                     str(tmp_path / "c.json")], device="cpu")
    n = get_config(arch).n_layers
    assert len(drawn) == n and alive_at == [1] * n
    # the meta pass draws every layer first (no memory), then the stream
    assert alive_before_draw[n:] == [0] * n
    assert res["tokens"] == 4 and len(res["artifact"].sites()) > 0
