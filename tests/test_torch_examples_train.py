"""`examples_torch/train_e2e.py` through its `train()` function at a tiny
config on the CPU (2 layers, d_model 64, 4 x 32 tokens, 8 steps): the
simulated crash and restore against an uninterrupted run, and the
example's configs against the reference example's.

Tolerances: none. The restored run lands at half the steps, and its
final params, AdamW moments (bf16) and step equal an uninterrupted
run's bit for bit; the loss falls; `SMALL.param_count()` and
`BIG.param_count()` equal the reference's.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from examples_torch import train_e2e
from repro_torch.configs.base import ArchConfig
from repro_torch.core.qlinear import tree_paths
from repro_torch.train.trainer import Trainer, TrainerCfg

from _torch_dist import one_torch_thread  # noqa: F401

TINY = ArchConfig(name="e2e-tiny", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
                  block_pattern=("attn",))
STEPS, BATCH, SEQ = 8, 4, 32


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("e2e") / "ckpt")
    logs = []
    two = train_e2e.train(TINY, STEPS, ckpt, "cpu", global_batch=BATCH,
                          seq_len=SEQ, log=logs.append)
    model, opt, loader = train_e2e.parts(TINY, STEPS, BATCH, SEQ)
    one = Trainer(model, opt, loader,
                  TrainerCfg(total_steps=STEPS, n_microbatches=2,
                             log_every=10),
                  log_fn=logs.append, device="cpu").init_or_restore()
    one.run()
    return two, one.state, logs


def test_resume_lands_at_half(runs):
    two, _, logs = runs
    assert two["resumed"] == STEPS // 2
    assert len(two["h1"]["loss"]) == len(two["h2"]["loss"]) == STEPS // 2
    assert f"[trainer] restored step {STEPS // 2} from" in "\n".join(logs)


@pytest.mark.parametrize("part", ["params", "mu", "nu"])
def test_two_phase_run_bit_equal_to_an_uninterrupted_one(runs, part):
    two, one, _ = runs
    got = two["state"].params if part == "params" else \
        getattr(two["state"].opt, part)
    want = one.params if part == "params" else getattr(one.opt, part)
    gl, wl = tree_paths(got), tree_paths(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    if part != "params":
        assert all(g.dtype == torch.bfloat16 for _, g in gl)
    assert int(two["state"].opt.step) == int(one.opt.step) == STEPS


def test_loss_falls(runs):
    two, _, _ = runs
    assert two["last"] < two["first"]
    assert two["ppl"] > 1.0
    assert two["ok"] == (two["last"] < 0.7 * two["first"])


@pytest.mark.parametrize("name", ["SMALL", "BIG"])
def test_configs_match_the_reference_example(name):
    from examples import train_e2e as j_train_e2e
    want, got = getattr(j_train_e2e, name), getattr(train_e2e, name)
    assert got.param_count() == want.param_count()
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    assert {k: v for k, v in dataclasses.asdict(want).items()
            if k in fields} == dataclasses.asdict(got)
