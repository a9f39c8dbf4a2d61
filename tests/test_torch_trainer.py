"""The port's training runtime on the CPU: checkpoints
(`repro_torch.checkpoint.ckpt`) alone and across packages, the synthetic
corpus and the stateless loader against the reference's, the fault
primitives, the trainer's resume and preemption, and the launcher
(`repro_torch.launch.train`).

- Checkpoints: a round trip of fp32, bf16 (stored as its uint16 bits)
  and int32 leaves in dicts, lists and NamedTuples, bit for bit; a
  step directory without a manifest and a `.tmp_` leftover are ignored;
  `keep=3` keeps the newest three; an async save publishes when its
  thread joins, from a host snapshot taken before the thread started.
  A training state of `qwen1.5-0.5b-smoke` (the scanned layout, bf16
  moments holding data) written by the reference's `ckpt.save`
  restores in the port through the Trainer's path (a template on
  "meta", `convert.state_from_reference`), and the port's written by
  its Trainer's path (`convert.state_to_reference`) restores in the
  reference's `ckpt.restore`; every leaf bit for bit, the moments'
  bf16 bits included.
- Data: `_tables` and `bigram_entropy` equal the reference's exactly;
  the port's token stream (Philox, not JAX's threefry) is a walk on the
  same successor table; the loader is stateless (the same step gives
  the same batch in a fresh loader), ranks and the eval split are
  disjoint.
- The trainer on the reference's runtime-test config (`TINY`): six
  steps uninterrupted equal three, a checkpoint, and three resumed,
  loss for loss (exact: the CPU runs the same ops); a preemption saves
  the state it stopped at, which restores bit for bit.
- The launcher trains a smoke arch two steps under QAT on the CPU,
  refuses a `--mesh` whose ranks no process group runs, and without a
  card raises unless asked for the CPU.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.data import synthetic as jsyn
from repro.optim.adamw import AdamW as JAdamW
from repro.train.train_step import TrainState as JTrainState
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qlinear import tree_paths
from repro_torch.data import synthetic as tsyn
from repro_torch.data.loader import LoaderCfg, SyntheticLoader
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.runtime.fault import StepTimer, StragglerMonitor
from repro_torch.train import Trainer, TrainerCfg
from repro_torch.train.train_step import TrainState

from _torch_parity import shared_weights
from _torch_dist import one_torch_thread  # noqa: F401

TINY = ArchConfig(name="it-tiny", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                  head_dim=16, block_pattern=("attn",))
ARCH = "qwen1.5-0.5b-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn((3, 4), generator=g),
            "l": [torch.randn(5, generator=g).to(torch.bfloat16)],
            "s": AdamWState(step=torch.tensor(7, dtype=torch.int32),
                            mu={"m": torch.randn(2, generator=g)},
                            nu={})}


def _assert_trees_equal(got, want):
    got, want = ckpt.flatten(got), ckpt.flatten(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype, key
        assert torch.equal(got[key], w), key


def test_checkpoint_round_trip_bit_exact(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    out = ckpt.restore(str(tmp_path), 7, tree)
    assert isinstance(out["s"], AdamWState)
    _assert_trees_equal(out, tree)
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as data:
        assert data["l/0"].dtype == np.uint16


def test_incomplete_checkpoint_and_leftovers_ignored(tmp_path):
    ckpt.save(str(tmp_path), 3, {"a": torch.zeros(2)})
    broken = tmp_path / "step_00000009"
    broken.mkdir()
    (broken / "arrays.npz").write_bytes(b"junk")
    (tmp_path / ".tmp_abc").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_checkpoint_keeps_last_three(tmp_path):
    for s in range(6):
        ckpt.save(str(tmp_path), s, {"a": torch.zeros(2)}, keep=3)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4, 5]


def test_async_save_snapshots_before_the_thread(tmp_path):
    tree = {"a": torch.ones((128, 128))}
    th = ckpt.save(str(tmp_path), 1, tree, blocking=False)
    tree["a"].add_(1.0)          # an in-place update right after the call
    th.join()
    assert ckpt.latest_step(str(tmp_path)) == 1
    out = ckpt.restore(str(tmp_path), 1, tree)
    assert torch.equal(out["a"], torch.ones((128, 128)))


def _reference_state():
    """A reference TrainState of the smoke arch (scanned), its bf16
    moments filled with seeded values and its step at 5."""
    params = shared_weights(get_config(ARCH))[1]
    opt = JAdamW(moment_dtype=jnp.bfloat16).init(params)
    rng = np.random.default_rng(4)

    def fill(x):
        return jnp.asarray(rng.standard_normal(x.shape), jnp.bfloat16)

    opt = opt._replace(step=jnp.int32(5),
                       mu=jax.tree_util.tree_map(fill, opt.mu),
                       nu=jax.tree_util.tree_map(fill, opt.nu))
    return JTrainState(params, opt)


def _port_state(jstate):
    return convert.state_from_reference(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")


def _assert_states_equal(got: TrainState, want: TrainState):
    assert int(got.opt.step) == int(want.opt.step)
    for a, b in ((got.params, want.params), (got.opt.mu, want.opt.mu),
                 (got.opt.nu, want.opt.nu)):
        a, b = dict(tree_paths(a)), dict(tree_paths(b))
        assert sorted(a) == sorted(b)
        for path in b:
            assert a[path].dtype == b[path].dtype, path
            assert torch.equal(a[path], b[path]), path


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate = _reference_state()
    jckpt.save(str(tmp_path), 5, {"state": jstate}, blocking=True)
    cfg = get_config(ARCH)
    model = build_model(cfg, QuantPolicy(compute_dtype="float32"))
    opt = AdamW(moment_dtype=torch.bfloat16)
    trainer = Trainer(model, opt, None, TrainerCfg(ckpt_dir=str(tmp_path)),
                      log_fn=lambda s: None, device="cpu")
    trainer.init_or_restore()
    assert trainer.step == 5
    assert trainer.state.opt.mu["layers"][1]["attn"]["wq"].dtype == \
        torch.bfloat16
    _assert_states_equal(trainer.state, _port_state(jstate))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate = _reference_state()
    cfg = get_config(ARCH)
    trainer = Trainer(build_model(cfg, QuantPolicy()),
                      AdamW(moment_dtype=torch.bfloat16), None,
                      TrainerCfg(ckpt_dir=str(tmp_path), ckpt_async=False),
                      log_fn=lambda s: None, device="cpu")
    trainer.state, trainer.step = _port_state(jstate), 5
    trainer.save()
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    got = jckpt.restore(str(tmp_path), 5, {"state": zeros})["state"]
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(
            np.asarray(a).reshape(-1).view(np.uint8),
            np.asarray(b).reshape(-1).view(np.uint8))


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [tsyn.CorpusCfg(), tsyn.CorpusCfg(
    vocab=1000, seed=7, branch=3, temperature=0.5)], ids=["default", "other"])
def test_corpus_tables_and_entropy_equal_reference(cfg):
    jcfg = jsyn.CorpusCfg(vocab=cfg.vocab, seed=cfg.seed, branch=cfg.branch,
                          temperature=cfg.temperature)
    for got, want in zip(tsyn._tables(cfg), jsyn._tables(jcfg)):
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))
    assert tsyn.bigram_entropy(cfg) == jsyn.bigram_entropy(jcfg)


def test_tokens_walk_the_successor_table():
    cfg = tsyn.CorpusCfg()
    succ, _ = tsyn._tables(cfg)
    toks = tsyn.sample_batch(cfg, np.arange(40, 48), 64, 8)
    assert toks.shape == (8, 64) and toks.dtype == np.int64
    assert toks.min() >= 0 and toks.max() < cfg.vocab
    assert all(b in succ[a] for row in toks for a, b in zip(row, row[1:]))
    # stateless: one document alone is the same as inside a batch
    np.testing.assert_array_equal(
        tsyn.sample_batch(cfg, np.array([43]), 64, 1)[0], toks[3])


def _loader(batch=4, seq=32, vocab=256, ranks=1):
    return SyntheticLoader(LoaderCfg(global_batch=batch, seq_len=seq,
                                     n_ranks=ranks,
                                     corpus=tsyn.CorpusCfg(vocab=vocab)))


def test_loader_stateless_ranks_and_eval_disjoint():
    b1, b2 = _loader().global_batch_at(17), _loader().global_batch_at(17)
    assert b1["tokens"].dtype == torch.int64
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    two = _loader(batch=8, seq=16, ranks=2)
    assert not torch.equal(two.batch_at(0, 0)["tokens"],
                           two.batch_at(0, 1)["tokens"])
    lo = _loader()
    train_ids = {int(i) for s in range(50) for i in lo.doc_ids(s, 0)}
    eval_ids = {int(i) for s in range(50) for i in lo.doc_ids(s, 0, True)}
    assert not train_ids & eval_ids
    assert not torch.equal(lo.global_batch_at(0)["tokens"],
                           lo.global_batch_at(0, eval_split=True)["tokens"])


def test_fault_primitives():
    mon = StragglerMonitor(n_hosts=4, threshold=2.0)
    for _ in range(8):
        for h in range(4):
            mon.record(h, 0.1 if h != 2 else 0.5)
    assert mon.stragglers() == [2] and not mon.healthy()
    with StepTimer(mon, host=0, device="cpu") as t:
        pass
    assert t.last >= 0.0


# --------------------------------------------------------------------------
# the trainer and the launcher
# --------------------------------------------------------------------------
def _trainer(steps, ckpt_dir, every):
    model = build_model(TINY, QuantPolicy(compute_dtype="float32"),
                        remat=False)
    return Trainer(model, AdamW(lr=1e-3), _loader(),
                   TrainerCfg(total_steps=steps, ckpt_dir=ckpt_dir,
                              ckpt_every=every, ckpt_async=False,
                              log_every=1000),
                   log_fn=lambda s: None, device="cpu").init_or_restore()


def test_resume_matches_uninterrupted(tmp_path):
    full = _trainer(6, "", 0).run()
    d = str(tmp_path / "ck")
    _trainer(3, d, 3).run()
    resumed = _trainer(6, d, 3)
    assert resumed.step == 3
    assert resumed.run()["loss"] == full["loss"][3:]


def test_preemption_saves_state(tmp_path):
    d = str(tmp_path / "p")
    t = _trainer(50, d, 0)
    t.state, _ = t.step_fn(t.state, t.loader.global_batch_at(0))
    t.step = 1
    t.preempt.trigger()          # a simulated SIGTERM
    t.run()
    assert t.step < 50 and ckpt.latest_step(d) == t.step
    back = _trainer(50, d, 0)
    assert back.step == t.step
    _assert_states_equal(back.state, t.state)


def test_launcher_trains_a_smoke_arch_on_the_cpu(tmp_path):
    logs = []
    res = tlaunch.run(["--arch", ARCH, "--quant", "olive_w4a4",
                       "--steps", "2", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", str(tmp_path)], device="cpu",
                      log_fn=logs.append)
    assert res["policy"].qat and res["model"].remat
    assert len(res["history"]["loss"]) == 2
    assert all(np.isfinite(res["history"]["loss"]))
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert any("done: step 2" in line for line in logs)


def test_launcher_refuses_mesh_and_a_missing_card(monkeypatch):
    # --mesh trains (tests/test_torch_sharded_train.py); without a
    # process group of its size to join, it refuses before any weight
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tlaunch.run(["--arch", ARCH, "--mesh", "2x2"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.run(["--arch", ARCH])
