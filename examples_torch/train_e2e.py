"""End-to-end fault-tolerant training example on the port. Port of
`examples/train_e2e.py`.

Trains a dense GQA transformer on the synthetic corpus with the port's
trainer: microbatched gradient accumulation, bf16 moments, async
checkpointing, preemption-safe resume, straggler monitoring. A mid-run
"crash" is simulated and training resumes bit-exactly from the
checkpoint (the stateless loader replays the identical data stream).

The default model is the e2e-20m config; --model-100m selects e2e-100m
(98.7M parameters by `param_count`), the size the deliverable names.
Checkpoints go under the repo's `build/` unless --ckpt-dir names another
directory.

Run:  PYTHONPATH=src python examples_torch/train_e2e.py [--model-100m] \
          [--steps N]

Training reaches no hand-written kernel: the step is torch ops on the
card (the attention's FlashAttention-2 backward included).
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import Callable

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples_torch.fixture import check_device  # noqa: E402

from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.policy import QuantPolicy  # noqa: E402
from repro_torch.data.loader import LoaderCfg, SyntheticLoader  # noqa: E402
from repro_torch.data.synthetic import CorpusCfg  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamW, cosine_schedule  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerCfg  # noqa: E402

SMALL = ArchConfig(name="e2e-20m", family="dense", n_layers=6, d_model=256,
                   n_heads=8, n_kv_heads=4, d_ff=768, vocab=8192,
                   head_dim=32, block_pattern=("attn",))
BIG = ArchConfig(name="e2e-100m", family="dense", n_layers=12, d_model=512,
                 n_heads=8, n_kv_heads=4, d_ff=2048, vocab=50304,
                 head_dim=64, block_pattern=("attn",))
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "build", "olive_e2e_ckpt")


def parts(cfg: ArchConfig, steps: int, global_batch: int = 16,
          seq_len: int = 256):
    """The example's model (fp32, no remat), optimizer (AdamW, bf16
    moments, cosine schedule with 20 warm-up steps) and loader."""
    model = build_model(cfg, QuantPolicy(compute_dtype="float32"),
                        remat=False)
    opt = AdamW(lr=cosine_schedule(1e-3, 20, steps),
                moment_dtype=torch.bfloat16)
    loader = SyntheticLoader(LoaderCfg(
        global_batch=global_batch, seq_len=seq_len,
        corpus=CorpusCfg(vocab=cfg.vocab)))
    return model, opt, loader


def train(cfg: ArchConfig, steps: int, ckpt_dir: str, device="cuda",
          global_batch: int = 16, seq_len: int = 256,
          log: Callable[[str], None] = print) -> dict:
    """Phase 1 trains to steps // 2 with async checkpoints, then a fresh
    trainer restores the newest one and finishes (phase 2) and
    evaluates. Returns {"h1", "h2": the phases' histories, "resumed":
    phase 2's first step, "ppl", "first", "last", "ok": the verdict,
    "state": the final train state, "ckpt_seconds": each phase's}."""
    device = check_device(device, "examples_torch/train_e2e.py")
    if os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    model, opt, loader = parts(cfg, steps, global_batch, seq_len)
    half = steps // 2
    every = max(half // 2, 10)
    tcfg = TrainerCfg(total_steps=half, ckpt_dir=ckpt_dir, ckpt_every=every,
                      ckpt_async=True, log_every=10, n_microbatches=2)
    log(f"== phase 1: train to step {half}, then simulate a crash ==")
    t1 = Trainer(model, opt, loader, tcfg, log_fn=log,
                 device=device).init_or_restore()
    h1 = t1.run()

    log("== phase 2: fresh process restores the checkpoint and finishes ==")
    tcfg2 = TrainerCfg(total_steps=steps, ckpt_dir=ckpt_dir,
                       ckpt_every=every, ckpt_async=True, log_every=10,
                       n_microbatches=2, eval_every=0)
    t2 = Trainer(model, opt, loader, tcfg2, log_fn=log,
                 device=device).init_or_restore()
    resumed = t2.step
    assert resumed == half, f"resume step {resumed} != {half}"
    h2 = t2.run()

    ppl = t2.evaluate(n_batches=4)
    first, last = h1["loss"][0], h2["loss"][-1]
    return {"h1": h1, "h2": h2, "resumed": resumed, "ppl": ppl,
            "first": first, "last": last, "ok": last < 0.7 * first,
            "state": t2.state,
            "ckpt_seconds": (t1.ckpt_seconds, t2.ckpt_seconds)}


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-100m", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    args = ap.parse_args(argv)

    cfg = BIG if args.model_100m else SMALL
    steps = args.steps or (200 if args.model_100m else 120)
    print(f"arch {cfg.name}: ~{cfg.param_count()/1e6:.1f}M params, "
          f"{steps} steps")
    r = train(cfg, steps, args.ckpt_dir, device)
    print(f"loss {r['first']:.3f} -> {r['last']:.3f}; held-out ppl "
          f"{r['ppl']:.2f} (vocab {cfg.vocab}: random = {cfg.vocab})")
    print("OK: loss decreased through the simulated crash/restore"
          if r["ok"] else "WARN: loss did not improve enough")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
