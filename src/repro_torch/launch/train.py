"""Training launcher for the port, with the reference launcher's flags.

Builds `--arch` with random weights from `--seed`, and trains it on the
stateless synthetic corpus with the fault-tolerant trainer (AdamW with
bf16 moments and a cosine schedule, periodic async checkpoints,
preemption saves, held-out perplexity). `--quant` makes it QAT: the
preset with `qat` on, so every raw linear weight (and activation, when
the preset quantizes activations) takes STE fake-quant in the forward
pass (paper §3.4). Layers are rematerialized in the backward pass.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen1.5-0.5b --quant olive_w4a4 --steps 20 --batch 8 \\
      --seq 512 --ckpt-dir build/ckpt/run1

It runs on one CUDA device; `run(argv, device="cpu")` is the same path
as a function on the CPU (the tests call it so). Without a card and
without that switch it raises. `--mesh` is refused: multi-device
training waits in ROADMAP's multi-device queue.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.policy import PRESETS, get_policy
from repro_torch.data.loader import LoaderCfg, SyntheticLoader
from repro_torch.data.synthetic import CorpusCfg
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.trainer import Trainer, TrainerCfg


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="",
                    help="refused: multi-device training is not ported")
    ap.add_argument("--quant", default=None, choices=sorted(PRESETS),
                    help="QAT policy (STE fake-quant in the fwd pass)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(argv: Optional[List[str]] = None, device="cuda",
        log_fn=print) -> Dict:
    """Build and train; returns the trainer, its history, the final
    state's model and policy, and the held-out perplexity ("ppl", None
    when the launcher does not evaluate: fewer than 20 steps and no
    --eval-every)."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error("--mesh: multi-device training is not ported yet "
                 "(ROADMAP, the multi-device queue); run on one device")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.train needs a CUDA device")
    cfg = get_config(args.arch)
    policy = get_policy(args.quant)
    if policy.enabled:
        policy = dataclasses.replace(policy, qat=True)
    model = build_model(cfg, policy, remat=True)
    opt = AdamW(lr=cosine_schedule(args.lr, min(20, args.steps // 5),
                                   args.steps),
                moment_dtype=torch.bfloat16)
    loader = SyntheticLoader(LoaderCfg(
        global_batch=args.batch, seq_len=args.seq,
        corpus=CorpusCfg(vocab=cfg.vocab)))
    tcfg = TrainerCfg(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every,
                      eval_every=args.eval_every,
                      n_microbatches=args.microbatches, seed=args.seed)
    trainer = Trainer(model, opt, loader, tcfg, log_fn=log_fn,
                      device=device)
    trainer.init_or_restore()
    hist = trainer.run()
    if hist["loss"]:
        log_fn(f"[train] done: step {trainer.step}, "
               f"loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}")
    ppl = None
    if args.eval_every or args.steps >= 20:
        ppl = trainer.evaluate()
        log_fn(f"[train] held-out ppl: {ppl:.3f}")
    return {"trainer": trainer, "history": hist, "model": model,
            "policy": policy, "state": trainer.state, "ppl": ppl}


def main():
    run()


if __name__ == "__main__":
    main()
