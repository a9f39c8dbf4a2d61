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
without that switch it raises.

`--mesh 1x2` (data, model) or `2x1x2` (pod, data, model) trains on a
mesh of that many ranks, one process each, over `torch.distributed`:

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch qwen1.5-0.5b --quant olive_w4a4 --steps 8 --mesh 1x2

The group starts from torchrun's environment, or from `run(...,
rank=, world_size=, init_method=)`, or is the one already running. The
step is `launch/specs.py::build_train_cell`'s at the `train_4k` shape
(whose global batch decides dp_only, as the reference's launcher
decides it), over the launcher's own model and optimizer: each rank
holds its parts of the params and AdamW moments under `param_spec`,
takes its rows of each global batch, and gathers each layer's weights
where it runs it (`train_step.make_sharded_train_step`). Rank 0 logs
and writes the checkpoints, in the one-device layout, so a run on one
mesh restores on another or on one device.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.policy import PRESETS, get_policy
from repro_torch.data.loader import LoaderCfg, SyntheticLoader
from repro_torch.data.synthetic import CorpusCfg
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.train.trainer import Trainer, TrainerCfg


def parse_mesh(s: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """'16x16' -> ((16, 16), (data, model)); '2x16x16' -> (pod, data,
    model)."""
    dims = tuple(int(d) for d in s.lower().split("x"))
    if not 1 <= len(dims) <= 3:
        raise ValueError(f"--mesh {s!r}: one to three sizes, e.g. 1x2")
    return dims, ("pod", "data", "model")[-len(dims):]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="",
                    help="e.g. 1x2 or 2x16x16; default single-device")
    ap.add_argument("--quant", default=None, choices=sorted(PRESETS),
                    help="QAT policy (STE fake-quant in the fwd pass)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(argv: Optional[List[str]] = None, device="cuda",
        log_fn=print, rank: Optional[int] = None,
        world_size: Optional[int] = None,
        init_method: Optional[str] = None) -> Dict:
    """Build and train; returns the trainer, its history, the final
    state's model and policy, and the held-out perplexity ("ppl", None
    when the launcher does not evaluate: fewer than 20 steps and no
    --eval-every). With --mesh, also the "mesh" and the "cell"
    (`specs.Cell`), and "state" is this rank's parts; ranks but 0 log
    nothing."""
    ap = parser()
    args = ap.parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.train needs a CUDA device")
    mesh = None
    if args.mesh:
        dims, names = parse_mesh(args.mesh)
        n = 1
        for d in dims:
            n *= d
        if not dist.is_initialized() and n > 1:
            if init_method is None and "MASTER_ADDR" not in os.environ:
                raise ValueError(
                    f"--mesh {args.mesh} needs {n} ranks and no process "
                    f"group runs: launch with `torchrun --nproc-per-node "
                    f"{n}`, or call run(..., rank=, init_method=)")
            device = mesh_lib.init_distributed(
                device.type, rank=rank,
                world_size=n if world_size is None else world_size,
                init_method=init_method)
        elif device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = mesh_lib.make_mesh(dims, names)
        if mesh.rank != 0:
            log_fn = _quiet
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
    cell = None
    if mesh is None:
        trainer = Trainer(model, opt, loader, tcfg, log_fn=log_fn,
                          device=device)
    else:
        from repro_torch.launch.specs import build_train_cell
        cell = build_train_cell(args.arch, "train_4k", mesh,
                                n_microbatches=args.microbatches,
                                model=model, optimizer=opt)
        log_fn(f"[train] mesh {mesh}: {cell.note}; each rank holds its "
               f"parts of the params and moments (param_spec)")
        trainer = Trainer(model, opt, loader, tcfg, log_fn=log_fn,
                          device=device, placement=cell.placement,
                          step_fn=cell.fn, eval_fn=cell.fn.evaluate)
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
            "policy": policy, "state": trainer.state, "ppl": ppl,
            "mesh": mesh, "cell": cell}


def _quiet(*_args, **_kw) -> None:
    pass


def main():
    run()


if __name__ == "__main__":
    main()
