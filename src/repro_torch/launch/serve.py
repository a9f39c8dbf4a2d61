"""Serving launcher for the port, with the reference launcher's flags.

Builds `--arch` with random weights from `--seed`, applies OliVe PTQ
under the `--quant` preset, and runs the continuous-batching engine on a
synthetic request stream, on the CUDA device:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen1.5-0.5b --quant olive_serve

Any arch of `repro_torch.configs` (dense or MoE) is served the same way;
the weights are drawn and quantized one layer at a time, so the fp32
tree is never whole on the card (Qwen3-30B-A3B's is 122 GB, its W4 tree
about 17 GB):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-30b-a3b --quant olive_serve

`--paged PAGE_SIZE` serves on the paged KV cache (a shared page pool and
block tables instead of the slab), and `--prefill-chunk N` splits each
prompt's prefill into chunks of N tokens interleaved with decode:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen1.5-0.5b --quant olive_serve --paged 16 --prefill-chunk 16

Static calibrated activation scales (paper §3.4): one command
calibrates on a synthetic (2, 64) batch drawn from `--seed`, saves the
artifact, and serves W4A4 on it, every quantized linear running the
static-scale kernel (K5):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen1.5-0.5b --quant olive_serve \
      --calibrate --calibration build/calib/qwen1.5-0.5b.json

Without `--calibrate`, `--calibration PATH` loads the artifact and
serves on it. `--calibrate` needs the whole fp32 tree on the device for
the calibration forward, so it is the one path that does not stream.

As in the reference launcher, the preset is rewritten to fp32 compute
(`compute_dtype="float32"`). Without `--calibration` activations are
left unquantized (`abits=0`), so `olive_serve` serves W4 OVP weights
over a 4-bit OVP KV cache; with it the preset keeps its `abits` and
resolves `act_scale_mode="static"`. There is no CPU switch: without a
card the launcher raises. `run(argv, device)` is the same path as a
function (the tests call it with device="cpu").
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import backends
from repro_torch.configs import get_config
from repro_torch.core.calibration import (CalibrationArtifact,
                                          apply_calibration, calibrate_model)
from repro_torch.core.policy import PRESETS, get_policy
from repro_torch.core.qlinear import quantize_params
from repro_torch.models.model import build_model
from repro_torch.serve import capture
from repro_torch.serve.engine import EngineCfg, ServingEngine
from repro_torch.serve.paging import PagePoolCfg


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--quant", default="olive_w4", choices=sorted(PRESETS),
                    help="PTQ policy preset for the weights/KV")
    ap.add_argument("--backend", default=None,
                    choices=backends.available(),
                    help="execution backend (default: the policy's, cuda)")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="CalibrationArtifact JSON: serve with static "
                         "calibrated activation scales "
                         "(act_scale_mode='static' on every quantized "
                         "site; see docs/calibration.md)")
    ap.add_argument("--calibrate", action="store_true",
                    help="calibrate-then-serve: run the §3.4 calibration "
                         "pass on a synthetic batch first, save the "
                         "artifact to --calibration PATH, then serve on "
                         "it (one command end to end)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--paged", type=int, default=0, metavar="PAGE_SIZE",
                    help="serve on the paged KV cache: a block-table page "
                         "pool with this page size instead of the (slots, "
                         "max_len) slab; prefill writes pages through the "
                         "fused cache-write kernel")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="paged mode: split long prompts into chunks of "
                         "this many tokens, interleaved with decode steps "
                         "(at most one chunk per step)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


# the kernels' launch counters by name, and their reset (the counter list
# lives in `serve.capture`, which also keeps them true under replay)
kernel_launches = capture.launch_counts
reset_kernel_launches = capture.reset_launch_counts


def run(argv: Optional[List[str]] = None, device="cuda") -> Dict:
    """Build, (calibrate,) quantize and serve; returns the engine, model,
    params, artifact and the run's numbers (tokens, seconds, tok/s, TTFT,
    step time, calibration and PTQ seconds)."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.calibrate and not args.calibration:
        ap.error("--calibrate needs --calibration PATH to save into")
    if args.prefill_chunk and not args.paged:
        ap.error("--prefill-chunk requires --paged (chunked prefill is a "
                 "paged-cache feature)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.serve needs a CUDA device")
    cfg = get_config(args.arch)
    policy = get_policy(None if args.quant == "fp" else args.quant)
    # a calibration artifact keeps the preset's abits: static scales
    # exist to serve quantized activations without per-step scale work
    if args.calibration:
        policy = policy.replace_all(compute_dtype="float32",
                                    act_scale_mode="static")
    else:
        policy = policy.replace_all(compute_dtype="float32", abits=0)
    if args.backend is not None:
        policy = policy.with_backend(args.backend)
    artifact, calib_s = None, 0.0
    if args.calibration and not args.calibrate:
        if not os.path.exists(args.calibration):
            ap.error(f"--calibration {args.calibration} does not exist; "
                     f"pass --calibrate to create it")
        artifact = CalibrationArtifact.load(args.calibration)
        policy = apply_calibration(policy, artifact)
    model = build_model(cfg, policy)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ptq_s = 0.0
    if args.calibrate:
        params = model.init(gen, device=device)
        rng = np.random.default_rng(args.seed)
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, size=(2, 64)), device=device)}
        t0 = time.perf_counter()
        artifact = calibrate_model(model, params, [batch])
        calib_s = time.perf_counter() - t0
        artifact.save(args.calibration)
        policy = apply_calibration(policy, artifact)
        model = build_model(cfg, policy)
        sync()
        t0 = time.perf_counter()
        params = quantize_params(params, policy)
        sync()
        ptq_s = time.perf_counter() - t0
    else:
        def quantize(tree, prefix):
            nonlocal ptq_s
            sync()
            t0 = time.perf_counter()
            tree = quantize_params(tree, policy, prefix=prefix)
            sync()
            ptq_s += time.perf_counter() - t0
            return tree

        params = model.init(gen, device=device, quantize=quantize)

    page_pool = PagePoolCfg(page_size=args.paged) if args.paged else None
    eng = ServingEngine(model, params, EngineCfg(
        batch_slots=args.slots, max_len=args.max_len, page_pool=page_pool,
        prefill_chunk=args.prefill_chunk), device=device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 32)))
               .astype(np.int32) for _ in range(args.requests)]
    for p in prompts:
        eng.submit(p, max_new_tokens=args.max_new)
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    return {"engine": eng, "model": model, "params": params,
            "artifact": artifact, "calib_s": calib_s,
            "completed": done, "tokens": toks, "seconds": dt,
            "ptq_s": ptq_s, "tok_per_s": toks / dt,
            "mean_ttft_s": float(np.mean([r.t_first - r.t_submit
                                          for r in done])),
            "mean_step_s": dt / max(eng.steps_run, 1)}


def main():
    res = run()
    eng = res["engine"]
    art = res["artifact"]
    if art is not None:
        how = (f"calibrated in {res['calib_s']:.1f}s" if res["calib_s"]
               else "loaded")
        print(f"[serve] {len(art.sites())} static scales {how}")
    print(f"[serve] PTQ in {res['ptq_s']:.1f}s")
    print(f"[serve] {len(res['completed'])} requests, {res['tokens']} "
          f"tokens in {res['seconds']:.2f}s ({res['tok_per_s']:.1f} tok/s)")
    print(f"[serve] mean TTFT {res['mean_ttft_s'] * 1e3:.0f} ms, mean step "
          f"{res['mean_step_s'] * 1e3:.1f} ms")
    print(f"[serve] dispatch: {backends.dispatch_stats()}")
    if eng.paged:
        st = eng.stats()
        print(f"[serve] page pool: {st['page_pool']} "
              f"(prefill chunks: {st['prefill_chunks_run']})")
    if art is not None:
        # static serving resolves no activation scale dynamically
        print(f"[serve] act-scale resolutions: {backends.act_scale_stats()}")
    print("[serve] kernel launches: " + " ".join(
        f"{name}={n}" for name, n in kernel_launches().items()))


if __name__ == "__main__":
    main()
