"""Serving launcher for the port, with the reference launcher's flags.

Builds `--arch` with random weights from `--seed`, applies OliVe PTQ
under the `--quant` preset, and runs the continuous-batching engine on a
synthetic request stream, on the CUDA device:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen1.5-0.5b --quant olive_serve

Any arch of `repro_torch.configs` (dense or MoE) is served the same way;
the weights are drawn and quantized one layer at a time, so the fp32
tree is never whole on the card (Qwen3-30B-A3B's is 122 GB, its W4 tree
about 17 GB; Qwen2-7B, Yi-6B and Minitron-8B serve at W4 with their
untied fp32 embedding and head):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-30b-a3b --quant olive_serve
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen2-7b --quant olive_serve

The baselines the paper compares against are presets too (`int8`,
`int4`: uniform int at an MSE-searched per-tensor scale; `ant4`: the
better of int4 and flint4 per tensor). They are fake-quant, as in the
reference: the weights stay dense fp32 holding the quantized values and
run through `torch.matmul`, over an fp32 KV cache. As in the reference's
scanned layout, each linear is fake-quantized over the stack of all its
layers at one scale, so a baseline builds the whole fp32 tree first:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen1.5-0.5b --quant int4

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
the calibration forward, so it does not stream either.

Mixed precision is a policy program (docs/policies.md): a program preset
in `--quant` (`olive_mixed_w48`: the first and last layers W8, the rest
W4; `olive_owq_style`: the attention q/k projections W8), and/or site
rules in front of it with `--policy-rules`, here packed 4-bit KV caches
on the first and last layer only:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen1.5-0.5b --quant olive_mixed_w48 --policy-rules \
      "layers/0/attn/kv=olive_serve,layers/23/attn/kv=olive_serve"

Async streaming serve (docs/serving.md): the asyncio front end drives
the same engine step, with a token stream per request (`--stream` prints
each token in the step that sampled it), TTFT/TPOT records per step, and
the JSONL metrics trace (`--metrics-out`, also in the drained loop):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen1.5-0.5b --quant olive_serve --paged 16 \
      --prefill-chunk 16 --async --stream --metrics-out build/trace.jsonl

As in the reference launcher, the preset (every rule of a program) is
rewritten to fp32 compute
(`compute_dtype="float32"`). Without `--calibration` activations are
left unquantized (`abits=0`), so `olive_serve` serves W4 OVP weights
over a 4-bit OVP KV cache; with it the preset keeps its `abits` and
resolves `act_scale_mode="static"`. There is no CPU switch: without a
card the launcher raises. `run(argv, device)` is the same path as a
function (the tests call it with device="cpu").
"""
from __future__ import annotations

import argparse
import asyncio
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import backends
from repro_torch.configs import get_config
from repro_torch.core.calibration import (CalibrationArtifact,
                                          apply_calibration, calibrate_model)
from repro_torch.core.policy import (PRESETS, PROGRAM_PRESETS, get_policy,
                                     get_program, parse_rules)
from repro_torch.core.qlinear import quantize_params, stacks_layers
from repro_torch.models.model import build_model
from repro_torch.serve import capture
from repro_torch.serve.engine import EngineCfg, ServingEngine
from repro_torch.serve.frontend import AsyncFrontend
from repro_torch.serve.metrics import MetricsLedger
from repro_torch.serve.paging import PagePoolCfg


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--quant", default="olive_w4",
                    choices=sorted(PRESETS) + sorted(PROGRAM_PRESETS),
                    help="PTQ policy or policy-program preset for the "
                         "weights/KV")
    ap.add_argument("--policy-rules", default=None,
                    help="extra site rules prepended to the program, "
                         "e.g. 'layers/0/*=olive_w8a8,*mlp*=olive_w4a4' "
                         "(see docs/policies.md)")
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
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="serve through the asyncio streaming front end "
                         "(serve/frontend.py): continuous intake, "
                         "per-request token streams, step-level TTFT/"
                         "TPOT SLO metrics (see docs/serving.md)")
    ap.add_argument("--stream", action="store_true",
                    help="async mode: print every token the step it is "
                         "sampled (one line per request completion too)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the step/request JSONL metrics trace "
                         "(serve/metrics.py vocabulary) to PATH; works "
                         "in both the drained loop and --async mode")
    ap.add_argument("--seed", type=int, default=0)
    return ap


async def _serve_async(eng, prompts, max_new, metrics, stream_tokens):
    """Drive the engine through the asyncio front end: submit every
    prompt, read each token stream as its tokens arrive (printing each
    token under --stream), and return the completed requests."""

    async def consume(stream):
        seen = 0
        async for tok in stream:
            if stream_tokens:
                tag = "first" if seen == 0 else f"+{seen}"
                print(f"[stream] uid={stream.uid} {tag} token={tok}")
            seen += 1
        if stream_tokens:
            print(f"[stream] uid={stream.uid} done "
                  f"({len(stream.tokens)} tokens, {stream.finish_reason})")

    async with AsyncFrontend(eng, metrics=metrics) as fe:
        streams = [fe.submit(p, max_new_tokens=max_new) for p in prompts]
        await asyncio.gather(*(consume(s) for s in streams))
    return list(eng.completed)


# the kernels' launch counters by name, and their reset (the counter list
# lives in `serve.capture`, which also keeps them true under replay)
kernel_launches = capture.launch_counts
reset_kernel_launches = capture.reset_launch_counts


def run(argv: Optional[List[str]] = None, device="cuda") -> Dict:
    """Build, (calibrate,) quantize and serve; returns the engine, model,
    params, artifact, the run's numbers (tokens, seconds, tok/s, TTFT,
    step time, calibration and PTQ seconds) and, under --async or
    --metrics-out, the metrics ledger's snapshot ("metrics")."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.calibrate and not args.calibration:
        ap.error("--calibrate needs --calibration PATH to save into")
    if args.prefill_chunk and not args.paged:
        ap.error("--prefill-chunk requires --paged (chunked prefill is a "
                 "paged-cache feature)")
    if args.stream and not args.use_async:
        ap.error("--stream requires --async (the drained loop has no "
                 "token streams)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.serve needs a CUDA device")
    cfg = get_config(args.arch)
    if args.quant in PROGRAM_PRESETS or args.policy_rules:
        policy = get_program(None if args.quant == "fp" else args.quant,
                             n_layers=cfg.n_layers)
        if args.policy_rules:
            policy = policy.with_rules(parse_rules(args.policy_rules))
    else:
        policy = get_policy(None if args.quant == "fp" else args.quant)
    # every rule of a program is rewritten, or the one flat policy;
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
    if args.calibrate or stacks_layers(policy, cfg.n_layers):
        # the whole fp32 tree first: calibration runs it, and a baseline
        # fake-quantizes each site over its stack of layers
        params = model.init(gen, device=device)
        if args.calibrate:
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
    metrics = MetricsLedger() if (args.metrics_out or args.use_async) \
        else None
    if args.use_async:
        t0 = time.perf_counter()
        done = asyncio.run(_serve_async(eng, prompts, args.max_new,
                                        metrics, args.stream))
    else:
        for p in prompts:
            eng.submit(p, max_new_tokens=args.max_new)
        t0 = time.perf_counter()
        done = eng.run_until_drained(metrics=metrics)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    if args.metrics_out:
        metrics.write_jsonl(args.metrics_out)
    return {"engine": eng, "model": model, "params": params,
            "policy": policy, "artifact": artifact, "calib_s": calib_s,
            "completed": done, "tokens": toks, "seconds": dt,
            "ptq_s": ptq_s, "tok_per_s": toks / dt,
            "mean_ttft_s": float(np.mean([r.t_first - r.t_submit
                                          for r in done])),
            "mean_latency_s": float(np.mean([r.t_done - r.t_submit
                                             for r in done])),
            "mean_step_s": dt / max(eng.steps_run, 1),
            "metrics": None if metrics is None else metrics.snapshot(),
            "metrics_out": args.metrics_out}


def _fmt_dist(d, digits: int = 1) -> str:
    if not d.get("n"):
        return "n=0"
    return (f"n={d['n']} mean={d['mean'] * 1e3:.{digits}f}ms "
            f"p50={d['p50'] * 1e3:.{digits}f}ms "
            f"p95={d['p95'] * 1e3:.{digits}f}ms")


def main():
    res = run()
    eng = res["engine"]
    art = res["artifact"]
    print(f"[serve] quantized-matmul backend(s): "
          f"{', '.join(sorted(res['policy'].backends()))}")
    if art is not None:
        how = (f"calibrated in {res['calib_s']:.1f}s" if res["calib_s"]
               else "loaded")
        print(f"[serve] {len(art.sites())} static scales {how}")
    print(f"[serve] PTQ in {res['ptq_s']:.1f}s")
    print(f"[serve] {len(res['completed'])} requests, {res['tokens']} "
          f"tokens in {res['seconds']:.2f}s ({res['tok_per_s']:.1f} tok/s)")
    print(f"[serve] mean latency {res['mean_latency_s'] * 1e3:.0f} ms")
    print(f"[serve] mean TTFT {res['mean_ttft_s'] * 1e3:.0f} ms, mean step "
          f"{res['mean_step_s'] * 1e3:.1f} ms")
    print(f"[serve] dispatch: {backends.dispatch_stats()}")
    attn = {k: v for k, v in backends.dispatch_stats().items()
            if "[decode_attn]" in k or "[prefill_attn]" in k}
    if attn:
        # a packed KV cache must show no fallback on the cuda backend
        print(f"[serve] attention dispatch: {attn}")
    if eng.paged:
        st = eng.stats()
        print(f"[serve] page pool: {st['page_pool']} "
              f"(prefill chunks: {st['prefill_chunks_run']})")
    if art is not None:
        # static serving resolves no activation scale dynamically
        print(f"[serve] act-scale resolutions: {backends.act_scale_stats()}")
    print("[serve] kernel launches: " + " ".join(
        f"{name}={n}" for name, n in kernel_launches().items()))
    snap = res["metrics"]
    if snap is not None:
        print(f"[serve] SLO: TTFT {_fmt_dist(snap['ttft_s'])} | "
              f"TPOT {_fmt_dist(snap['tpot_s'])}")
        print(f"[serve] {snap['steps']} steps, fallbacks={snap['fallbacks']}"
              + (f", interleave={snap['prefill_interleave_ratio']:.2f}"
                 if snap["prefill_interleave_ratio"] is not None else ""))
        if res["metrics_out"]:
            print(f"[serve] metrics trace -> {res['metrics_out']}")


if __name__ == "__main__":
    main()
