"""Serving launcher for the port, with the reference launcher's flags.

Builds `--arch` with random weights from `--seed`, applies OliVe PTQ
under the `--quant` preset, and runs the continuous-batching engine on a
synthetic request stream, on the CUDA device:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen1.5-0.5b --quant olive_serve

Any decoder arch of `repro_torch.configs` (dense, MoE, hybrid, xLSTM or
the VLM InternVL2-1B, on its tokens alone, as the reference launcher
serves it) is served the same way; an encoder-decoder
(SeamlessM4T-large-v2) is refused before any weight is drawn, since the
engine feeds no encoder frames (run it through `Model.forward`). The
weights are drawn and quantized one layer at a time, so
the fp32 tree is never whole on the card (Qwen3-30B-A3B's is 122 GB,
its W4 tree about 17 GB; Qwen2-7B, Yi-6B, Minitron-8B and
RecurrentGemma-9B serve at W4 with their untied fp32 embedding and
head; RecurrentGemma-9B, whose local-attention caches are 2048-slot
rings and whose RG-LRU blocks carry a recurrent state, serves slab
only, each prompt prefilled at its exact length):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-30b-a3b --quant olive_serve
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen2-7b --quant olive_serve
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b --quant olive_serve

The baselines the paper compares against are presets too (`int8`,
`int4`: uniform int at an MSE-searched per-tensor scale; `ant4`: the
better of int4 and flint4 per tensor). They are fake-quant, as in the
reference: the weights stay dense fp32 holding the quantized values and
run through `torch.matmul`, over an fp32 KV cache. As in the reference's
scanned layout, each linear is fake-quantized at one scale over the
stack of its layers at one position of the block pattern (every layer
of a one-type pattern; a hybrid's or xLSTM's period position; the
layers past the last full period alone), so a baseline builds the whole
fp32 tree first:

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
static-scale kernel (K5). The calibration streams too: each layer, as
soon as it is drawn, takes the batch's hidden states forward, is
quantized and drops its fp32 weights
(`core.calibration.calibrate_streamed`), so the 7-8B configs and
Qwen3-30B-A3B calibrate on one card; the artifact is byte for byte the
one a whole fp32 tree gives:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen1.5-0.5b --quant olive_serve \
      --calibrate --calibration build/calib/qwen1.5-0.5b.json
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-30b-a3b --quant olive_serve \
      --calibrate --calibration build/calib/qwen3-moe-30b-a3b.json

Without `--calibrate`, `--calibration PATH` loads the artifact and
serves on it. A baseline preset builds the whole fp32 tree first
(below), and calibrates on it there.

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

Serving on a mesh (docs/sharding.md): `--mesh DATA,MODEL` runs one
process a rank under `torchrun`, and `--backend cuda_sharded` splits
every quantized matmul column-, row- or expert-parallel and every KV
cache by its KV heads over the MODEL ranks (`backends/sharded.py`); each
rank keeps only its shard of each layer as the layer is drawn. A DATA
axis above 1 replicates the work, as in the reference. Ranks that share
a card talk over gloo and run their steps eagerly:

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch qwen1.5-0.5b --quant olive_serve --backend cuda_sharded \
      --mesh 1,2

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
import torch.distributed as dist

from repro_torch import backends
from repro_torch.backends.sharded import place_params
from repro_torch.configs import get_config
from repro_torch.core.calibration import (CalibrationArtifact,
                                          apply_calibration, calibrate_model,
                                          calibrate_streamed)
from repro_torch.core.policy import (PRESETS, PROGRAM_PRESETS, get_policy,
                                     get_program, parse_rules)
from repro_torch.core.qlinear import quantize_params, stacks_layers
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import build_model
from repro_torch.runtime.elastic import MeshPlan
from repro_torch.serve import capture
from repro_torch.serve.engine import (EngineCfg, ServingEngine,
                                     check_pageable, check_servable)
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
                         "pass on a synthetic batch first, one layer at a "
                         "time as the weights are drawn, save the "
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
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="comma-separated mesh axis sizes for the sharded "
                         "backend, e.g. '1,2' for a (data=1, model=2) mesh "
                         "over 2 ranks (launch with `torchrun "
                         "--nproc-per-node 2`). Installs the mesh via "
                         "backends.configure_mesh, so --backend "
                         "cuda_sharded tensor/expert/KV-shards the "
                         "quantized serve path (see docs/sharding.md)")
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
    mesh = None
    if args.mesh:
        mesh, device = _mesh(ap, args.mesh, device)
    cfg = get_config(args.arch)
    check_servable(cfg)         # before any weight is drawn
    if args.paged:
        check_pageable(cfg)
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

    def quantize(tree, prefix, **kw):
        """PTQ of one piece, then this rank's shards of it."""
        nonlocal ptq_s
        sync()
        t0 = time.perf_counter()
        tree = quantize_params(tree, policy, prefix=prefix, **kw)
        sync()
        ptq_s += time.perf_counter() - t0
        return tree if mesh is None else place_params(tree, prefix, mesh)

    def calibration_batch():
        rng = np.random.default_rng(args.seed)
        return {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, size=(2, 64)), device=device)}

    if stacks_layers(policy, cfg.n_layers):
        # a baseline fake-quantizes each site over its stack of layers:
        # the whole fp32 tree first, calibrated on there
        params = model.init(gen, device=device)
        if args.calibrate:
            t0 = time.perf_counter()
            artifact = calibrate_model(model, params, [calibration_batch()])
            calib_s = time.perf_counter() - t0
            policy = apply_calibration(policy, artifact)
        params = quantize(params, "", period=len(cfg.block_pattern))
    elif args.calibrate:
        # each layer quantizes under the uncalibrated policy, before the
        # artifact exists: it changes only the activation side
        t0 = time.perf_counter()
        params, artifact = calibrate_streamed(
            model, gen, [calibration_batch()], device, quantize)
        calib_s = time.perf_counter() - t0 - ptq_s
        policy = apply_calibration(policy, artifact)
    else:
        params = model.init(gen, device=device, quantize=quantize)
    if args.calibrate:
        artifact.save(args.calibration)
        model = build_model(cfg, policy)

    page_pool = PagePoolCfg(page_size=args.paged) if args.paged else None
    eng = ServingEngine(model, params, EngineCfg(
        batch_slots=args.slots, max_len=args.max_len, page_pool=page_pool,
        prefill_chunk=args.prefill_chunk, mesh=mesh), device=device)
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
            "rank": 0 if mesh is None else mesh.rank,
            "outputs": {r.uid: list(r.out_tokens) for r in done},
            "dispatch": backends.dispatch_stats(),
            "launches": kernel_launches(),
            "shard_launches": backends.sharded.shard_launches(),
            "pool": eng.device_pool_stats(),
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


def _mesh(ap, spec: str, device: torch.device):
    """Parse `--mesh DATA,MODEL` (two positive sizes whose product is the
    world size), start the process group from `torchrun`'s environment
    if no group runs yet, and install the mesh. Returns (mesh, this
    rank's device)."""
    try:
        sizes = tuple(int(s) for s in spec.split(","))
    except ValueError:
        sizes = ()
    if len(sizes) != 2 or any(s < 1 for s in sizes):
        ap.error(f"--mesh wants two positive sizes 'data,model', got "
                 f"{spec!r}")
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        1)) > 1:
        device = mesh_lib.init_distributed(device.type)
    elif dist.is_initialized() and device.type == "cuda":
        device = mesh_lib.rank_device("cuda", int(os.environ.get(
            "LOCAL_RANK", dist.get_rank())))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if sizes[0] * sizes[1] != world:
        ap.error(f"--mesh {spec} needs {sizes[0] * sizes[1]} ranks, have "
                 f"{world}: launch with `torchrun --nproc-per-node "
                 f"{sizes[0] * sizes[1]}`")
    mesh = backends.configure_mesh(MeshPlan(sizes, ("data", "model"), 0))
    if mesh.rank == 0:
        print(f"[serve] mesh: data={sizes[0]} model={sizes[1]} over "
              f"{world} ranks ({mesh.backend or 'one process'})")
    return mesh, device


def _fmt_dist(d, digits: int = 1) -> str:
    if not d.get("n"):
        return "n=0"
    return (f"n={d['n']} mean={d['mean'] * 1e3:.{digits}f}ms "
            f"p50={d['p50'] * 1e3:.{digits}f}ms "
            f"p95={d['p95'] * 1e3:.{digits}f}ms")


def main():
    res = run()
    if res["rank"] == 0:            # rank 0 prints the summary
        _summary(res)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _summary(res):
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
    if backends.current_mesh() is not None:
        print(f"[serve] per-device pool: {res['pool']}")
        print(f"[serve] collectives: {mesh_lib.collective_stats()}")
        print(f"[serve] launches by shard layout: {res['shard_launches']}")


if __name__ == "__main__":
    main()
