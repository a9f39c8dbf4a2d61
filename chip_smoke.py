#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Run from the repo root on a machine with an NVIDIA H100 (sm_90a) and the
CUDA toolkit. It builds the hand-written kernels from
`src/repro_torch/csrc/` and then:

1. kernel phase — the attention and matmul kernels against their plain
   PyTorch version on the card, at the path's shapes (K1, the fused OVP
   matmul, int4 weights: rows 4 over the three (K, N) of a Qwen1.5-0.5B
   layer in fp and quantize mode and over a Qwen3-30B-A3B attention
   block in fp mode, and rows 8 to 512 of a Qwen1.5 layer with each of
   the kernel's two bodies forced; K2, slab decode attention: packed
   and fp caches, B=4, S=256, 16 heads, D=64, pos mixed, 0, 17 and 255,
   then held to the plain version with a window, a ring, a ring with a
   window and rows with no valid slot, and with its cluster split
   forced to each of 1, 2, 4 and 8 at five layouts), with
   errors against the stated tolerances and CUDA-event timings beside
   the plain version, a PyTorch library call and the bound; then the
   K1/K5 sweep: every activation mode with int4, flint4 and int8
   weights at rows 1, 3, 4, 8, 16, 31 and 128, through both bodies, at
   K 272 -> N 40, K 2816 -> N 1000, K 1040 -> N 1016 and K 1024 ->
   N 2816, against the plain version; the quantize modes at rows 4 with
   the cluster's shared quantization forced to each share; the
   wrappers' host cost per call (K1 and K2/K3); and one profiled call
   per served K1 mode and of K2 and K3, each of which must be one
   device kernel;
2. serve phase A — the main path through the serving entry point:
   full-width qwen1.5-0.5b, random weights from a seed, olive_serve
   rewritten as the launcher does (W4 OVP weights, 4-bit OVP KV cache,
   activations unquantized), 4 slots, max_len 256, 8 requests of 16 new
   tokens; kernel launch counters reset just before and read just after;
   then prefill + decode logits of the same model held against the same
   model run on the CPU through the plain versions; then async A: the
   same model and params through fresh engines driven by the asyncio
   front end (`AsyncFrontend` + `MetricsLedger`), slab and paged 16 with
   chunk 16, the launcher's workload: tokens equal to a drained run, the
   decode step captured on the front end's step thread, the JSONL trace
   read back equal, no fallback, TTFT and TPOT p50/p95 printed beside
   the card;
3. serve phase B — the same weights with 4-bit activations kept (W4A4 +
   KV4) through the engine API, 4 requests of 8 tokens, which puts K1's
   in-kernel quantize prologue on the path;
4. paged kernel phases — K3, paged decode attention (B=4, 16 pages of 16
   per row in a shuffled pool, Hkv=16, D=64, packed and fp, K2's
   positions, a parked row, and K2's mask cases with the ring at 200
   slots), against its plain version and bit-for-bit against K2 on the
   same tokens laid out as a slab; K4,
   fused cache-write prefill (C=16 and 64, S=256, packed and fp), output,
   page codes and scales against its plain version;
5. serve phase C — the paged path through the launcher's entry point
   (`--paged 16 --prefill-chunk 16`, the same 8 prompts and seed as
   phase A), launch counters reset just before and read just after;
   W4 over an fp32 paged cache, chunked paged prefill + 2 decode steps
   held against the slab path on the card; and one 200-token prompt
   prefilled in chunks of 64 beside 3 decoding requests, at most one
   chunk per step;
6. kernel phase for K5 (the static-scale matmul), K1's codes4 / codes8
   modes and K7 (the OVP encoder): rows 4 and 32, the three (K, N) of a
   layer, against their plain versions (K7 byte for byte), with times,
   bounds and `torch.matmul` on the dequantized operands; plus K7 ->
   codes4 against K5 at one scale; the K7 phase: the served KV write's
   shapes (R 64 x K 64 and R 16 x K 128, a scale a row) and a
   prefill-size API call (R 2048 x K 4096, one scalar scale), f32 and
   bf16, every scale kind (none, scalar, per row), the scalar path (K 6,
   an unaligned row base) and fp16, 0 bytes differing from the plain
   version, timed beside the plain version, the same encode as two
   launches (divide, then K7) and the byte bound; one KV encode through
   the cuda backend must be one device kernel; then every float32 bit
   pattern (NaNs excepted) through K7 against the plain version; and the
   API phase, the kernel API as a user calls it
   (`kernels.ops.ovp_encode` -> `ovp_matmul` / `matmul_w4a4`,
   `matmul_w8a8`), counters reset before and read after;
7. serve phase D — calibrate-then-serve through the launcher's entry
   point (`--calibrate --calibration build/calib/qwen1.5-0.5b.json`,
   phase A's prompts and seed), then again from the saved file, slab
   and paged: K5 launched, the dynamic quantize mode never, no dynamic
   scale resolution, no fallback; the static program over an fp32 KV
   cache on the card against the CPU's plain versions; and one decode
   step of phase B (dynamic 3-sigma scales) profiled beside one of
   phase D (static scales): wall, device busy and device kernels per
   step;
8. mixed A, after phases A-D's models are freed: mixed W4/W8 policy
   programs at full width through the launcher (`--quant
   olive_mixed_w48`, `--quant olive_owq_style`, and `olive_mixed_w48
   --policy-rules` with packed KV caches on the first and last layer
   only, slab and paged), K1's launches counted by weight dtype (14 or
   48 of 168 a forward call with int8 weights), one K2/K3 a layer a
   step over fp32 and packed caches alike, K7 only on packed layers,
   each program, slab and paged, against its CPU twin, the mixed-KV
   step profiled,
   K1 with int8 weights (fp and static) timed at the W8 layer, and one
   `--calibrate` run (K5 with 8-bit activations on the W8 layers); then
   the MoE slice: K2, K3 and K4 at
   Qwen3-30B-A3B's attention shapes (Hkv 4, G 8, D 128) with the same
   checks, K4 also timed by halves (attention blocks alone, page-write
   blocks alone) beside SDPA on the attention; the same three at the
   widened layouts (G 16 / D 256, G 7 / D 128, bf16 and fp16 fp caches
   and pools); the K6 kernel phase (the grouped per-expert matmul, fp
   mode, int4, with the fill of a seeded top-8 routing: decode B 4, E
   128, C 4 at K 2048 -> N 768 and K 768 -> N 2048, and a 16-token
   prefill chunk) against its plain version on the filled rows, timed
   with cold L2 (rotating over 4 layers' weight stacks) beside it,
   `torch.einsum` on the dequantized stack and the touched-expert
   bound; K6's other paths against the plain version (the FMA body
   forced on those fills, a fill of B 72 x E 128 entries, too many to
   cache in shared memory), and the decode launch with a fill touching
   one expert and none, each timed under half the whole stack's read
   time; K6 without a fill at E 8, 4-64 rows an expert, with each body
   forced, in fp, quantize and codes8 modes; and the K6 API phase (`kernels.ops.grouped_ovp_matmul` in
   quantize, static, codes4 packed by K7, and codes8 with int8 weights,
   at E 8, C 32, K = N = 1024, plus a per-expert mixed W4/W8 stack
   through `backends.dispatch`);
9. serve phase E: Qwen3-30B-A3B at full published width, 48 layers,
   through the launcher's entry point (`--arch qwen3-moe-30b-a3b
   --quant olive_serve`, phase A's prompts and seed, layer-by-layer
   init + PTQ), slab and then paged (`--paged 16 --prefill-chunk 16`),
   the slab model freed before the paged one loads:
   no fallback, `grouped[fp]` = 3 x layers x forward calls, K2 (slab),
   K3 and K4 (paged), every page returned; PTQ seconds, peak device
   memory, tok/s, TTFT, step time and decode-step profiles, slab and
   paged (K6's and K2's / K3's device ms per step, the device busy
   share); in phases A, C and E each attention kernel must have run
   once per layer per decode step (K2 or K3) or prefill chunk (K4), and
   in every serve phase (A-E) K7 twice per layer per forward call that
   wrote the packed KV cache through `cache_write` (decode steps and
   whole-prompt prefills: the served KV write packs K and V in one K7
   launch each); after phases A and C one decode step runs under
   `torch.cuda.set_sync_debug_mode("warn")` (the host syncs printed by
   place, none from the KV write) and the KV write alone under "error";
10. the MoE card-vs-CPU check on a 2-layer truncation of the served
   slab model (same widths and quantized params, fp32 KV): routed
   expert indices equal first, then greedy tokens equal and max |logit
   diff| <= 1e-3 * max|ref|;
11. mixed E: Qwen3-30B-A3B at full width, `MIXED_E_LAYERS` deep (cut
   from 48 for time), with `--policy-rules "*experts/*/[0-7]=
   olive_w8a8"`: every expert stack a two-group `MixedExpertQuant`, K6
   once per group per stack per forward call, the captured step's one
   host sync the token fetch, K6 on each group against the plain
   version, and the 2-layer card-vs-CPU check;
12. the dense 7-8B configs: K1 at one layer of Qwen2-7B, Yi-6B and
   Minitron-8B (7 decode launches at rows 4, each plan's split and
   slice printed) and Qwen2-7B's down projection (K 18944) at a
   32-row prefill, against the plain version, timed beside it,
   `torch.matmul` on the dequantized weight and the byte bound; then
   serve phase F: the three at full published width through the
   launcher's entry point (`--quant olive_serve`, the launcher's
   workload), slab, and Qwen2-7B also paged, the card freed between
   runs: no fallback, K1 once per quantized linear per forward call
   (none for the unquantized fp32 head), K2 (K3 and K4 paged) and K7 as
   in phase A, every page returned, the audit, graph against eager,
   each run's decode-step profile beside the step's byte bound
   (W4 blocks + fp32 head, from `param_count`), and a 2-layer
   card-vs-CPU check of each run (`truncated_reference_check`; paged
   over fp32 pools);
13. serve phase G: the baseline presets (`--quant int8 | int4 | ant4`)
   on full-width Qwen1.5-0.5B through the launcher: no OVP kernel (K1,
   K6, K7) launched, K2 once a layer a step over fp32 caches, the
   audit, graph against eager, and the card-vs-CPU logits check.

Every serve phase runs the engine's captured steps (CUDA graphs, the
default) and checks them: the trace audit (`audit_check`: the decode step
built once, one prefill entry per prompt bucket or paged stage length
seen, each captured, none evicted); graph against eager in the same
engine (`capture_gate`: decode steps of 4 slots from the same caches
through the graph and through the same step run eagerly,
bit-identical logits, 0 cache bytes differing, equal greedy tokens), in
phases A, B, C, D (load and paged) and E (slab and paged); the sync
check allows no host sync in a captured decode step but the token
fetch; and in phases A and E (slab) the launcher's workload is drained
by an eager twin of the served engine (`capture=False`) and by the
captured engine in turns eager, graph, graph, eager (`capture_ab`:
tok/s, mean TTFT, decode-step walls, peak memory, equal greedy tokens),
then both are profiled; `lru_check` evicts graphs at a prefill cache of
one entry (phase A's model, slab and paged), and `defrag_check` compacts
a paged pool under captured steps (phase C's model), with the tokens of
the run without compaction.

`attn_ab_phase(old_root)` (called by hand, not by `main`) times an
older tree's K2, K3 and K4 (and its K2/K3 wrappers' host cost) against
this one, alternated in separate
processes; `k7_ab_phase(old_root)` likewise times an older tree's
encode at the K7 phase's shapes and profiles one decode step of phase
A's and phase E's model (device kernels, busy and wall a step).

Any failure exits non-zero before the result line. The last line of
stdout is {"ok": true, "device": {...}}; the line before it lists every
kernel with its launches, error and times. Without a CUDA device (or
outside a checkout of the repo) it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ARCH = "qwen1.5-0.5b"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32, CUDA cores


def fail(msg: str) -> None:
    sys.exit(f"[chip_smoke] FAIL: {msg}")


def time_ms(fn, iters: int = 50, graph: bool = True):
    """(device ms, wall ms) per call. Device: `iters` calls captured in one
    CUDA graph and replayed between CUDA events, so host launch cost is
    out. Wall: CUDA events around the eager Python loop, host launch cost
    in. Operands stay resident in L2 between calls in both. `graph=False`
    (a function that copies from the host, which capture refuses)
    reports the wall time twice."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    if not graph:
        return wall, wall
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        for _ in range(iters):
            fn()
    cuda_graph.replay()
    torch.cuda.synchronize()
    start.record()
    cuda_graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, wall


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def within(got, ref, rtol: float, atol: float) -> bool:
    import torch
    return bool(torch.all((got - ref).abs() <= atol + rtol * ref.abs()))


# --------------------------------------------------------------------------
# Kernel phase
# --------------------------------------------------------------------------
# (K, N) of one Qwen1.5-0.5B layer (q/k/v/o, gate/up, down) and of one
# Qwen3-30B-A3B attention block (q, k/v, o): K1's decode launches
QWEN15_LAYER = [(1024, 1024)] * 4 + [(1024, 2816)] * 2 + [(2816, 1024)]
QWEN3_ATTN = [(2048, 4096)] + [(2048, 512)] * 2 + [(4096, 2048)]
BODY_ROWS = (8, 16, 32, 64, 128, 256, 512)   # both K1 bodies timed


def k1_phase(dev):
    """K1 against its plain version at the serving paths' shapes, timed
    beside the plain version, `torch.matmul` on the dequantized weight
    and the bound: rows 4 (decode) in fp and quantize mode over a
    Qwen1.5-0.5B layer and in fp mode over a Qwen3-30B-A3B attention
    block; rows 8-512 with each of the kernel's two bodies forced (the
    decode body against the FMA body it falls back to). The eager
    call's wall is the wrapper's host cost per call where that exceeds
    the kernel's device time (rows 4)."""
    import torch
    from repro_torch.core import policy
    from repro_torch.core.ovp import ovp_dequantize
    from repro_torch.core.qlinear import quantize_weight
    from repro_torch.core.quantizer import sigma_init_scale
    from repro_torch.kernels import ovp_matmul as mm

    gen = torch.Generator(device=dev).manual_seed(1)
    w4 = policy.OLIVE_W4.replace_all(compute_dtype="float32")
    weights = {}
    for k, n in sorted(set(QWEN15_LAYER + QWEN3_ATTN)):
        w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
        qt = quantize_weight(w, w4)
        weights[(k, n)] = (qt, ovp_dequantize(qt))
    keys = ("ms", "wall_ms", "plain_ms", "bound_ms", "library_ms")
    sums = {}                   # (label, rows, mode, body) -> summed times
    rows_out, worst, bound_by = [], 0.0, "bytes"
    plan = [(4, mode, "qwen1.5 layer", QWEN15_LAYER, (None,))
            for mode in ("fp", "quantize")]
    plan.append((4, "fp", "qwen3 attention", QWEN3_ATTN, (None,)))
    plan += [(rows, "fp", "qwen1.5 layer", QWEN15_LAYER, mm.BODIES)
             for rows in BODY_ROWS]
    for rows, mode, label, shapes, bodies in plan:
        for k, n in sorted(set(shapes)):
            qt, wd = weights[(k, n)]
            a = torch.randn((rows, k), generator=gen, device=dev)
            a_dtype = sa = None
            if mode == "quantize":
                a_dtype = "int4"
                sa = torch.broadcast_to(sigma_init_scale(a, "int4"),
                                        (rows,)).contiguous()
            sw = qt.scale.reshape(-1).contiguous()

            def plain():
                return mm.fused_ovp_matmul_plain(
                    a, sa, qt.data, sw, w_dtype="int4", a_mode=mode,
                    a_dtype="int4")

            ref = plain()
            (plain_ms, _) = time_ms(plain)
            lib_ms, _ = time_ms(lambda: torch.matmul(a, wd))
            n_bytes = rows * k * 4 + k // 2 * n + n * 4 + rows * n * 4 \
                + (rows * 4 if sa is not None else 0)
            b_ms, b_by = bound_ms(n_bytes, 2.0 * rows * k * n)
            for body in bodies:
                forced = None if body is None else mm.launch_plan(
                    rows, k, n, "int4", body, mode)

                def kern():
                    return mm.run(a, sa, qt.data, sw, w_dtype="int4",
                                  a_mode=mode, a_dtype=a_dtype, plan=forced)

                got = kern()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                scale = float(ref.abs().max())
                used = mm.launch_plan(rows, k, n, "int4", body, mode).body
                if not within(got, ref, 1e-5, 1e-5 * scale):
                    fail(f"K1 rows={rows} {mode} ({used} body) K={k} "
                         f"N={n}: max abs err {err:.3e} over tolerance "
                         f"(rtol 1e-5, atol 1e-5*{scale:.3e})")
                worst = max(worst, err)
                ms, wall = time_ms(kern)
                rec = dict(rows=rows, mode=mode, body=used, K=k, N=n,
                           max_abs_err=err, ms=ms, wall_ms=wall,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by)
                rows_out.append(rec)
                print(f"[k1] rows={rows:2d} {mode:8s} {used:6s} K={k:4d} "
                      f"N={n:4d} err={err:.2e} (tol rtol 1e-5, atol "
                      f"1e-5*max|ref|) kernel={ms:.4f}ms (eager call "
                      f"{wall:.4f}ms) plain={plain_ms:.4f}ms matmul="
                      f"{lib_ms:.4f}ms bound={b_ms:.5f}ms ({b_by})")
                tot = sums.setdefault((label, rows, mode, used),
                                      dict.fromkeys(keys, 0.0))
                for key in keys:
                    tot[key] += shapes.count((k, n)) * rec[key]
                if (rows, label) == (4, "qwen1.5 layer"):
                    bound_by = b_by
    launches = {"qwen1.5 layer": len(QWEN15_LAYER),
                "qwen3 attention": len(QWEN3_ATTN)}
    for (label, rows, mode, used), tot in sums.items():
        print(f"[k1 sum] {label} ({launches[label]} launches) rows={rows} "
              f"{mode} {used} body: kernel "
              f"{tot['ms']:.4f}ms (eager calls {tot['wall_ms']:.4f}ms) "
              f"matmul {tot['library_ms']:.4f}ms bound "
              f"{tot['bound_ms']:.5f}ms plain {tot['plain_ms']:.4f}ms")
    decode = {mode: sums[("qwen1.5 layer", 4, mode, "decode")]
              for mode in ("fp", "quantize")}
    decode["moe_attn"] = sums[("qwen3 attention", 4, "fp", "decode")]
    return rows_out, worst, decode, bound_by


# K2/K3 position cases: timed (pos 0, 17 and 255 for every row, and
# mixed), and mask cases held to the plain version only: a window, a
# ring (past one lap), a ring with a window, and rows with no valid slot
# (pos -1: the plain version averages V uniformly over all S slots)
POS_CASES = {"mixed": [0, 17, 255, 17], "0": [0] * 4, "17": [17] * 4,
             "255": [255] * 4}
MASK_CASES = (("window 40", [0, 17, 255, 100], 40, 0),
              ("ring 256", [17, 255, 300, 1000], 0, 256),
              ("ring 256 window 64", [17, 255, 300, 1000], 64, 256),
              ("no valid slot", [-1, 17, -1, 255], 0, 0))


def _attn_library(q, kdense, vdense, pos, g: int):
    """SDPA on the dense f32 K/V with the length mask: one PyTorch call
    computing K2/K3's function (no window or ring)."""
    import torch
    import torch.nn.functional as F
    s_len = kdense.shape[1]
    mask = (torch.arange(s_len, device=q.device)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    qh, kh, vh = (q.transpose(1, 2), kdense.transpose(1, 2),
                  vdense.transpose(1, 2))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                  attn_mask=mask,
                                                  enable_gqa=g > 1)


def k2_phase(dev, hkv: int = 16, g: int = 1, d: int = 64,
              fp_dtype: str = "float32", all_pos: bool = True):
    """K2 against its plain version at a serving path's shapes: Qwen1.5-
    0.5B's (Hkv 16, G 1, D 64) by default, Qwen3-30B-A3B's with Hkv 4,
    G 8, D 128, and the widened layouts (G 7 / 16, D 256, fp caches in
    `fp_dtype` bf16 or fp16), timed in `POS_CASES` beside the plain
    version, SDPA and the bound, and held to the plain version in
    `MASK_CASES`. `all_pos` False times the mixed positions only."""
    import torch
    from repro_torch.kernels import decode_attn as da
    from repro_torch.models.layers import _quant_kv_token

    gen = torch.Generator(device=dev).manual_seed(2)
    b, s_len = 4, 256
    h = hkv * g
    tag = f"Hkv={hkv} G={g} D={d}"
    q = torch.randn((b, 1, h, d), generator=gen, device=dev)
    k = torch.randn((b, s_len, hkv, d), generator=gen, device=dev)
    v = torch.randn((b, s_len, hkv, d), generator=gen, device=dev)
    kd, ks = _quant_kv_token(k)
    vd, vs = _quant_kv_token(v)
    fdt = getattr(torch, fp_dtype)
    caches = {"packed": {"k_data": kd, "v_data": vd, "k_scl": ks,
                         "v_scl": vs},
              "fp": {"k": k.to(fdt), "v": v.to(fdt)}}
    pos_cases = POS_CASES if all_pos else {"mixed": POS_CASES["mixed"]}
    rows_out, worst, main = [], 0.0, None
    for kind, cache in caches.items():
        if kind == "fp":
            kind = f"fp {fp_dtype}"
        kdense, vdense = da.read_cache_dense(cache, dtype=torch.float32)
        for name, pl in pos_cases.items():
            pos = torch.tensor(pl, dtype=torch.int32, device=dev)

            def kern():
                return da.fused_decode_attention(q, cache, pos)

            def plain():
                return da.decode_attention_plain(q, cache, pos)

            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not within(got, ref, 0.0, 1e-5):
                fail(f"K2 {tag} {kind} pos={pl}: max abs err {err:.3e} "
                     f"over atol 1e-5")
            worst = max(worst, err)
            library = _attn_library(q, kdense, vdense, pos, g)
            (ms, wall), (plain_ms, _), (lib_ms, _) = \
                time_ms(kern), time_ms(plain), time_ms(library)
            valid = int(sum(p + 1 for p in pl))   # slots the data needs
            per_tok = hkv * (d // 2 * 2 + 8) if kind == "packed" \
                else hkv * d * fdt.itemsize * 2
            n_bytes = 2 * b * h * d * 4 + b * 4 + valid * per_tok
            b_ms, b_by = bound_ms(n_bytes, 4.0 * valid * h * d)
            rec = dict(cache=kind, pos=pl, max_abs_err=err, ms=ms,
                       wall_ms=wall,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            rows_out.append(rec)
            if kind == "packed" and name == "mixed":
                main = rec
            print(f"[k2] {tag} {kind:6s} pos={pl} err={err:.2e} (tol atol "
                  f"1e-5) "
                  f"kernel={ms:.4f}ms (eager call {wall:.4f}ms) "
                  f"plain={plain_ms:.4f}ms sdpa={lib_ms:.4f}ms "
                  f"bound={b_ms:.5f}ms ({b_by})")
        for name, pl, window, ring in MASK_CASES:
            pos = torch.tensor(pl, dtype=torch.int32, device=dev)
            got = da.fused_decode_attention(q, cache, pos, window=window,
                                            ring=ring)
            ref = da.decode_attention_plain(q, cache, pos, window=window,
                                            ring=ring)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not within(got, ref, 0.0, 1e-5):
                fail(f"K2 {tag} {kind} {name} pos={pl}: max abs err "
                     f"{err:.3e} over atol 1e-5")
            worst = max(worst, err)
            print(f"[k2] {tag} {kind:6s} {name} pos={pl}: err={err:.2e} "
                  f"(tol atol 1e-5)")
    return rows_out, worst, main


def _paged_case(dev, packed: bool, parked: bool, gen, hkv: int = 16,
                g: int = 1, d: int = 64, fp_dtype: str = "float32"):
    """K3 inputs at the path's shapes: a slab of B=4 rows x 256 tokens
    scattered over a shuffled pool of 80 pages of 16 (plus garbage in the
    pages no row owns), its block table and positions. `parked` turns row
    3 into a parked engine slot (all-zero table row, pos = s_len)."""
    import torch
    from repro_torch.models.layers import _quant_kv_token
    b, n, ps, n_pool = 4, 16, 16, 80
    q = torch.randn((b, 1, hkv * g, d), generator=gen, device=dev)
    k = torch.randn((n_pool, ps, hkv, d), generator=gen, device=dev)
    v = torch.randn((n_pool, ps, hkv, d), generator=gen, device=dev)
    if packed:
        kd, ks = _quant_kv_token(k)
        vd, vs = _quant_kv_token(v)
        cache = {"k_data": kd, "v_data": vd, "k_scl": ks, "v_scl": vs}
    else:
        fdt = getattr(torch, fp_dtype)
        cache = {"k": k.to(fdt), "v": v.to(fdt)}
    perm = torch.randperm(n_pool, generator=gen, device=dev)[:b * n]
    bt = perm.reshape(b, n).to(torch.int32)
    pos = list(POS_CASES["mixed"])
    if parked:
        bt[3] = 0
        pos[3] = n * ps
    cache["block_table"] = bt
    return q, cache, torch.tensor(pos, dtype=torch.int32, device=dev), pos


def k3_phase(dev, hkv: int = 16, g: int = 1, d: int = 64,
              fp_dtype: str = "float32", all_pos: bool = True):
    """K3 against its plain version and, bit for bit, against K2 on the
    same tokens gathered into a slab (trimmed to the ring), shapes and
    `fp_dtype` as in `k2_phase`: timed in `POS_CASES` (mixed only when
    `all_pos` is False) and with a parked row (all-zero table row at pos
    = s_len, the whole range live), held to the plain version and K2 in
    `MASK_CASES` (the ring at 200 slots, not whole tiles, over the
    16-page rows)."""
    import torch
    from repro_torch.kernels import decode_attn as da
    gen = torch.Generator(device=dev).manual_seed(3)
    rows_out, worst, main = [], 0.0, None
    tag = f"Hkv={hkv} G={g} D={d}"
    pos_cases = POS_CASES if all_pos else {"mixed": POS_CASES["mixed"]}
    for kind in ("packed", f"fp {fp_dtype}"):
        q, cache, _, _ = _paged_case(dev, kind == "packed", False, gen,
                                     hkv, g, d, fp_dtype)
        _, parked, parked_pos, parked_pl = _paged_case(
            dev, kind == "packed", True, gen, hkv, g, d, fp_dtype)
        cases = [(name, cache, pl, 0, 0, True)
                 for name, pl in pos_cases.items()]
        cases.append(("parked", parked, parked_pl, 0, 0, True))
        cases += [(name, cache, pl, w, 200 if r else 0, False)
                  for name, pl, w, r in MASK_CASES]
        for name, cc, pl, window, ring, timed in cases:
            pos = torch.tensor(pl, dtype=torch.int32, device=dev)
            slab = da._slab_view(cc, ring)

            def kern():
                return da.fused_paged_decode_attention(q, cc, pos,
                                                       window=window,
                                                       ring=ring)

            def plain():
                return da.decode_attention_plain(q, cc, pos, window=window,
                                                 ring=ring)

            got, ref, k2 = kern(), plain(), da.fused_decode_attention(
                q, slab, pos, window=window, ring=ring)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            what = f"K3 {tag} {kind} {name} pos={pl}" + (
                f" window={window} ring={ring}" if window or ring else "")
            if not within(got, ref, 0.0, 1e-5):
                fail(f"{what}: max abs err {err:.3e} over atol 1e-5")
            if not torch.equal(got, k2):
                fail(f"{what}: not bit-identical to K2 on the same tokens as "
                     f"a slab (max diff "
                     f"{float((got - k2).abs().max()):.3e})")
            worst = max(worst, err)
            if not timed:
                print(f"[k3] {what}: err={err:.2e} (tol atol 1e-5), "
                      f"bit-identical to K2 on the slab: yes")
                continue
            kdense, vdense = da.read_cache_dense(cc, dtype=torch.float32)
            s_len = kdense.shape[1]
            library = _attn_library(q, kdense, vdense, pos, g)
            (ms, wall), (plain_ms, _), (lib_ms, _) = \
                time_ms(kern), time_ms(plain), time_ms(library)
            b, h = q.shape[0], q.shape[2]
            valid = int(sum(min(p + 1, s_len) for p in pl))
            per_tok = hkv * (d // 2 * 2 + 8) if kind == "packed" \
                else hkv * d * cc["k"].element_size() * 2
            n_bytes = 2 * b * h * d * 4 + b * 4 + cc["block_table"] \
                .numel() * 4 + valid * per_tok
            b_ms, b_by = bound_ms(n_bytes, 4.0 * valid * h * d)
            rec = dict(cache=kind, pos=pl, max_abs_err=err, ms=ms,
                       wall_ms=wall, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
            rows_out.append(rec)
            if kind == "packed" and name == "mixed":
                main = rec
            print(f"[k3] {tag} {kind:6s} pos={pl} err={err:.2e} (tol atol "
                  f"1e-5) "
                  f"bit-identical to K2 on the slab: yes "
                  f"kernel={ms:.4f}ms (eager call {wall:.4f}ms) "
                  f"plain={plain_ms:.4f}ms sdpa={lib_ms:.4f}ms "
                  f"bound={b_ms:.5f}ms ({b_by})")
    return rows_out, worst, main


def k23_split_phase(dev):
    """K2 with its cluster split forced to each of 1, 2, 4 and 8 (and
    the buffer count that split needs) at the served shapes and at G 2 /
    D 64, G 16 / D 256 and G 3 / D 40, packed and fp32, pos mixed and
    with no valid slot, against the plain version (atol 1e-5): the plan
    picks one split per shape, this holds the kernel at every split it
    can pick. Returns the worst error."""
    import dataclasses

    import torch
    from repro_torch.kernels import decode_attn as da
    from repro_torch.models.layers import _quant_kv_token
    gen = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    for hkv, g, d in ((16, 1, 64), (4, 8, 128), (8, 2, 64), (1, 16, 256),
                      (4, 3, 40)):
        q = torch.randn((4, 1, hkv * g, d), generator=gen, device=dev)
        k = torch.randn((4, 256, hkv, d), generator=gen, device=dev)
        v = torch.randn((4, 256, hkv, d), generator=gen, device=dev)
        kd, ks = _quant_kv_token(k)
        vd, vs = _quant_kv_token(v)
        for cache in ({"k_data": kd, "v_data": vd, "k_scl": ks,
                       "v_scl": vs}, {"k": k, "v": v}):
            fp = None if "k_data" in cache else torch.float32
            base = da.decode_plan(4, 256, hkv * g, hkv, d, fp)
            for pl in (POS_CASES["mixed"], [-1, 100, 200, 31]):
                pos = torch.tensor(pl, dtype=torch.int32, device=dev)
                ref = da.decode_attention_plain(q, cache, pos)
                errs = []
                for split in (1, 2, 4, 8):
                    tpr = -(-base.tiles // split)
                    nbuf = 2 if tpr > 1 else 1
                    plan = dataclasses.replace(
                        base, split=split, tpr=tpr, nbuf=nbuf,
                        smem=da._smem(base.g, d, base.kind, nbuf))
                    got = da._launch(q, cache, pos, window=0, ring=0,
                                     plan=plan)
                    torch.cuda.synchronize()
                    errs.append(float((got - ref).abs().max()))
                    if errs[-1] > 1e-5:
                        fail(f"K2 Hkv={hkv} G={g} D={d} split {split} "
                             f"{'packed' if fp is None else 'fp32'} pos={pl}:"
                             f" max abs err {errs[-1]:.3e} over atol 1e-5")
                worst = max(worst, *errs)
                print(f"[k2 split] Hkv={hkv} G={g} D={d} "
                      f"{'packed' if fp is None else 'fp32'} pos={pl}: "
                      f"splits 1/2/4/8 err "
                      + " / ".join(f"{e:.2e}" for e in errs)
                      + f" (tol atol 1e-5; the plan picks {base.split})")
    return worst


def _prefill_case(dev, packed: bool, c: int, gen, hkv: int = 16,
                  g: int = 1, d: int = 64, pool_dtype: str = "float32"):
    """K4 inputs: a 256-token raw stage (Hkv 16, D 64 by default) of one
    request whose 16 page tiles map to shuffled pages of a 40-page pool
    holding random old bytes, and the chunk of C queries (Hkv * G heads)
    at offset 256 - C."""
    import torch
    s, ps, n_pool = 256, 16, 40
    if packed:
        cache = {key: torch.randint(0, 256, (n_pool, ps, hkv, d // 2),
                                    generator=gen, device=dev,
                                    dtype=torch.uint8)
                 for key in ("k_data", "v_data")}
        cache.update({key: torch.rand((n_pool, ps, hkv), generator=gen,
                                      device=dev)
                      for key in ("k_scl", "v_scl")})
    else:
        cache = {key: torch.randn((n_pool, ps, hkv, d), generator=gen,
                                  device=dev).to(getattr(torch, pool_dtype))
                 for key in ("k", "v")}
    pages = torch.randperm(n_pool, generator=gen, device=dev)[:s // ps]
    cache["block_table"] = pages[None].to(torch.int32)
    for key in ("stage_k", "stage_v"):
        cache[key] = torch.randn((1, s, hkv, d), generator=gen, device=dev)
    q = torch.randn((1, c, hkv * g, d), generator=gen, device=dev)
    positions = torch.arange(s - c, s, device=dev)[None]
    return q, cache, positions


def k4_phase(dev, hkv: int = 16, g: int = 1, d: int = 64,
             pool_dtype: str = "float32", cs=(16, 64)):
    """K4 against its plain version: output, page codes and scales (fp
    pools in `pool_dtype`: equal to the plain version's rounding), and
    the pages outside the table untouched (shapes as in `k2_phase`), at
    chunk lengths `cs`. The kernel splits each row tile's keys over a
    cluster and combines the ranks' (m, l, o) partials in rank order (M
    = max m, o = sum o_r exp(m_r - M) / sum l_r exp(m_r - M)), so its
    output differs from the plain version's one softmax in fp32 rounding
    only: atol 1e-5. Timed as a whole and by halves: the attention
    blocks alone (beside SDPA on the same attention) and the page-write
    blocks alone."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import prefill_attn as pa
    gen = torch.Generator(device=dev).manual_seed(4)
    rows_out, worst, main = [], 0.0, None
    tag = f"Hkv={hkv} G={g} D={d}"
    for kind in ("packed", f"fp {pool_dtype}"):
        for c in cs:
            q, cache, positions = _prefill_case(dev, kind == "packed", c,
                                                gen, hkv, g, d, pool_dtype)
            keys = pa._pool_keys(cache)
            before = {key: cache[key].clone() for key in keys}
            ref_cache = dict(cache, **{key: before[key].clone()
                                       for key in keys})

            def kern():
                return pa.fused_prefill_attention(q, cache, positions)[0]

            def plain():
                return pa.prefill_attention_plain(q, ref_cache,
                                                  positions)[0]

            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if not within(got, ref, 0.0, 1e-5):
                fail(f"K4 {tag} {kind} C={c}: max abs err {err:.3e} over "
                     f"atol 1e-5")
            worst = max(worst, err)
            pages = cache["block_table"][0].long()
            other = torch.ones(cache[keys[0]].shape[0], dtype=torch.bool,
                               device=dev)
            other[pages] = False
            code_diff, code_total = 0, 0
            for key in keys:
                new, want = cache[key], ref_cache[key]
                if not torch.equal(new[other], before[key][other]):
                    fail(f"K4 {tag} {kind} C={c}: {key} changed a page "
                         f"outside the request's table")
                if new.dtype == torch.uint8:
                    code_diff += int((new != want).sum())
                    code_total += new[pages].numel()
                elif kind == "packed" and not within(new, want, 1e-6, 0.0):
                    fail(f"K4 {tag} {kind} C={c}: {key} scales over rtol "
                         f"1e-6 "
                         f"(max rel "
                         f"{float(((new - want).abs() / want).max()):.2e})")
                elif kind != "packed" and not torch.equal(new, want):
                    fail(f"K4 {tag} {kind} C={c}: {key} pages not "
                         f"written as the plain version rounds them")
            if code_diff > 1e-4 * max(code_total, 1):
                fail(f"K4 {tag} {kind} C={c}: {code_diff} of {code_total} "
                     f"code bytes differ from the plain version (limit "
                     f"0.01%)")
            s = cache["stage_k"].shape[1]
            h = q.shape[2]
            off = s - c
            mask = (torch.arange(s, device=dev)[None, :]
                    <= (off + torch.arange(c, device=dev))[:, None])
            qh = q.transpose(1, 2)
            kh, vh = (cache[key].transpose(1, 2)
                      for key in ("stage_k", "stage_v"))

            def library():
                return F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, enable_gqa=g > 1)

            # the plain version's OVP encode copies a constant from the
            # host, which graph capture refuses: it is timed eagerly
            (ms, wall), (plain_ms, _), (lib_ms, _) = \
                time_ms(kern), time_ms(plain, graph=False), time_ms(library)
            attn_ms, _ = time_ms(lambda: pa._launch(q, cache, positions,
                                                    halves=1))
            write_ms, _ = time_ms(lambda: pa._launch(q, cache, positions,
                                                     halves=2))
            page_bytes = 2 * s * hkv * ((d // 2 + 4) if kind == "packed"
                                        else d * cache["k"].element_size())
            n_bytes = 2 * s * hkv * d * 4 + page_bytes + 2 * c * h * d * 4 \
                + (s // 16) * 4 + 4
            n_ops = 4.0 * h * d * sum(off + i + 1 for i in range(c))
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            rec = dict(cache=kind, C=c, max_abs_err=err, ms=ms, wall_ms=wall,
                       attn_ms=attn_ms, write_ms=write_ms,
                       plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by, code_bytes_differ=code_diff)
            rows_out.append(rec)
            if kind == "packed" and c == 16:
                main = rec
            print(f"[k4] {tag} {kind:6s} C={c:2d} S={s} off={off} "
                  f"err={err:.2e} "
                  f"(tol atol 1e-5) code bytes differing {code_diff}/"
                  f"{code_total} (limit 0.01%) scales rtol 1e-6 ok "
                  f"kernel={ms:.4f}ms (eager call {wall:.4f}ms; halves "
                  f"apart: attention {attn_ms:.4f}ms, page writes "
                  f"{write_ms:.4f}ms) "
                  f"plain={plain_ms:.4f}ms (eager) sdpa(attention half only)="
                  f"{lib_ms:.4f}ms bound={b_ms:.5f}ms ({b_by})")
    return rows_out, worst, main


def _attn_inputs(dev, kernel: str, hkv: int, g: int, d: int,
                 fp_dtype=None, pos: str = "mixed"):
    """The call `attn_time` and `attn_host_phase` make: K2 over a slab or
    K3 over a shuffled pool (`k3_phase`'s) at `POS_CASES[pos]`, or K4 at
    `k4_phase`'s first case (C 16); packed, or fp in `fp_dtype`. Uses
    only the wrappers every version of the port has, so it also drives
    an older tree's kernels (import this script with that tree's `src`
    first on the path)."""
    import torch
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import prefill_attn as pa
    from repro_torch.models.layers import _quant_kv_token
    gen = torch.Generator(device=dev).manual_seed(4)
    if kernel == "K4":
        q, cache, positions = _prefill_case(dev, True, 16, gen, hkv, g, d)
        return lambda: pa.fused_prefill_attention(q, cache, positions)[0]
    rows = torch.tensor(POS_CASES[pos], dtype=torch.int32, device=dev)
    if kernel == "K3":
        q, cache, _, _ = _paged_case(dev, fp_dtype is None, False, gen,
                                     hkv, g, d, fp_dtype or "float32")
        return lambda: da.fused_paged_decode_attention(q, cache, rows)
    q = torch.randn((4, 1, hkv * g, d), generator=gen, device=dev)
    kv = [torch.randn((4, 256, hkv, d), generator=gen, device=dev)
          for _ in range(2)]
    if fp_dtype is None:
        kv = [_quant_kv_token(x) for x in kv]
        cache = {"k_data": kv[0][0], "k_scl": kv[0][1],
                 "v_data": kv[1][0], "v_scl": kv[1][1]}
    else:
        cache = {"k": kv[0].to(getattr(torch, fp_dtype)),
                 "v": kv[1].to(getattr(torch, fp_dtype))}
    return lambda: da.fused_decode_attention(q, cache, rows)


def attn_time(dev, kernel: str, hkv: int, g: int, d: int, reps: int = 3,
              fp_dtype=None, pos: str = "mixed"):
    """K2's, K3's or K4's device time (ms, `reps` CUDA-graph replays of
    50 launches) on `_attn_inputs`' call."""
    fn = _attn_inputs(dev, kernel, hkv, g, d, fp_dtype, pos)
    return [time_ms(fn)[0] for _ in range(reps)]


def split_sweep_phase(dev, shapes=((16, 1, 64), (4, 8, 128), (1, 16, 256)),
                      pos_cases=("0", "17", "46", "255", "mixed")):
    """K2's device time with its cluster split forced to each of 1, 2, 4
    and 8, packed and over a bf16 cache, at `shapes` (Hkv, G, D) and the
    positions `pos_cases` (`POS_CASES`, plus "46", the longest row of
    phase A's traffic, two live tiles): what the plan's choice of split
    trades between short rows (one rank's chain, the larger cluster's
    launch) and long ones (split tiles). Called by hand, not by
    `main`."""
    import dataclasses

    import torch
    from repro_torch.kernels import decode_attn as da
    from repro_torch.models.layers import _quant_kv_token
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = dict(POS_CASES, **{"46": [46] * 4})
    for hkv, g, d in shapes:
        q = torch.randn((4, 1, hkv * g, d), generator=gen, device=dev)
        k = torch.randn((4, 256, hkv, d), generator=gen, device=dev)
        v = torch.randn((4, 256, hkv, d), generator=gen, device=dev)
        kd, ks = _quant_kv_token(k)
        vd, vs = _quant_kv_token(v)
        for name, cache in (("packed", {"k_data": kd, "v_data": vd,
                                        "k_scl": ks, "v_scl": vs}),
                            ("bf16", {"k": k.bfloat16(),
                                      "v": v.bfloat16()})):
            base = da.decode_plan(4, 256, hkv * g, hkv, d,
                                  None if name == "packed"
                                  else torch.bfloat16)
            for pc in pos_cases:
                pos = torch.tensor(cases[pc], dtype=torch.int32, device=dev)
                ms = []
                for split in (1, 2, 4, 8):
                    tpr = -(-base.tiles // split)
                    nbuf = 2 if tpr > 1 else 1
                    plan = dataclasses.replace(
                        base, split=split, tpr=tpr, nbuf=nbuf,
                        smem=da._smem(base.g, d, base.kind, nbuf))
                    ms.append(min(time_ms(
                        lambda: da._launch(q, cache, pos, window=0, ring=0,
                                           plan=plan))[0]
                        for _ in range(3)))
                print(f"[k2 sweep] Hkv={hkv} G={g} D={d} {name} pos="
                      f"{cases[pc]}: split 1/2/4/8 "
                      + " ".join(f"{x:.4f}" for x in ms)
                      + f" ms (min of 3 replays; the plan picks "
                        f"{base.split})")


def attn_host_phase(dev, reps: int = 5, calls: int = 1000):
    """K2's and K3's wrapper host cost per call, packed at Qwen1.5-0.5B's
    decode shape (Hkv 16, G 1, D 64), measured as `wrapper_host_phase`
    measures K1's: `calls` eager calls on the host clock with no sync
    between them, median of `reps` (the device time is below the host's,
    so the clock reads the host). Returns {kernel: us per call}."""
    import torch
    out = {}
    for kernel in ("K2", "K3"):
        fn = _attn_inputs(dev, kernel, 16, 1, 64)
        for _ in range(20):
            fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        out[kernel] = sorted(times)[reps // 2]
        print(f"[attn host] {kernel} packed Hkv=16 G=1 D=64: "
              f"{out[kernel]:.2f}us per call (median of {reps} x {calls} "
              f"eager calls)")
    return out


# attn_ab_phase's cases: (kernel, (Hkv, G, D), fp dtype or None = packed)
AB_CASES = [(kern, sh, fp) for kern in ("K2", "K3")
            for sh, fps in (((16, 1, 64), (None, "float32")),
                            ((4, 8, 128), (None, "bfloat16")),
                            ((1, 16, 256), (None, "bfloat16")))
            for fp in fps] + [("K4", sh, None)
                              for sh in ((16, 1, 64), (4, 8, 128))]


def attn_ab_phase(old_root: str, order=("old", "new", "new", "old"),
                  pos_cases=("mixed",)):
    """K2, K3 and K4 of an older tree (unpacked with `git archive` at
    `old_root`) against this one on the same card, alternated in separate
    processes (`order`), at Qwen1.5-0.5B's shape (Hkv 16, G 1, D 64),
    Qwen3-30B-A3B's (Hkv 4, G 8, D 128) and, for K2/K3, G 16 / D 256,
    packed and over fp caches (`AB_CASES`), K2/K3 at each of `pos_cases`
    (`POS_CASES`); each process builds its tree's kernels, reports 3
    timings a case and the K2/K3 wrappers' host cost per call
    (`attn_host_phase`)."""
    trees = {"old": os.path.abspath(old_root), "new": ROOT}
    cases = [(k, sh, fp, pc) for k, sh, fp in AB_CASES
             for pc in (pos_cases if k != "K4" else ("mixed",))]
    got = {label: {case: [] for case in range(len(cases))}
           for label in trees}
    host = {label: {"K2": [], "K3": []} for label in trees}
    for label in order:
        code = ("import json, sys, torch; "
                f"sys.path.insert(0, {os.path.join(trees[label], 'src')!r}); "
                f"sys.path.insert(0, {ROOT!r}); import chip_smoke as cs; "
                "dev = torch.device('cuda:0'); "
                "print(json.dumps([[cs.attn_time(dev, k, *sh, fp_dtype=fp, "
                f"pos=pc) for k, sh, fp, pc in {cases!r}], "
                "cs.attn_host_phase(dev)]))")
        out = subprocess.run([sys.executable, "-c", code], check=True,
                             capture_output=True, text=True).stdout
        times, us = json.loads(out.strip().splitlines()[-1])
        for case, ms in enumerate(times):
            got[label][case] += ms
        for kern, v in us.items():
            host[label][kern].append(v)
    for case, (kern, (hkv, g, d), fp, pc) in enumerate(cases):
        means = {label: sum(v[case]) / len(v[case])
                 for label, v in got.items()}
        where = f" pos={POS_CASES[pc]}" if kern != "K4" else ""
        print(f"[attn a/b] {kern} Hkv={hkv} G={g} D={d} {fp or 'packed'}"
              f"{where}, "
              f"{' '.join(order)}: old {got['old'][case]} new "
              f"{got['new'][case]} ms; means old {means['old']:.4f} new "
              f"{means['new']:.4f} ms")
    for kern in ("K2", "K3"):
        print(f"[attn a/b host] {kern} wrapper host cost per call, "
              f"{' '.join(order)}: old {host['old'][kern]} new "
              f"{host['new'][kern]} us")
    return got, host


# the layouts K2-K4 were widened to: recurrentgemma-9b's (Hkv 1, G 16,
# D 256), qwen2-7b's (Hkv 4, G 7, D 128), minitron-8b's (Hkv 8, G 4,
# D 128), and bf16 / fp16 fp caches
WIDE_LAYOUTS = ((1, 16, 256), (4, 7, 128), (8, 4, 128))


def layouts_phase(dev):
    """K2, K3 and K4 at the widened layouts against their plain versions
    (K3 also bit for bit against K2): G 16 / D 256, G 7 / D 128 and
    Hkv 8 / G 4 / D 128,
    packed and over bf16 fp caches and pools, and the served shapes (G 8
    / D 128, G 1 / D 64) over bf16 and fp16 ones. Returns the worst
    error of each kernel."""
    worst = {"k2": 0.0, "k3": 0.0, "k4": 0.0}
    cases = [(hkv, g, d, "bfloat16") for hkv, g, d in
             WIDE_LAYOUTS + ((4, 8, 128), (16, 1, 64))]
    cases += [(4, 8, 128, "float16"), (1, 16, 256, "float16")]
    for hkv, g, d, dt in cases:
        worst["k2"] = max(worst["k2"], k2_phase(dev, hkv, g, d, dt,
                                                 all_pos=False)[1])
        worst["k3"] = max(worst["k3"], k3_phase(dev, hkv, g, d, dt,
                                                 all_pos=False)[1])
        worst["k4"] = max(worst["k4"], k4_phase(dev, hkv, g, d, dt,
                                                 cs=(16,))[1])
    return worst


def _layer_weights(dev, gen):
    """One Qwen1.5-0.5B layer's (K, N) shapes with W4 (int4) and W8A8
    (int8) OVP weights and their dequantized fp32 copies."""
    import torch
    from repro_torch.core import policy
    from repro_torch.core.ovp import ovp_dequantize
    from repro_torch.core.qlinear import quantize_weight
    layer = QWEN15_LAYER
    weights = {}
    for k, n in sorted(set(layer)):
        w = torch.randn((k, n), generator=gen, device=dev) / k ** 0.5
        for bits, pol in ((4, policy.OLIVE_W4), (8, policy.OLIVE_W8A8)):
            qt = quantize_weight(w, pol.replace_all(compute_dtype="float32"))
            weights[(k, n, bits)] = (qt, ovp_dequantize(qt))
    return layer, weights


def _outlier_acts(dev, gen, rows: int, k: int):
    """Activations with every 13th value scaled by 25, so the abfloat
    outlier and victim paths are on."""
    import torch
    a = torch.randn((rows, k), generator=gen, device=dev)
    a.view(-1)[::13] *= 25.0
    return a


def k5_codes_phase(dev):
    """K5 (static scale) and K1 codes4 / codes8 against their plain
    versions at the path's shapes, with times, bounds and a library
    call, plus K7 on the pre-scaled activations (byte for byte) and the
    cross-check K7 -> codes4 == K5 at one scale (`k7_phase` times K7)."""
    import torch
    from repro_torch.core.ovp import (QuantizedTensor, ovp_dequantize,
                                      ovp_quantize)
    from repro_torch.core.quantizer import sigma_init_scale
    from repro_torch.kernels import ops
    from repro_torch.kernels import ovp_encode as enc
    from repro_torch.kernels import ovp_matmul as mm

    gen = torch.Generator(device=dev).manual_seed(5)
    layer, weights = _layer_weights(dev, gen)
    names = ("quantize", "static", "codes4", "codes8")
    rows_out = {name: [] for name in names}
    worst = dict.fromkeys(names, 0.0)
    main = {name: None for name in names}
    decode_static = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0, "bound_by": "bytes"}
    for rows in (4, 32):
        for k, n in sorted(set(layer)):
            qt, wd = weights[(k, n, 4)]
            q8, wd8 = weights[(k, n, 8)]
            sw = qt.scale.reshape(-1).contiguous()
            sw8 = q8.scale.reshape(-1).contiguous()
            a = _outlier_acts(dev, gen, rows, k)
            s4 = float(sigma_init_scale(a, "int4"))
            s8 = float(sigma_init_scale(a, "int8"))
            inv4 = mm._reciprocal(s4)
            u = a * inv4                     # K5's scaled activations
            packed = enc.fused_ovp_encode(u)
            x4 = QuantizedTensor(packed, torch.tensor(s4, device=dev),
                                 "int4", -1, k)
            x8 = ovp_quantize(a, s8, "int8")
            sa4 = torch.full((rows,), s4, device=dev)
            sa8 = torch.full((rows,), s8, device=dev)
            k5 = dict(w_dtype="int4", a_mode="static", a_dtype="int4",
                      s_static=s4)
            c4 = dict(w_dtype="int4", a_mode="codes4", a_dtype="int4")
            c8 = dict(w_dtype="int8", a_mode="codes8", a_dtype="int8")
            kq = dict(w_dtype="int4", a_mode="quantize", a_dtype="int4")
            cases = {
                # K1's dynamic mode on the same data and scale: the
                # like-for-like yardstick of K5 (outliers slow both)
                "quantize": (lambda: mm.run(a, sa4, qt.data, sw, **kq),
                             lambda: mm.fused_ovp_matmul_plain(
                                 a, sa4, qt.data, sw, **kq),
                             ovp_dequantize(x4), wd,
                             rows * k * 4 + rows * 4 + k // 2 * n + n * 4
                             + rows * n * 4),
                "static": (lambda: mm.run(a, None, qt.data, sw, **k5),
                           lambda: mm.fused_ovp_matmul_plain(
                               a, None, qt.data, sw, **k5),
                           ovp_dequantize(x4), wd,
                           rows * k * 4 + 4 + k // 2 * n + n * 4
                           + rows * n * 4),
                "codes4": (lambda: mm.run(packed, sa4, qt.data, sw, **c4),
                           lambda: mm.fused_ovp_matmul_plain(
                               packed, sa4, qt.data, sw, **c4),
                           ovp_dequantize(x4), wd,
                           rows * k // 2 + rows * 4 + k // 2 * n + n * 4
                           + rows * n * 4),
                "codes8": (lambda: mm.run(x8.data, sa8, q8.data, sw8, **c8),
                           lambda: mm.fused_ovp_matmul_plain(
                               x8.data, sa8, q8.data, sw8, **c8),
                           ovp_dequantize(x8), wd8,
                           rows * k + rows * 4 + k * n + n * 4
                           + rows * n * 4),
            }
            for name, (kern, plain, ad, wdense, n_bytes) in cases.items():
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                scale = float(ref.abs().max())
                if not within(got, ref, 1e-5, 1e-5 * scale):
                    fail(f"{name} rows={rows} K={k} N={n}: max abs err "
                         f"{err:.3e} over tolerance (rtol 1e-5, atol "
                         f"1e-5*{scale:.3e})")
                worst[name] = max(worst[name], err)
                (ms, wall), (plain_ms, _) = time_ms(kern), time_ms(plain)
                lib_ms, _ = time_ms(lambda: torch.matmul(ad, wdense))
                b_ms, b_by = bound_ms(n_bytes, 2.0 * rows * k * n)
                rec = dict(rows=rows, K=k, N=n, max_abs_err=err, ms=ms,
                           wall_ms=wall, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by)
                rows_out[name].append(rec)
                if rows == 4 and (k, n) == (1024, 1024):
                    main[name] = rec
                if rows == 4 and name == "static":
                    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                        decode_static[key] += layer.count((k, n)) * rec[key]
                    decode_static["bound_by"] = b_by
                print(f"[{name}] rows={rows:2d} K={k:4d} N={n:4d} "
                      f"err={err:.2e} (tol rtol 1e-5, atol 1e-5*max|ref|) "
                      f"kernel={ms:.4f}ms (eager call {wall:.4f}ms) "
                      f"plain={plain_ms:.4f}ms matmul(dequantized)="
                      f"{lib_ms:.4f}ms bound={b_ms:.5f}ms ({b_by})")
            # K7 -> codes4 against K5 at the same scale: the codes are the
            # static prologue's (u = a * (1/s) in both), so only the
            # epilogue order (acc * s * sw against acc * (s * sw)) and
            # nothing else differs
            via = ops.matmul_w4a4(packed, s4, qt.data, qt.scale)
            direct = mm.run(a, None, qt.data, sw, **k5)
            torch.cuda.synchronize()
            scale = float(direct.abs().max())
            err = float((via - direct).abs().max())
            if not within(via, direct, 1e-5, 1e-5 * scale):
                fail(f"K7 -> codes4 vs K5 rows={rows} K={k} N={n}: max abs "
                     f"err {err:.3e}")
            print(f"[k7->codes4] rows={rows:2d} K={k:4d} N={n:4d} against K5 "
                  f"at the same scale: err={err:.2e} (tol rtol 1e-5, atol "
                  f"1e-5*max|ref|)")
            if n != 1024:
                continue                # K7 depends on (rows, K) only
            differ = int((packed != enc.ovp_encode_plain(u)).sum())
            if differ:
                fail(f"K7 rows={rows} K={k}: {differ} bytes differ from "
                     f"the plain version")
            print(f"[k7] rows={rows:2d} K={k:4d} pre-scaled: bytes "
                  f"differing {differ} of {rows * k // 2} (limit 0)")
    return rows_out, worst, main, decode_static


SWEEP_ROWS = (1, 3, 4, 8, 16, 31, 128)
SWEEP_SHAPES = ((272, 40), (2816, 1000), (1040, 1016), (1024, 2816))


def k1_sweep_phase(dev):
    """K1/K5 held against their plain versions in every activation mode,
    with int4, flint4 and int8 weights, at rows 1, 3, 4, 8, 16, 31 and
    128, each through both of the kernel's bodies, on outlier
    activations, at ragged N with K off a 128-pair stage (K 272 -> N 40,
    K 2816 -> N 1000, K 1040 -> N 1016) and at K 1024 -> N 2816; the
    last two put the quantize modes' shared quantization on (2 and 8
    column tiles a cluster). Per-row scales (quantize, codes modes)
    differ from row to row. Any miss fails the run."""
    import torch
    from repro_torch.core.ovp import ovp_quantize
    from repro_torch.kernels import ovp_matmul as mm

    gen = torch.Generator(device=dev).manual_seed(15)
    # per-column weight scales that put about 1 in 20 weights past the
    # normal range, so outlier-victim pairs occur in every weight type
    spread = {"int4": 20.0, "flint4": 40.0, "int8": 300.0}
    n_cases, worst = 0, 0.0
    for k, n in SWEEP_SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev)
        w.view(-1)[::17] *= 8.0
        for w_dtype in ("int4", "flint4", "int8"):
            qt = ovp_quantize(w, w.abs().amax(0, keepdim=True)
                              / spread[w_dtype], w_dtype, pair_axis=-2)
            sw = qt.scale.reshape(-1).contiguous()
            a4 = "int8" if w_dtype == "int8" else w_dtype
            for rows in SWEEP_ROWS:
                a = _outlier_acts(dev, gen, rows, k)
                amax = a.abs().amax(-1)
                sa = (amax / spread[a4]).contiguous()
                c4 = "int4" if w_dtype == "int8" else w_dtype
                sa4 = (amax / spread[c4]).contiguous()
                sa8 = (amax / spread["int8"]).contiguous()
                cases = {
                    "fp": (a, None, dict(a_mode="fp")),
                    "quantize": (a, sa, dict(a_mode="quantize",
                                             a_dtype=a4)),
                    "static": (a, None, dict(a_mode="static", a_dtype=a4,
                                             s_static=float(sa.max()))),
                    "codes4": (ovp_quantize(a, sa4[:, None], c4).data, sa4,
                               dict(a_mode="codes4", a_dtype=c4)),
                    "codes8": (ovp_quantize(a, sa8[:, None], "int8").data,
                               sa8, dict(a_mode="codes8", a_dtype="int8")),
                }
                for mode, (x, s_row, kw) in cases.items():
                    ref = mm.fused_ovp_matmul_plain(
                        x, s_row, qt.data, sw, w_dtype=w_dtype,
                        **dict(dict(a_dtype=a4), **kw))
                    tol = 1e-5 * float(ref.abs().max())
                    for body in mm.BODIES:
                        forced = mm.launch_plan(rows, k, n, w_dtype, body,
                                                mode)
                        got = mm.run(x, s_row, qt.data, sw, w_dtype=w_dtype,
                                     plan=forced, **kw)
                        torch.cuda.synchronize()
                        err = float((got - ref).abs().max())
                        if got.shape != (rows, n) or \
                                not within(got, ref, 1e-5, tol):
                            fail(f"K1 sweep {mode} w={w_dtype} rows={rows} "
                                 f"K={k} N={n} {body} body: shape "
                                 f"{tuple(got.shape)}, max abs err "
                                 f"{err:.3e} over tolerance (rtol 1e-5, "
                                 f"atol {tol:.3e})")
                        worst = max(worst, err / max(tol * 1e5, 1e-30))
                        n_cases += 1
    print(f"[k1 sweep] {n_cases} cases (fp, quantize, static, codes4, "
          f"codes8 x int4 / flint4 / int8 weights x rows {SWEEP_ROWS} x "
          f"(K, N) {SWEEP_SHAPES} x both bodies) within rtol 1e-5, atol "
          f"1e-5*max|ref| of the plain versions; worst abs err "
          f"{worst:.2e} of max|ref|")
    return n_cases, worst


def k1_share_phase(dev):
    """K1 quantize and K5 (static) at rows 4 over the three (K, N) of a
    Qwen1.5-0.5B layer, outlier activations, with the cluster's column
    share forced to each value the split allows (1 = every block
    quantizes its own slice), timed beside the plan's default and held
    against the plain version: the evidence for quantizing once per
    cluster."""
    import dataclasses

    import torch
    from repro_torch.core.quantizer import sigma_init_scale
    from repro_torch.kernels import ovp_matmul as mm

    gen = torch.Generator(device=dev).manual_seed(16)
    layer, weights = _layer_weights(dev, gen)
    totals = {}                     # (mode, "default" | share) -> layer ms
    for k, n in sorted(set(layer)):
        qt, _ = weights[(k, n, 4)]
        sw = qt.scale.reshape(-1).contiguous()
        a = _outlier_acts(dev, gen, 4, k)
        s4 = float(sigma_init_scale(a, "int4"))
        sa = torch.full((4,), s4, device=dev)
        for mode, s_row, extra in (("quantize", sa, {}),
                                   ("static", None, {"s_static": s4})):
            kw = dict(w_dtype="int4", a_mode=mode, a_dtype="int4", **extra)
            ref = mm.fused_ovp_matmul_plain(a, s_row, qt.data, sw, **kw)
            base = mm.launch_plan(4, k, n, "int4", None, mode)
            shares = [g for g in (1, 2, 4, 8) if g * base.split <= 8
                      and (base.n // 16) % g == 0]
            for share in ["default"] + shares:
                forced = None if share == "default" else \
                    dataclasses.replace(base, share=share)

                def kern():
                    return mm.run(a, s_row, qt.data, sw, plan=forced, **kw)

                got = kern()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                tol = 1e-5 * float(ref.abs().max())
                if not within(got, ref, 1e-5, tol):
                    fail(f"K1 share {mode} K={k} N={n} share={share}: max "
                         f"abs err {err:.3e} over tolerance (rtol 1e-5, "
                         f"atol {tol:.3e})")
                ms, _ = time_ms(kern)
                label = f"share {share}" if share != "default" else \
                    f"default (share {base.share})"
                print(f"[k1 share] rows=4 {mode:8s} K={k:4d} N={n:4d} split "
                      f"{base.split} {label}: kernel={ms:.4f}ms err="
                      f"{err:.2e}")
                if share in ("default", 1):
                    key = (mode, share)
                    totals[key] = totals.get(key, 0.0) + \
                        layer.count((k, n)) * ms
    for mode in ("quantize", "static"):
        print(f"[k1 share] Qwen1.5 layer (7 launches, rows 4) {mode}: "
              f"plan's default {totals[(mode, 'default')]:.4f}ms, share 1 "
              f"everywhere {totals[(mode, 1)]:.4f}ms")


def wrapper_host_phase(dev, reps: int = 5, calls: int = 1000):
    """The K1/K5 wrapper's host cost per call, `mm.run` as the backend
    calls it, in the three served modes at rows 4 over the three (K, N)
    of a Qwen1.5-0.5B layer: `calls` eager calls on the host clock with
    no sync between them (the kernel's device time is below the host's,
    so the clock reads the host), median of `reps`. Uses only the
    arguments every version of `run` takes, so it also times an older
    tree's wrapper (import this script with that tree's `src` first on
    the path)."""
    import torch
    from repro_torch.kernels import ovp_matmul as mm

    gen = torch.Generator(device=dev).manual_seed(18)
    out = {}
    for mode in ("fp", "quantize", "static"):
        per = []
        for k, n in sorted(set(QWEN15_LAYER)):
            codes = torch.randint(0, 256, (k // 2, n), generator=gen,
                                  device=dev, dtype=torch.uint8)
            sw = torch.rand(n, generator=gen, device=dev) + 0.5
            a = torch.randn((4, k), generator=gen, device=dev)
            sa = torch.full((4,), 0.5, device=dev)
            kw = {"fp": dict(a_mode="fp"),
                  "quantize": dict(a_mode="quantize", a_dtype="int4"),
                  "static": dict(a_mode="static", a_dtype="int4",
                                 s_static=0.5)}[mode]
            s_row = sa if mode == "quantize" else None
            for _ in range(20):
                mm.run(a, s_row, codes, sw, w_dtype="int4", **kw)
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    mm.run(a, s_row, codes, sw, w_dtype="int4", **kw)
                times.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
            per.append(sorted(times)[reps // 2])
            print(f"[k1 host] {mode:8s} K={k:4d} N={n:4d}: "
                  f"{per[-1]:.2f}us per call (median of {reps} x {calls} "
                  f"eager calls)")
        out[mode] = sum(per) / len(per)
        print(f"[k1 host] {mode}: {out[mode]:.2f}us per call, mean over "
              f"the three shapes")
    return out


def one_launch_check(dev):
    """A K1/K5 call on CUDA tensors is one kernel launch: one call in each
    served mode (fp, quantize, static) at rows 4, K = N = 1024, under
    torch.profiler, must show exactly one device kernel, the decode
    body's (no zero-fill, no second pass). So must one KV write's encode
    through the cuda backend (K7), and a K2 and a K3 call (packed,
    Qwen1.5-0.5B's and Qwen3-30B-A3B's decode shapes, int32 positions as
    the engine passes them): the cluster split combines in the same
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import backends
    from repro_torch.kernels import ovp_matmul as mm

    gen = torch.Generator(device=dev).manual_seed(17)
    codes = torch.randint(0, 256, (512, 1024), generator=gen, device=dev,
                          dtype=torch.uint8)
    sw = torch.rand(1024, generator=gen, device=dev) + 0.5
    a = torch.randn((4, 1024), generator=gen, device=dev)
    sa = torch.full((4,), 0.5, device=dev)
    calls = {"fp": lambda: mm.run(a, None, codes, sw, w_dtype="int4",
                                  a_mode="fp"),
             "quantize": lambda: mm.run(a, sa, codes, sw, w_dtype="int4",
                                        a_mode="quantize"),
             "static": lambda: mm.run(a, None, codes, sw, w_dtype="int4",
                                      a_mode="static", s_static=0.5)}
    for fn in calls.values():
        fn()                                    # build and load first
    torch.cuda.synchronize()
    for mode, fn in calls.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if not names:
            print(f"[k1 launches] {mode}: not measured (no device events)")
            continue
        if len(names) != 1 or "ovp_dec_kernel" not in names[0]:
            fail(f"K1 {mode} call launched {len(names)} device kernels "
                 f"({names}), not one decode-body kernel")
        print(f"[k1 launches] {mode}: 1 device kernel per call "
              f"({names[0][:60]})")
    # one KV write's encode through the cuda backend: one K7 launch
    kv = torch.randn((4, 1, 16, 64), generator=gen, device=dev)
    s = torch.rand((4, 1, 16), generator=gen, device=dev) + 0.1
    cuda_backend = backends.get_backend("cuda")
    cuda_backend.encode_kv(kv, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cuda_backend.encode_kv(kv, s)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        print("[k7 launches] not measured (no device events)")
    elif len(names) != 1 or "ovp_encode_kernel" not in names[0]:
        fail(f"the cuda backend's KV encode launched {len(names)} device "
             f"kernels ({names}), not one K7")
    else:
        print(f"[k7 launches] one KV encode (4 x 1 x 16 x 64): 1 device "
              f"kernel ({names[0][:60]})")
    for kern in ("K2", "K3"):
        for sh in ((16, 1, 64), (4, 8, 128)):
            fn = _attn_inputs(dev, kern, *sh)
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            if not names:
                print(f"[attn launches] {kern}: not measured (no device "
                      f"events)")
                continue
            if len(names) != 1 or "decode_attn_kernel" not in names[0]:
                fail(f"{kern} call (Hkv, G, D = {sh}) launched {len(names)} "
                     f"device kernels ({names}), not one")
            print(f"[attn launches] {kern} Hkv={sh[0]} G={sh[1]} D={sh[2]}: "
                  f"1 device kernel per call ({names[0][:70]})")


def api_phase(dev):
    """The packed-operand kernel API as a user calls it (`kernels.ops`,
    the paper's accelerator dataflow): encode real activations to OVP
    bytes (K7), multiply them by the packed weight (K1 codes4, through
    `ovp_matmul` and `matmul_w4a4`), and an int8-coded W8A8 product (K1
    codes8), at one layer's q-projection shape (rows 4, K = N = 1024).
    Counters are reset just before and read just after; the results are
    held against the same calls on the CPU (plain versions)."""
    import torch
    from repro_torch.core.ovp import QuantizedTensor, ovp_quantize
    from repro_torch.core.quantizer import sigma_init_scale
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(6)
    _, weights = _layer_weights(dev, gen)
    qt, _ = weights[(1024, 1024, 4)]
    q8, _ = weights[(1024, 1024, 8)]
    a = _outlier_acts(dev, gen, 4, 1024)
    s4 = float(sigma_init_scale(a, "int4"))
    s8 = float(sigma_init_scale(a, "int8"))
    x8 = ovp_quantize(a, s8, "int8")

    def path(dev_):
        to = (lambda t: t.to(dev_))
        packed = ops.ovp_encode(to(a), s4)
        xq = QuantizedTensor(packed, torch.tensor(s4, device=dev_), "int4",
                             -1, 1024)
        qw = QuantizedTensor(to(qt.data), to(qt.scale), "int4", -2, 1024)
        return {"packed": packed, "ovp_matmul": ops.ovp_matmul(xq, qw),
                "matmul_w4a4": ops.matmul_w4a4(packed, s4, qw.data,
                                               qw.scale),
                "matmul_w8a8": ops.matmul_w8a8(to(x8.data), s8,
                                               to(q8.data), to(q8.scale))}

    reset_counts()
    got = path(dev)
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(counts, "API phase",
                 ("ovp_encode", "ovp_matmul[codes4]", "ovp_matmul[codes8]"))
    ref = path(torch.device("cpu"))
    if not torch.equal(got["packed"].cpu(), ref["packed"]):
        fail("API phase: ovp_encode bytes differ from the CPU's")
    for key in ("ovp_matmul", "matmul_w4a4", "matmul_w8a8"):
        g, r = got[key].cpu(), ref[key]
        if g.shape != (4, 1024) or not bool(torch.isfinite(g).all()) or \
                not within(g, r, 1e-5, 1e-5 * float(r.abs().max())):
            fail(f"API phase: {key} {tuple(g.shape)} against the CPU: max "
                 f"abs err {float((g - r).abs().max()):.3e}")
    print(f"[api] ovp_encode -> ovp_matmul / matmul_w4a4 (codes4), "
          f"matmul_w8a8 (codes8), rows 4, K = N = 1024: equal to the CPU "
          f"plain path (bytes exact, products within rtol 1e-5); launches "
          f"ovp_encode={counts['ovp_encode']} codes4="
          f"{counts['ovp_matmul[codes4]']} codes8="
          f"{counts['ovp_matmul[codes8]']}")
    return counts


# --------------------------------------------------------------------------
# K7: the OVP encoder at the served KV write's shapes and the API's
# --------------------------------------------------------------------------
# (label, R, K, the scale kind its caller passes): one decode step's KV
# write of phase A (4 slots x 16 kv heads, D 64) and of phase E (4 slots x
# 4 kv heads, D 128), each row at its 3-sigma scale, and a prefill-size
# `kernels.ops.ovp_encode` call at one scalar scale
K7_SHAPES = (("KV write A", 64, 64, "row"), ("KV write E", 16, 128, "row"),
             ("API prefill", 2048, 4096, "scalar"))
K7_DTYPES = ("float32", "bfloat16")


def _k7_inputs(dev, gen, r: int, k: int, dtype: str):
    """x (R, K) in `dtype` with outliers, and its scales by kind: none,
    one scalar (the dynamic 3-sigma rule over the whole tensor) and one a
    row (the KV write's population-std 3-sigma rule)."""
    import torch
    from repro_torch.core.quantizer import sigma_init_scale
    x = _outlier_acts(dev, gen, r, k).to(getattr(torch, dtype))
    xf = x.float()
    row = torch.clamp(3.0 * xf.std(-1, unbiased=False) / 7.0, min=1e-6)
    return x, {"none": None, "scalar": float(sigma_init_scale(xf, "int4")),
               "row": row}


def _k7_divisor(x, scale):
    """The scale as a device tensor that broadcasts over x's rows."""
    import torch
    if isinstance(scale, float):
        return torch.full((), scale, device=x.device)
    return scale.reshape(-1, 1)


def k7_phase(dev):
    """K7 against its plain version on the card, 0 bytes differing, at
    every shape of `K7_SHAPES`, f32 and bf16, with each scale kind (none,
    scalar, per row), and on the scalar path (K 6, a row base that is not
    16-byte aligned) and fp16; timed at the scale kind its caller passes,
    beside the plain version, the same encode as two launches (an f32
    divide, then K7 without a scale: how the parent tree's API ran) and
    the byte bound. Returns (records, the main path's record: phase A's
    KV write in f32)."""
    import torch
    from repro_torch.kernels import ovp_encode as enc

    gen = torch.Generator(device=dev).manual_seed(18)

    def check(x, scales, what):
        for kind, scale in scales.items():
            got = enc.fused_ovp_encode(x, scale=scale)
            ref = enc.ovp_encode_plain(x, scale)
            differ = int((got != ref).sum())
            if differ or got.shape != ref.shape:
                fail(f"K7 {what} scale {kind}: {differ} of {ref.numel()} "
                     f"bytes differ from the plain version")

    recs, main = [], None
    for label, r, k, kind in K7_SHAPES:
        for dtype in K7_DTYPES:
            x, scales = _k7_inputs(dev, gen, r, k, dtype)
            check(x, scales, f"{label} R={r} K={k} {dtype}")
            scale = scales[kind]
            div = _k7_divisor(x, scale)
            plan = enc.encode_plan(r, k, x.dtype, kind)
            (ms, wall), (plain_ms, _) = (
                time_ms(lambda: enc.fused_ovp_encode(x, scale=scale)),
                time_ms(lambda: enc.ovp_encode_plain(x, scale), graph=False))
            two_ms, _ = time_ms(
                lambda: enc.fused_ovp_encode(x.to(torch.float32) / div))
            n_bytes = r * k * x.element_size() + r * k // 2 \
                + (4 * r if kind == "row" else 0)
            b_ms, b_by = bound_ms(n_bytes, 0.0)
            rec = dict(label=label, rows=r, K=k, dtype=dtype, scale=kind,
                       bytes_differ=0, ms=ms, wall_ms=wall,
                       plain_ms=plain_ms, two_launch_ms=two_ms,
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       vec=plan.vec, blocks=plan.blocks)
            recs.append(rec)
            if label == "KV write A" and dtype == "float32":
                main = rec
            print(f"[k7] {label} R={r} K={k} {dtype} scale {kind}: bytes "
                  f"differing 0 of {r * k // 2} at scales none/scalar/row "
                  f"(limit 0); kernel={ms:.4f}ms (eager call {wall:.4f}ms)"
                  f" = {100 * b_ms / ms:.1f}% of the bound, divide + K7 "
                  f"without a scale={two_ms:.4f}ms, plain={plain_ms:.4f}ms "
                  f"(eager), library: none, bound={b_ms:.3g}ms ({b_by}); "
                  f"plan vec {plan.vec} x {plan.blocks} blocks of "
                  f"{plan.threads}")
    # the scalar path: K not a multiple of 8, and a row base off 16 bytes
    x, scales = _k7_inputs(dev, gen, 64, 6, "float32")
    check(x, scales, "R=64 K=6 (pairs)")
    buf = torch.empty(64 * 64 + 1, device=dev)
    x, scales = _k7_inputs(dev, gen, 64, 64, "float32")
    off = buf[1:].view(64, 64)
    off.copy_(x)
    check(off, scales, "R=64 K=64 at a base 4 bytes off")
    x, scales = _k7_inputs(dev, gen, 16, 128, "float16")
    check(x, scales, "R=16 K=128 float16")
    print("[k7] scalar path (K 6; a base 4 bytes off 16-byte alignment) "
          "and fp16 inputs: 0 bytes differing at scales none/scalar/row")
    return recs, main


# k7_exhaustive's fixed scales: inside the range where K7's division keeps
# its one-reciprocal fast path, and two outside it (its __fdiv_rn path)
K7_EXHAUSTIVE_SCALES = (0.3, 0.52911, 1234.5, 1e-13, 3e12)


def k7_exhaustive(dev, chunk: int = 1 << 25, patterns: int = 1 << 32
                  ) -> None:
    """Every float32 bit pattern but the NaNs through K7, each in both
    slots of a pair beside a 0 (rows of 16: the 16-value vector path),
    against the plain version on the card, without a scale (the int4
    code, the outlier test and the abfloat code: ovp_codec.cuh's
    exponent-field floor(log2) and add-rounding against torch's log2,
    exp2 and round), at one scale a row drawn log-uniform from 2^-50 to
    2^50 (K7's division on and off its fast path against torch's true
    division) and at each of `K7_EXHAUSTIVE_SCALES`."""
    import torch
    from repro_torch.kernels import ovp_encode as enc
    gen = torch.Generator(device=dev).manual_seed(32)
    t0 = time.perf_counter()
    passes = [("none", None), ("row", "row")] + [
        (f"scalar {s!r}", s) for s in K7_EXHAUSTIVE_SCALES]
    for label, scale in passes:
        for start in range(0, patterns, chunk):
            bits = torch.arange(start, start + chunk, dtype=torch.int64,
                                device=dev)
            v = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
                torch.int32).view(torch.float32)
            v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
            z = torch.zeros_like(v)
            x = torch.stack([v, z, z, v], -1).reshape(-1, 16)
            s = scale
            if scale == "row":
                s = torch.exp2(torch.rand(x.shape[0], generator=gen,
                                          device=dev) * 100 - 50)
            differ = (enc.fused_ovp_encode(x, scale=s)
                      != enc.ovp_encode_plain(x, s))
            n = int(differ.sum())
            if n:
                rows = differ.any(-1).nonzero()[:4, 0]
                fail(f"K7 exhaustive, scale {label}: {n} bytes differ from "
                     f"the plain version in the chunk from pattern "
                     f"{start:#x}, e.g. rows {x[rows].tolist()}")
    print(f"[k7 exhaustive] {patterns} float32 patterns (NaNs excepted) "
          f"in both slots of a pair, at scales "
          f"{', '.join(label for label, _ in passes)}: 0 bytes differing "
          f"from the plain version ({time.perf_counter() - t0:.1f}s)")


def k7_tree_times(dev):
    """Device ms of one encode at each `K7_SHAPES` x `K7_DTYPES` case and
    the caller's scale kind, as the tree on `sys.path` runs it: its
    `fused_ovp_encode` with the scale where it takes one (one launch),
    else the cast and divide to f32 and then its K7 (the parent tree's
    `kernels.ops.ovp_encode`)."""
    import inspect

    import torch
    from repro_torch.kernels import ovp_encode as enc
    fused = "scale" in inspect.signature(enc.fused_ovp_encode).parameters
    gen = torch.Generator(device=dev).manual_seed(18)
    out = []
    for label, r, k, kind in K7_SHAPES:
        for dtype in K7_DTYPES:
            x, scales = _k7_inputs(dev, gen, r, k, dtype)
            scale = scales[kind]
            div = _k7_divisor(x, scale)
            if fused:
                fn = (lambda x=x, scale=scale:
                      enc.fused_ovp_encode(x, scale=scale))
            else:
                fn = (lambda x=x, div=div:
                      enc.fused_ovp_encode(x.to(torch.float32) / div))
            out.append(time_ms(fn)[0])
    return out


def step_kernels(dev, moe: bool = True):
    """Device kernels, device busy ms and wall ms of one decode step (4
    active slots, `profile_decode`) of phase A's model and, with `moe`,
    phase E's (slab), each built through the launcher's entry point."""
    from repro_torch.launch import serve
    out = {}
    for arch, label, steps in ((ARCH, "A", 6), (MOE_ARCH, "E", 3))[
            :2 if moe else 1]:
        free_device_memory()
        res = serve.run(["--arch", arch, "--quant", "olive_serve",
                         "--requests", "1", "--max-new", "2", "--slots",
                         "4", "--max-len", "256", "--seed", "0"],
                        device=dev)
        prof = profile_decode(res, f"phase {label}", steps=steps,
                              max_new=32 if label == "A" else 10)
        out[label] = [prof["kernels_per_step"], prof["busy_ms"],
                      prof["step_ms"]]
        del res
    return out


def k7_ab_phase(old_root: str, order=("old", "new", "new", "old"),
                moe: bool = True):
    """The parent tree (unpacked with `git archive` at `old_root`)
    against this one on the same card, alternated in separate processes
    (`order`): each process times its tree's encode at every K7 case
    (`k7_tree_times`) and profiles one decode step of phase A's and, with
    `moe`, phase E's model (`step_kernels`)."""
    trees = {"old": os.path.abspath(old_root), "new": ROOT}
    cases = [(label, r, k, dt) for label, r, k, _ in K7_SHAPES
             for dt in K7_DTYPES]
    got = {label: [] for label in trees}
    steps = {label: [] for label in trees}
    for label in order:
        code = ("import json, sys, torch; "
                f"sys.path.insert(0, {os.path.join(trees[label], 'src')!r}); "
                f"sys.path.insert(0, {ROOT!r}); import chip_smoke as cs; "
                "dev = torch.device('cuda:0'); "
                "t = cs.k7_tree_times(dev); "
                f"print(json.dumps([t, cs.step_kernels(dev, {moe!r})]))")
        out = subprocess.run([sys.executable, "-c", code], check=True,
                             capture_output=True, text=True).stdout
        lines = out.strip().splitlines()
        for line in lines:
            if line.startswith("[profile] decode step"):
                print(f"[k7 a/b] {label}: {line}")
        times, kern = json.loads(lines[-1])
        got[label].append(times)
        steps[label].append(kern)
    ran = [lab for lab in trees if got[lab]]
    for i, (name, r, k, dt) in enumerate(cases):
        vals = {lab: [t[i] for t in got[lab]] for lab in ran}
        print(f"[k7 a/b] {name} R={r} K={k} {dt}, {' '.join(order)}: "
              + "; ".join(f"{lab} {vals[lab]} ms, mean "
                          f"{sum(vals[lab]) / len(vals[lab]):.4f}"
                          for lab in ran)
              + " (old: cast/divide + K7; new: one K7)")
    for phase in steps[ran[0]][0]:
        for lab in ran:
            rows = [s[phase] for s in steps[lab]]
            print(f"[k7 a/b] phase {phase} decode step, {lab}: device "
                  f"kernels {[round(x[0], 1) for x in rows]}, device busy "
                  f"{[round(x[1], 3) for x in rows]} ms, wall "
                  f"{[round(x[2], 2) for x in rows]} ms")
    return got, steps


# --------------------------------------------------------------------------
# Serve phases
# --------------------------------------------------------------------------
def reset_counts():
    from repro_torch import backends
    from repro_torch.launch import serve
    backends.reset_dispatch_stats()
    backends.reset_act_scale_stats()
    serve.reset_kernel_launches()


def read_counts():
    from repro_torch import backends
    from repro_torch.launch import serve
    return dict(serve.kernel_launches(), dispatch=backends.dispatch_stats(),
                act_scale=backends.act_scale_stats())


def check_counts(counts, phase: str,
                 kernels=("ovp_matmul[fp]", "decode_attn")) -> None:
    fallbacks = [k for k in counts["dispatch"] if "->fallback" in k]
    if fallbacks:
        fail(f"{phase}: dispatch fell back: {counts['dispatch']}")
    for name in kernels:
        if counts[name] <= 0:
            fail(f"{phase}: kernel {name} was never launched")


def check_attn_counts(res, counts, phase: str, paged: bool) -> None:
    """One attention launch per layer per forward call: K2 (slab) or K3
    (paged) once per layer per decode step, K4 once per layer per paged
    prefill chunk, and no other attention kernel."""
    layers = res["model"].cfg.n_layers
    st = res["engine"].stats()
    want = {"decode_attn": 0 if paged else layers * st["decodes_run"],
            "paged_decode_attn": layers * st["decodes_run"] if paged else 0,
            "prefill_attn": layers * st["prefill_chunks_run"]}
    got = {key: counts[key] for key in want}
    if got != want:
        fail(f"{phase}: attention launches {got}, expected {want} ({layers} "
             f"layers, {st['decodes_run']} decode steps, "
             f"{st['prefill_chunks_run']} prefill chunks)")


def check_encode_counts(eng, counts, phase: str) -> int:
    """K7 once for K and once for V per layer with a packed cache per
    forward call that wrote the cache through `cache_write`: every decode
    step and every whole-prompt prefill (paged prefill chunks write their
    pages in K4). Layers over an fp cache launch none. Returns the
    count."""
    layers = sum("k_data" in layer["kv"] for layer in eng.caches["layers"])
    st = eng.stats()
    want = 2 * layers * (st["decodes_run"] + st["prefills_run"])
    if counts["ovp_encode"] != want:
        fail(f"{phase}: ovp_encode launches {counts['ovp_encode']}, expected "
             f"2 x {layers} packed layers x ({st['decodes_run']} decode "
             f"steps + {st['prefills_run']} prefills) = {want}")
    return want


def sync_check(res, label: str) -> None:
    """One captured decode step of 4 active slots under
    `torch.cuda.set_sync_debug_mode("warn")`: the host syncs warned, by
    where they were raised; the only one allowed is the engine's token
    fetch (the line of `ServingEngine.step` that reads the greedy tokens
    with `.cpu()`), and none may come from the KV write (`cache_write`
    and what it calls)."""
    import inspect
    import traceback
    import warnings

    import numpy as np
    import torch
    from repro_torch import backends
    from repro_torch.backends import base, cuda
    from repro_torch.kernels import ovp_encode
    from repro_torch.models import layers
    from repro_torch.serve.engine import ServingEngine
    eng = res["engine"]
    rng = np.random.default_rng(5)
    for _ in range(4):
        eng.submit(rng.integers(0, eng.model.cfg.vocab, size=12),
                   max_new_tokens=8)
    while len(eng._active()) < 4:
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    kv_write = set()
    for fn in (layers.cache_write, layers._quant_kv, layers._kv_scale,
               layers._paged_cache_write, backends.encode_kv,
               base.encode_rows, cuda.CudaBackend.encode_kv):
        lines, first = inspect.getsourcelines(fn)
        kv_write |= {(inspect.getsourcefile(fn), first + i)
                     for i in range(len(lines))}
    # the layers: the model code and what it calls (not the engine)
    inside = tuple(os.path.join(ROOT, "src", "repro_torch", sub) + os.sep
                   for sub in ("models", "core", "backends", "kernels"))
    lines, first = inspect.getsourcelines(ServingEngine.step)
    fetch = [(inspect.getsourcefile(ServingEngine.step), first + i)
             for i, line in enumerate(lines) if ".cpu()" in line]
    if len(fetch) != 1:
        fail(f"sync check {label}: ServingEngine.step has {len(fetch)} "
             f"lines with .cpu(), expected the one token fetch")
    caught = []

    def record(message, category, filename, lineno, file=None, line=None):
        caught.append(warnings.WarningMessage(message, category, filename,
                                              lineno))
        caught[-1].stack = traceback.format_stack()[:-1]

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # the mode's own first-use notice mentions synchronization too
    syncs = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    others = [w for w in syncs
              if (os.path.abspath(w.filename), w.lineno)
              != (os.path.abspath(fetch[0][0]), fetch[0][1])]
    other = len(others)
    for w in others:
        print(f"[sync {label}] a sync other than the token fetch, raised "
              f"from:\n" + "".join(w.stack[-8:]))
    where = {}
    for w in syncs:
        key = (os.path.relpath(w.filename, ROOT), w.lineno)
        where[key] = where.get(key, 0) + 1
    in_layers = sum(1 for w in syncs
                    if os.path.abspath(w.filename).startswith(inside))
    from_kv = sum(1 for w in syncs
                  if (os.path.abspath(w.filename), w.lineno) in kv_write
                  or os.path.abspath(w.filename)
                  == os.path.abspath(ovp_encode.__file__))
    eng.run_until_drained()
    # the KV write alone, at this step's shapes, under "error": a sync
    # raises
    cfg, served = eng.model.cfg, eng.caches["layers"][0]["kv"]
    paged, dev = "block_table" in served, served["k_data"].device
    cache = (layers.make_paged_kv_cache(16, 16, 4, 16, cfg.n_kv_heads,
                                        cfg.head_dim, kv_bits=4, device=dev)
             if paged else
             layers.make_kv_cache(4, 256, cfg.n_kv_heads, cfg.head_dim,
                                  kv_bits=4, device=dev))
    kv = torch.randn((2, 4, 1, cfg.n_kv_heads, cfg.head_dim), device=dev)
    pos = torch.tensor([0, 17, 255, 3], dtype=torch.int32, device=dev)
    policy = layers.rp(eng.model.policy, "attn", "kv")
    layers.cache_write(cache, kv[0], kv[1], pos, policy)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        layers.cache_write(cache, kv[0], kv[1], pos, policy)
    except RuntimeError as err:
        fail(f"sync check {label}: the KV write synchronized the host: "
             f"{err}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"[sync {label}] one captured decode step under sync debug mode: "
          f"{len(syncs)} host syncs warned, {other} other than the token "
          f"fetch (limit 0), {in_layers} inside the layers (models, core, "
          f"backends, kernels), {from_kv} from the KV write (limit 0); by "
          f"place: "
          + (", ".join(f"{f}:{n} x{c}" for (f, n), c in sorted(where.items()))
             or "none") + f"; the {'paged' if paged else 'slab'} KV write "
          f"alone under \"error\": no sync")
    if from_kv:
        fail(f"sync check {label}: the KV write synchronized the host "
             f"{from_kv} times")
    if other:
        fail(f"sync check {label}: {other} host syncs besides the token "
             f"fetch in one decode step")


def _prefill_keys(eng) -> set:
    """The compiled prefill entries the engine's completed requests
    needed: one per prompt bucket (slab) or ("paged", stage length), by
    the engine's own rounding."""
    keys = set()
    for req in eng.completed:
        bucket = eng._bucket(len(req.prompt))
        if not eng.paged:
            keys.add(bucket)
            continue
        ps = eng.pool.page_size
        unit = -(-eng.cfg.prefill_chunk // ps) * ps or ps
        keys.add(("paged", -(-bucket // unit) * unit))
    return keys


def audit_check(eng, phase: str) -> None:
    """The engine's trace audit after its run: the decode step built
    once, no entry built twice, one prefill entry per bucket or stage
    length seen (none evicted: the runs see at most 3 keys, under the
    cap of 8), and the decode step and every cached prefill entry
    captured as a CUDA graph."""
    audit, st = eng.trace_audit(), eng.stats()
    keys = _prefill_keys(eng)
    graphs = [key for key, entry in eng._prefill_cache.items()
              if entry.graph is None]
    print(f"[audit {phase}] {audit}, prefill cache "
          f"{st['prefill_cache_size']} entries "
          f"{sorted(map(str, eng._prefill_cache))}, "
          f"{st['prefill_cache_evictions']} evictions; keys seen "
          f"{sorted(map(str, keys))}")
    if audit["decode_traces"] != 1 or audit["unexpected_retraces"] != 0 \
            or audit["prefill_jits"] != len(keys) \
            or audit["prefill_traces"] != len(keys) \
            or st["prefill_cache_evictions"] != 0:
        fail(f"{phase}: trace audit {audit} for {len(keys)} prefill keys "
             f"{sorted(map(str, keys))}")
    if eng._decode.graph is None or graphs:
        fail(f"{phase}: not captured: decode "
             f"{eng._decode.graph is not None}, prefill entries without a "
             f"graph {graphs}")


def capture_gate(eng, phase: str, steps: int = 6) -> None:
    """Graph against eager in the same engine: 4 requests admitted (their
    prefills through the cached entries), then from the same caches
    `steps` decode steps through the captured decode step and as many
    through the same step run eagerly on the same static buffers
    (`StepGraph(..., capture=False)`, what `capture=False` runs): the
    logits must be bit-identical, every cache byte equal after the
    steps, and the greedy tokens equal. The caches are put back after,
    and the requests drained."""
    import numpy as np
    import torch
    from repro_torch.serve.capture import StepGraph
    g = eng._decode
    rng = np.random.default_rng(6)
    for _ in range(4):
        eng.submit(rng.integers(0, eng.model.cfg.vocab, size=12),
                   max_new_tokens=steps + 4)
    while len(eng._active()) < 4:
        eng.step()
    if g.graph is None:
        fail(f"capture gate {phase}: the decode step is not captured")
    eager = StepGraph(g.fn, g.inputs, capture=False)
    leaves = [leaf for layer in eng.caches["layers"]
              for leaf in layer["kv"].values()]
    start = [leaf.clone() for leaf in leaves]
    tok0 = np.array([[r.out_tokens[-1]] for r in eng.slots], np.int64)
    runs = {}
    for name, entry in (("graph", g), ("eager", eager)):
        for leaf, s in zip(leaves, start):
            leaf.copy_(s)
        tok, pos = tok0, eng.pos.copy()
        logits, toks = [], []
        for _ in range(steps):
            row, nxt = entry.run(tokens=tok, pos=pos)
            logits.append(row.clone())
            nxt = nxt.cpu().numpy()
            toks.append(nxt)
            tok, pos = nxt[:, None].astype(np.int64), pos + 1
        runs[name] = (torch.stack(logits), np.stack(toks),
                      [leaf.clone() for leaf in leaves])
    for leaf, s in zip(leaves, start):
        leaf.copy_(s)
    eng.run_until_drained()
    (lg, tg, cg), (le, te, ce) = runs["graph"], runs["eager"]
    same_logits = bool(torch.equal(lg, le))
    diff = float((lg - le).abs().max())
    bytes_diff = sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                     for a, b in zip(cg, ce))
    n_bytes = sum(a.numel() * a.element_size() for a in cg)
    same_toks = bool(np.array_equal(tg, te))
    print(f"[capture {phase}] {steps} decode steps of 4 slots, graph vs "
          f"eager in one engine: logits "
          f"{'bit-identical' if same_logits else f'differ (max {diff:.3e})'}"
          f", {bytes_diff} of {n_bytes} cache bytes differ, greedy tokens "
          f"{'equal' if same_toks else 'differ'}")
    if not same_logits or bytes_diff or not same_toks:
        fail(f"capture gate {phase}: graph and eager disagree")


def capture_ab(res, phase: str, order=("eager", "graph", "graph", "eager"),
               steps: int = 6, max_new: int = 32):
    """The launcher's workload (its 8 seeded prompts of 4-31 tokens, 16
    new tokens each) drained by the served engine (captured steps) and by
    an eager twin over the same model, params and config
    (`capture=False`), in turns `order` in this process: tok/s, mean
    TTFT and the median decode-step wall (host clock of steps that only
    decode, 4 slots) per turn; every turn's greedy tokens must be
    equal. Then both are profiled (`profile_decode`). Returns the
    graph's and the eager twin's profiles."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import ServingEngine
    eng_g = res["engine"]
    engs = {"graph": eng_g,
            "eager": ServingEngine(eng_g.model, eng_g.params, eng_g.cfg,
                                   device=eng_g.device, capture=False)}
    prompts = launcher_prompts(eng_g.model.cfg.vocab)
    got, first = {k: [] for k in engs}, None
    for label in order:
        eng = engs[label]
        uids = [eng.submit(p, max_new_tokens=16) for p in prompts]
        walls = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        while eng.has_work():
            ev = eng.step()
            if ev.decode_batch == 4 and not ev.admitted \
                    and not ev.prefill_chunks:
                walls.append((ev.t_end - ev.t_start) * 1e3)
        dt = time.perf_counter() - t0
        done = {r.uid: r for r in eng.completed if r.uid in uids}
        out = [done[u].out_tokens for u in uids]
        n = sum(len(t) for t in out)
        first = first or out
        if out != first:
            fail(f"capture a/b {phase}: greedy tokens differ between turns "
                 f"({' '.join(order)}; {label})")
        ttft = np.mean([done[u].t_first - done[u].t_submit for u in uids])
        got[label].append((n / dt, ttft * 1e3, float(np.median(walls)),
                           np.percentile(walls, 25),
                           np.percentile(walls, 75),
                           torch.cuda.max_memory_allocated() / 1e9))
    for label in engs:
        print(f"[capture a/b {phase}] {label} in turns {' '.join(order)}: "
              + "; ".join(f"{tps:.2f} tok/s, mean TTFT {ttft:.2f}ms, decode "
                          f"step median {med:.3f}ms (IQR {lo:.3f}-{hi:.3f}), "
                          f"peak device memory {gb:.2f} GB"
                          for tps, ttft, med, lo, hi, gb in got[label]))
    print(f"[capture a/b {phase}] greedy tokens equal in every turn "
          f"({sum(len(t) for t in first)} tokens a turn)")
    return {label: profile_decode({"engine": eng},
                                  f"phase {phase}, {label}", steps=steps,
                                  max_new=max_new)
            for label, eng in engs.items()}


def lru_check(res) -> None:
    """The served model in engines of one slot, max_len 64, slab and
    paged (page 16, chunk 16), with `prefill_cache_cap=1` and at the
    default cap (8), on prompts of 5, 20 and 9 tokens (buckets and stage
    lengths 16, 32, 16), as the reference's
    `test_prefill_cache_lru_eviction`: at cap 1 two evictions drop two
    graphs and the returning key is captured again (3 prefill builds, one
    entry left), at cap 8 nothing is evicted, and the greedy tokens are
    equal."""
    import numpy as np
    from repro_torch.serve.engine import EngineCfg, ServingEngine
    from repro_torch.serve.paging import PagePoolCfg
    eng_a = res["engine"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, eng_a.model.cfg.vocab, size=n)
               for n in (5, 20, 9)]
    for mode, extra in (("slab", {}), ("paged", {
            "page_pool": PagePoolCfg(16), "prefill_chunk": 16})):
        toks, stats = {}, {}
        for cap in (1, 8):
            eng = ServingEngine(eng_a.model, eng_a.params, EngineCfg(
                batch_slots=1, max_len=64, prefill_cache_cap=cap, **extra),
                device=eng_a.device)
            for p in prompts:
                eng.submit(p, max_new_tokens=4)
            toks[cap] = [r.out_tokens for r in eng.run_until_drained()]
            stats[cap] = (eng.trace_audit(), eng.stats())
        (a1, s1), (a8, s8) = stats[1], stats[8]
        print(f"[lru {mode}] cap 1: {a1}, cache size "
              f"{s1['prefill_cache_size']}, evictions "
              f"{s1['prefill_cache_evictions']}; cap 8: {a8}, cache size "
              f"{s8['prefill_cache_size']}, evictions "
              f"{s8['prefill_cache_evictions']}; greedy tokens "
              f"{'equal' if toks[1] == toks[8] else 'differ'}")
        if (s1["prefill_cache_size"], s1["prefill_cache_evictions"],
                a1["prefill_traces"], a1["prefill_jits"],
                a1["unexpected_retraces"]) != (1, 2, 3, 3, 0) \
                or (s8["prefill_cache_size"],
                    s8["prefill_cache_evictions"]) != (2, 0) \
                or toks[1] != toks[8]:
            fail(f"LRU check ({mode}): the prefill cache at cap 1 and 8")


def serve_phase_a(dev, arch: str = ARCH):
    """The main path through the launcher's entry point."""
    from repro_torch.launch import serve
    reset_counts()
    res = serve.run(["--arch", arch, "--quant", "olive_serve",
                     "--requests", "8", "--max-new", "16", "--slots", "4",
                     "--max-len", "256", "--seed", "0"], device=dev)
    counts = read_counts()
    check_counts(counts, "serve phase A")
    check_attn_counts(res, counts, "serve phase A", paged=False)
    check_encode_counts(res["engine"], counts, "serve phase A")
    done = res["completed"]
    if len(done) != 8 or any(len(r.out_tokens) != 16 for r in done):
        fail(f"serve phase A: {len(done)} requests finished with "
             f"{[len(r.out_tokens) for r in done]} tokens, expected 8 x 16")
    print(f"[serve A] {arch} W4 + KV4: {res['tokens']} tokens in "
          f"{res['seconds']:.3f}s = {res['tok_per_s']:.1f} tok/s, mean TTFT "
          f"{res['mean_ttft_s'] * 1e3:.2f}ms, mean step "
          f"{res['mean_step_s'] * 1e3:.2f}ms, PTQ {res['ptq_s']:.2f}s, "
          f"launches ovp_matmul[fp]={counts['ovp_matmul[fp]']} "
          f"decode_attn={counts['decode_attn']} ovp_encode="
          f"{counts['ovp_encode']}, dispatch {counts['dispatch']}")
    return res, counts


def _to(tree, device):
    import dataclasses

    import torch
    from repro_torch.core.ovp import MixedExpertQuant
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, MixedExpertQuant):      # rebuilds its index tensors
        return MixedExpertQuant(
            groups=tuple(_to(g, device) for g in tree.groups),
            expert_ids=tree.expert_ids, n_experts=tree.n_experts)
    return dataclasses.replace(tree, data=tree.data.to(device),
                               scale=tree.scale.to(device))


PROMPT = [11, 2048, 77, 901, 5, 31337, 64, 7]


def _logits_on(model, params, device, prompt=PROMPT):
    """Prefill of one prompt + 2 greedy decode steps: (3, V)."""
    import torch
    t = len(prompt)
    caches = model.init_caches(1, 32, device=device)
    logits, caches = model.forward(
        params, {"tokens": torch.tensor([prompt], device=device)
                 % model.cfg.vocab}, mode="prefill", caches=caches)
    steps = [logits[0, -1]]
    for i in range(2):
        tok = int(torch.argmax(steps[-1]))
        batch = {"tokens": torch.tensor([[tok]], device=device),
                 "pos": torch.tensor([t + i], device=device)}
        logits, caches = model.forward(params, batch, mode="decode",
                                       caches=caches)
        steps.append(logits[0, 0])
    return torch.stack(steps).float().cpu()


def _paged_logits_on(model, params, device, prompt, chunk: int = 16):
    """The same as `_logits_on` over a paged cache: the prompt prefilled
    in chunks through the stage (K4 on the card) onto shuffled pages of
    16 rows, then 2 greedy decode steps through the block table (K3)."""
    import torch
    ps, n = 16, 4
    t = len(prompt)
    stage_len = -(-t // chunk) * chunk
    caches = model.init_paged_caches(n, ps, 1, n, device=device)
    bt = torch.tensor([[2, 0, 3, 1]], dtype=torch.int32, device=device)
    cfg = model.cfg
    stages = []
    for layer in caches["layers"]:
        layer["kv"]["block_table"] = bt
        stages.append({key: torch.zeros((1, stage_len, cfg.n_kv_heads,
                                         cfg.head_dim), device=device)
                       for key in ("stage_k", "stage_v")})
    toks = torch.zeros((1, stage_len), dtype=torch.int64, device=device)
    toks[0, :t] = torch.tensor(prompt, device=device) % cfg.vocab
    view = {"layers": [{"kv": dict(layer["kv"],
                                   block_table=bt[:, :stage_len // ps],
                                   **stage)}
                       for layer, stage in zip(caches["layers"], stages)]}
    for off in range(0, stage_len, chunk):
        logits, _ = model.forward(
            params, {"tokens": toks[:, off:off + chunk]}, mode="prefill",
            caches=view,
            positions=torch.arange(off, off + chunk, device=device)[None])
        if off <= t - 1 < off + chunk:
            steps = [logits[0, t - 1 - off]]
    for i in range(2):
        tok = int(torch.argmax(steps[-1]))
        batch = {"tokens": torch.tensor([[tok]], device=device),
                 "pos": torch.tensor([t + i], device=device)}
        logits, caches = model.forward(params, batch, mode="decode",
                                       caches=caches)
        steps.append(logits[0, 0])
    return torch.stack(steps).float().cpu()


def reference_check(model, params, dev, label: str = "W4",
                    paged: bool = False):
    """The served model on the card against the same model on the CPU
    through the plain versions: finite logits of the expected shape.
    Slab: prefill of one prompt + 2 decode steps (`_logits_on`); paged:
    chunked paged prefill of a 24-token prompt (2 x 16, K4 on the card)
    + 2 decode steps through the block table (K3; `_paged_logits_on`).

    With quantized weights over an fp32 KV cache only fp32 summation
    order differs, so max |diff| <= 1e-3 * max|ref| and equal greedy
    tokens are required. Over a 4-bit KV cache (any layer's) a last-bit
    difference in K/V can move a value across a quantization boundary, so
    that difference is reported, not bounded."""
    import torch
    from repro_torch.models.model import build_model
    cpu_params = _to(params, "cpu")
    fp_cache = build_model(model.cfg, model.policy.replace_all(kv_bits=0))
    pairs = [(f"{label}, fp32 KV", fp_cache)]
    if model.policy.kv_bits:
        pairs.append((f"{label} + KV4", model))
    if paged:
        def logits(m, p, device):
            return _paged_logits_on(m, p, device, PROMPT * 3)
        what = "chunked paged prefill (2 x 16)"
    else:
        logits, what = _logits_on, "full-width prefill"
    for name, m in pairs:
        got, ref = logits(m, params, dev), logits(m, cpu_params, "cpu")
        vp, v = m.cfg.padded_vocab, m.cfg.vocab
        if got.shape != (3, vp) or not bool(torch.isfinite(got).all()):
            fail(f"reference check {name}: logits shape "
                 f"{tuple(got.shape)} or non-finite values")
        err = float((got[:, :v] - ref[:, :v]).abs().max())
        tol = 1e-3 * float(ref[:, :v].abs().max())
        same = bool(torch.equal(got.argmax(-1), ref.argmax(-1)))
        print(f"[ref] {name}: {what} + 2 decode steps, card vs "
              f"CPU plain versions: max |diff| {err:.3e} (tol {tol:.3e} "
              f"{'applied' if m is fp_cache else 'not applied'}), greedy "
              f"tokens {'equal' if same else 'differ'}")
        if m is fp_cache and (err > tol or not same):
            fail(f"reference check {name}: card and CPU disagree")


def profile_decode(res, label: str = "W4 + KV4", steps: int = 6,
                   max_new: int = 32) -> None:
    """Where one decode step's time goes on the served model: `steps`
    steps of 4 active slots timed on the host clock, then as many more
    under torch.profiler for the device busy time and the top kernels
    (4 requests of `max_new` tokens, drained after)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    eng = res["engine"]
    rng = np.random.default_rng(3)
    for _ in range(4):
        eng.submit(rng.integers(0, eng.model.cfg.vocab, size=12),
                   max_new_tokens=max_new)
    while len(eng._active()) < 4:         # admission (and paged prefill)
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / steps * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    n_kernels = sum(e.count for e in kernels) / steps
    # zero-fill kernels (torch.zeros / fill_): a split-K matmul needs one
    n_fills = sum(e.count for e in kernels
                  if "FillFunctor" in e.key) / steps
    # K1/K5's decode-body kernels: each is one whole call
    dense = [e for e in kernels if "ovp_dec_kernel" in e.key]
    n_dense = sum(e.count for e in dense) / steps
    k1_ms = sum(e.self_device_time_total for e in dense) / 1e3 / steps
    # K6's persistent kernel (the MoE expert einsums)
    grouped = [e for e in kernels if "ovp_grouped_dec_kernel" in e.key]
    k6_ms = sum(e.self_device_time_total for e in grouped) / 1e3 / steps
    k6_n = sum(e.count for e in grouped) / steps
    # K2 / K3 (one kernel template, slab or paged rows)
    attn = [e for e in kernels if "decode_attn_kernel" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3 / steps
    attn_n = sum(e.count for e in attn) / steps
    print(f"[profile] decode step (4 slots, {label}, {steps} steps): "
          f"{step_ms:.2f}ms "
          f"wall; under the profiler {prof_ms:.2f}ms wall, device busy "
          + (f"{busy_ms:.3f}ms ({100 * busy_ms / prof_ms:.1f}% of wall), "
             f"{n_kernels:.1f} device kernels per step, {n_fills:.1f} of "
             f"them zero-fills, {n_dense:.1f} K1/K5 calls ({k1_ms:.3f}ms)"
             + (f", K6 {k6_ms:.3f}ms over {k6_n:.1f} launches" if grouped
                else "")
             + f", K2/K3 {attn_ms:.3f}ms over {attn_n:.1f} launches"
             if kernels else "not measured (no device events)"))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"[profile]   {e.self_device_time_total / 1e3 / steps:8.3f}"
              f"ms/step {e.count // steps:5d} launches/step  {e.key[:90]}")
    eng.run_until_drained()
    return {"step_ms": step_ms, "prof_ms": prof_ms, "busy_ms": busy_ms,
            "kernels_per_step": n_kernels if kernels else None,
            "k6_ms": k6_ms if kernels else None,
            "k1_ms": k1_ms if kernels else None,
            "attn_ms": attn_ms if kernels else None}


def serve_phase_c(dev, res_a, arch: str = ARCH):
    """The paged path through the launcher's entry point, on phase A's
    prompts and seed; tokens compared with phase A's (reported only)."""
    from repro_torch.launch import serve
    reset_counts()
    res = serve.run(["--arch", arch, "--quant", "olive_serve",
                     "--requests", "8", "--max-new", "16", "--slots", "4",
                     "--max-len", "256", "--seed", "0", "--paged", "16",
                     "--prefill-chunk", "16"], device=dev)
    counts = read_counts()
    check_counts(counts, "serve phase C",
                 ("ovp_matmul[fp]", "paged_decode_attn", "prefill_attn"))
    check_attn_counts(res, counts, "serve phase C", paged=True)
    check_encode_counts(res["engine"], counts, "serve phase C")
    done = res["completed"]
    if len(done) != 8 or any(len(r.out_tokens) != 16 for r in done):
        fail(f"serve phase C: {len(done)} requests finished with "
             f"{[len(r.out_tokens) for r in done]} tokens, expected 8 x 16")
    st = res["engine"].stats()
    pool = st["page_pool"]
    if pool["used_pages"] != 0 or pool["allocs"] != pool["frees"]:
        fail(f"serve phase C: pages not all returned: {pool}")
    a_toks = {r.uid: r.out_tokens for r in res_a["completed"]}
    differ = sum(int(x != y) for r in done
                 for x, y in zip(r.out_tokens, a_toks[r.uid]))
    print(f"[serve C] {arch} W4 + KV4 paged 16, prefill chunk 16: "
          f"{res['tokens']} tokens in {res['seconds']:.3f}s = "
          f"{res['tok_per_s']:.1f} tok/s, mean TTFT "
          f"{res['mean_ttft_s'] * 1e3:.2f}ms, mean step "
          f"{res['mean_step_s'] * 1e3:.2f}ms, {st['prefill_chunks_run']} "
          f"prefill chunks, launches ovp_matmul[fp]="
          f"{counts['ovp_matmul[fp]']} "
          f"decode_attn={counts['decode_attn']} paged_decode_attn="
          f"{counts['paged_decode_attn']} prefill_attn="
          f"{counts['prefill_attn']} ovp_encode={counts['ovp_encode']}, "
          f"dispatch {counts['dispatch']}")
    print(f"[serve C] tokens differing from phase A (slab): {differ} of "
          f"{res['tokens']} (reported, not bounded: chunked prefill "
          f"changes K1's row counts and so the last bits before the "
          f"4-bit KV quantization)")
    print(f"[serve C] page pool: {pool}")
    return res, counts


def paged_reference_check(model, params, dev):
    """W4 over an fp32 cache on the card: chunked paged prefill of a
    24-token prompt (2 chunks of 16) + 2 decode steps against the slab
    path; logits within 1e-3 * max|ref| and equal greedy tokens."""
    import dataclasses

    import torch
    from repro_torch.models.model import build_model
    fp_cache = build_model(model.cfg, dataclasses.replace(
        model.policy, kv_bits=0))
    prompt = PROMPT * 3
    got = _paged_logits_on(fp_cache, params, dev, prompt)
    ref = _logits_on(fp_cache, params, dev, prompt)
    v = fp_cache.cfg.vocab
    if not bool(torch.isfinite(got).all()):
        fail("paged reference check: non-finite logits")
    err = float((got[:, :v] - ref[:, :v]).abs().max())
    tol = 1e-3 * float(ref[:, :v].abs().max())
    same = bool(torch.equal(got.argmax(-1), ref.argmax(-1)))
    print(f"[ref C] W4, fp32 KV: chunked paged prefill (2 x 16) + 2 decode "
          f"steps vs the slab path on the card: max |diff| {err:.3e} (tol "
          f"{tol:.3e}), greedy tokens {'equal' if same else 'differ'}")
    if err > tol or not same:
        fail("paged reference check: paged and slab paths disagree")


def interleave_check(res, dev):
    """A 200-token prompt prefilled in chunks of 64 through the engine
    API beside 3 decoding requests: no step runs more than one chunk and
    the decoding requests get a token every step of the prefill."""
    import numpy as np
    from repro_torch.serve.engine import EngineCfg, ServingEngine
    from repro_torch.serve.paging import PagePoolCfg
    eng = ServingEngine(res["model"], res["params"], EngineCfg(
        batch_slots=4, max_len=256, page_pool=PagePoolCfg(16),
        prefill_chunk=64), device=dev)
    rng = np.random.default_rng(5)
    vocab = res["model"].cfg.vocab
    short = [eng.submit(rng.integers(0, vocab, size=12), max_new_tokens=24)
             for _ in range(3)]
    while len(eng._active()) < 3:
        eng.step()
    long_uid = eng.submit(rng.integers(0, vocab, size=200), max_new_tokens=4)
    chunk_steps, stalled = 0, 0
    while eng.has_work():
        ev = eng.step()
        if ev.prefill_chunks > 1:
            fail(f"interleave check: step {ev.step} ran "
                 f"{ev.prefill_chunks} prefill chunks")
        if ev.prefill_chunks:
            chunk_steps += 1
            got = {t.uid for t in ev.tokens}
            stalled += sum(1 for u in short
                           if u not in got and any(
                               r is not None and r.uid == u
                               for r in eng.slots))
    long_req = next(r for r in eng.completed if r.uid == long_uid)
    if chunk_steps != 4 or stalled or len(long_req.out_tokens) != 4:
        fail(f"interleave check: {chunk_steps} chunk steps (want 4), "
             f"{stalled} stalled decodes, long request "
             f"{len(long_req.out_tokens)} tokens")
    print(f"[interleave] 200-token prompt, chunk 64: {chunk_steps} steps "
          f"with one chunk each, the 3 decoding requests got a token "
          f"every one of them")


def defrag_check(res) -> None:
    """Phase C's model in a paged engine of 2 slots (page 16, chunk 16),
    4 prompts of 12-40 tokens, 6 new tokens each, compacting the pool
    (`defrag()`) every second step once the decode step is captured: the
    graphs read the pools and the block table in place, so the greedy
    tokens must equal those of the same run without compaction."""
    import numpy as np
    from repro_torch.serve.engine import EngineCfg, ServingEngine
    from repro_torch.serve.paging import PagePoolCfg
    eng_c = res["engine"]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, eng_c.model.cfg.vocab, size=n)
               for n in (12, 40, 20, 33)]
    toks, moved = {}, 0
    for label in ("plain", "defrag"):
        eng = ServingEngine(eng_c.model, eng_c.params, EngineCfg(
            batch_slots=2, max_len=256, page_pool=PagePoolCfg(16),
            prefill_chunk=16), device=eng_c.device)
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        steps = 0
        while eng.has_work():
            eng.step()
            steps += 1
            if label == "defrag" and steps % 2 == 0 and eng._decode.built:
                remap = eng.defrag()
                moved += sum(old != new for old, new in remap.items())
        toks[label] = {r.uid: r.out_tokens for r in eng.completed}
    same = toks["plain"] == toks["defrag"]
    print(f"[defrag] paged engine on captured steps, the pool compacted "
          f"every second step: {moved} page moves, greedy tokens "
          f"{'equal' if same else 'differ'} to the run without")
    if not moved or not same:
        fail("defrag check: compaction under captured steps")


def serve_phase_b(model_a, params, dev):
    """W4A4 + KV4 through the engine API (K1's quantize prologue)."""
    import numpy as np
    from repro_torch.core.policy import OLIVE_SERVE
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import EngineCfg, ServingEngine
    model = build_model(model_a.cfg,
                        OLIVE_SERVE.replace_all(compute_dtype="float32"))
    eng = ServingEngine(model, params, EngineCfg(batch_slots=4, max_len=256),
                        device=dev)
    rng = np.random.default_rng(1)
    for _ in range(4):
        eng.submit(rng.integers(0, model.cfg.vocab,
                                size=int(rng.integers(4, 32))),
                   max_new_tokens=8)
    reset_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    dt = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, "serve phase B",
                 ("ovp_matmul[quantize]", "decode_attn"))
    check_encode_counts(eng, counts, "serve phase B")
    if len(done) != 4 or any(len(r.out_tokens) != 8 for r in done):
        fail("serve phase B: expected 4 requests x 8 tokens")
    toks = sum(len(r.out_tokens) for r in done)
    print(f"[serve B] {model.cfg.name} W4A4 + KV4 (dynamic 3-sigma scales): "
          f"{toks} tokens in {dt:.3f}s = {toks / dt:.1f} tok/s, launches "
          f"ovp_matmul[quantize]={counts['ovp_matmul[quantize]']} "
          f"decode_attn={counts['decode_attn']} ovp_encode="
          f"{counts['ovp_encode']}, act-scale resolutions "
          f"{counts['act_scale']}")
    return {"engine": eng}, counts


CALIB = os.path.join(ROOT, "build", "calib", f"{ARCH}.json")


def serve_phase_d(dev, res_a, arch: str = ARCH):
    """Calibrate-then-serve through the launcher's entry point, on phase
    A's prompts and seed: `--calibrate --calibration build/calib/...`
    (calibrate on the synthetic (2, 64) batch, save, serve W4A4 + KV4 on
    static scales), then `--calibration` alone from the saved file, slab
    and paged (`--paged 16 --prefill-chunk 16`). Counters are reset just
    before and read just after each run: every quantized linear must run
    K5 (`ovp_matmul[static]`), never the dynamic quantize mode, with no
    dynamic scale resolution and no fallback."""
    from repro_torch.launch import serve
    base = ["--arch", arch, "--quant", "olive_serve", "--requests", "8",
            "--max-new", "16", "--slots", "4", "--max-len", "256",
            "--seed", "0", "--calibration", CALIB]
    runs = {}
    for label, extra, kernels in (
            ("calibrate", ["--calibrate"], ("ovp_matmul[static]",
                                            "decode_attn", "ovp_encode")),
            ("load", [], ("ovp_matmul[static]", "decode_attn",
                          "ovp_encode")),
            ("paged", ["--paged", "16", "--prefill-chunk", "16"],
             ("ovp_matmul[static]", "paged_decode_attn", "prefill_attn",
              "ovp_encode"))):
        reset_counts()
        res = serve.run(base + extra, device=dev)
        counts = read_counts()
        phase = f"serve phase D ({label})"
        check_counts(counts, phase, kernels)
        check_encode_counts(res["engine"], counts, phase)
        if counts["ovp_matmul[quantize]"] or counts["ovp_matmul[fp]"]:
            fail(f"{phase}: the dynamic quantize or fp mode ran: {counts}")
        if counts["act_scale"].get("dynamic", 0) or \
                not counts["act_scale"].get("static", 0):
            fail(f"{phase}: act-scale resolutions {counts['act_scale']}")
        done = res["completed"]
        if len(done) != 8 or any(len(r.out_tokens) != 16 for r in done):
            fail(f"{phase}: {len(done)} requests finished with "
                 f"{[len(r.out_tokens) for r in done]} tokens, expected "
                 f"8 x 16")
        sites = res["artifact"].sites()
        want = res["model"].cfg.n_layers * 7 + 1   # 7 linears + the head
        if len(sites) != want:
            fail(f"{phase}: artifact has {len(sites)} sites, expected "
                 f"{want}")
        print(f"[serve D] {arch} W4A4 + KV4 static, {label}: "
              f"{len(sites)} scales "
              + (f"calibrated in {res['calib_s']:.2f}s, " if res["calib_s"]
                 else "loaded, ")
              + f"PTQ {res['ptq_s']:.2f}s, {res['tokens']} tokens in "
              f"{res['seconds']:.3f}s = {res['tok_per_s']:.1f} tok/s, mean "
              f"TTFT {res['mean_ttft_s'] * 1e3:.2f}ms, mean step "
              f"{res['mean_step_s'] * 1e3:.2f}ms, launches "
              + " ".join(f"{k}={counts[k]}" for k in kernels)
              + f" ovp_matmul[quantize]={counts['ovp_matmul[quantize]']}, "
              f"act-scale resolutions {counts['act_scale']}, dispatch "
              f"{counts['dispatch']}")
        runs[label] = (res, counts)
    toks = {lab: {r.uid: r.out_tokens for r in res["completed"]}
            for lab, (res, _) in runs.items()}
    for lab in ("load", "paged"):
        differ = sum(int(x != y) for uid, t in toks[lab].items()
                     for x, y in zip(t, toks["calibrate"][uid]))
        print(f"[serve D] {lab} vs calibrate run: {differ} of 128 tokens "
              f"differ (reported, not bounded)")
    a_toks = {r.uid: r.out_tokens for r in res_a["completed"]}
    differ = sum(int(x != y) for uid, t in toks["calibrate"].items()
                 for x, y in zip(t, a_toks[uid]))
    print(f"[serve D] W4A4 static vs phase A's W4 (activations fp32): "
          f"{differ} of 128 tokens differ (reported: 4-bit activations "
          f"change the model)")
    return runs


def step_wall_ab(res_b, res_d, steps: int = 8) -> None:
    """Decode-step wall time on the host clock of the dynamic (B) and the
    static (D) W4A4 engines, 4 active slots each, in turns B, D, D, B, B,
    D of `steps` steps, each step between two synchronizes: the two are
    compared within one call and in alternation, since host-clock times
    drift by a third between runs."""
    import numpy as np
    import torch
    engs = {"B": res_b["engine"], "D": res_d["engine"]}
    rng = np.random.default_rng(4)
    for eng in engs.values():
        for _ in range(4):
            eng.submit(rng.integers(0, eng.model.cfg.vocab, size=12),
                       max_new_tokens=64)
        while len(eng._active()) < 4:
            eng.step()
    times = {"B": [], "D": []}
    for label in ("B", "D", "D", "B", "B", "D"):
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engs[label].step()
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3)
    for eng in engs.values():
        eng.run_until_drained()
    q = {k: np.percentile(v, [25, 50, 75]) for k, v in times.items()}
    print(f"[profile] decode step wall, {3 * steps} steps each in turns "
          f"B D D B B D: dynamic (B) median {q['B'][1]:.2f}ms (IQR "
          f"{q['B'][0]:.2f}-{q['B'][2]:.2f}), static (D) median "
          f"{q['D'][1]:.2f}ms (IQR {q['D'][0]:.2f}-{q['D'][2]:.2f})")


STATIC_LOGIT_TOL = 1e-3


def static_reference_check(res_d, dev):
    """The static W4A4 program (the loaded artifact) over an fp32 KV cache
    on the card against the same model on the CPU through the plain
    versions: prefill of one prompt + 2 greedy decode steps. Greedy
    tokens must be equal and max |logit diff| <= 1e-3 * max|ref|, the
    bound of the other card-vs-CPU logit checks: the card's fp32 sums
    differ from the CPU's only in the last bits, so a wrong scale route
    or a wrong epilogue, whose errors are of the order of the logits,
    fails it."""
    import torch
    from repro_torch.models.model import build_model
    model, params = res_d["model"], res_d["params"]
    fp_cache = build_model(model.cfg, model.policy.replace_all(kv_bits=0))
    got = _logits_on(fp_cache, params, dev)
    ref = _logits_on(fp_cache, _to(params, "cpu"), "cpu")
    v = model.cfg.vocab
    if got.shape != (3, model.cfg.padded_vocab) or \
            not bool(torch.isfinite(got).all()):
        fail(f"static reference check: logits shape {tuple(got.shape)} or "
             f"non-finite values")
    err = float((got[:, :v] - ref[:, :v]).abs().max())
    tol = STATIC_LOGIT_TOL * float(ref[:, :v].abs().max())
    same = bool(torch.equal(got.argmax(-1), ref.argmax(-1)))
    print(f"[ref D] W4A4 static, fp32 KV: full-width prefill + 2 decode "
          f"steps, card vs CPU plain versions: max |diff| {err:.3e} (tol "
          f"{tol:.3e} = {STATIC_LOGIT_TOL} * max|ref|), greedy tokens "
          f"{'equal' if same else 'differ'}")
    if err > tol or not same:
        fail("static reference check: card and CPU disagree")


# --------------------------------------------------------------------------
# MoE: K6 and serve phase E (Qwen3-30B-A3B)
# --------------------------------------------------------------------------
MOE_ARCH = "qwen3-moe-30b-a3b"


def _routed_fill(gen, dev, b: int, tokens: int, e: int = 128,
                 top_k: int = 8, cap: int = 4):
    """A real routing's fill: each of `tokens` tokens of each of `b` batch
    rows picks `top_k` distinct experts of `e` (a seeded draw); fill =
    min(counts, cap), as `moe_layer` computes it."""
    import torch
    counts = torch.zeros((b, e), dtype=torch.int64, device=dev)
    for row in range(b):
        for _ in range(tokens):
            picks = torch.randperm(e, generator=gen, device=dev)[:top_k]
            counts[row, picks] += 1
    return torch.clamp(counts, max=cap).to(torch.int32)


K6_LAYERS = 4     # distinct weight stacks the cold-L2 timing rotates over


def k6_phase(dev):
    """K6 against its plain version at the MoE serving path's shapes, fp
    mode (the expert einsums run weight-only), int4 weights, with the
    fill of a real routing: decode (B 4 slots x top-8 of E 128, capacity
    C 4) for wg / wu (K 2048 -> N 768) and wd (K 768 -> N 2048), and a
    16-token prefill chunk (B 1, C 4: max(int(1.25 * 16 * 8 / 128), 4)).
    Filled rows are held to the plain version (rows past the fill are
    unwritten by contract and not compared); the activation rows past
    the fill hold random values, which must not matter. Timed by
    CUDA-graph replay with cold L2: each timed launch reads a different
    layer's weight stack, rotating over K6_LAYERS layers (1.2 GB of
    stacks; a launch's touched experts are about 25 MB against the 50 MB
    L2), beside the same launch warm (one stack replayed), the launch
    without the fill (every slot of every expert), the plain version and
    the library call (one `torch.einsum` of the (B, E, C, K) lhs and the
    dequantized fp32 (E, K, N) stack). The bound counts what the fill
    needs: the touched experts' packed weights and scales, the filled
    rows' activations and outputs, and their FMAs."""
    import torch
    from repro_torch.core import policy
    from repro_torch.core.ovp import ovp_dequantize
    from repro_torch.core.qlinear import quantize_weight
    from repro_torch.kernels import ovp_matmul as mm

    gen = torch.Generator(device=dev).manual_seed(7)
    w4 = policy.OLIVE_W4.replace_all(compute_dtype="float32")
    e = 128
    layer = [(2048, 768), (2048, 768), (768, 2048)]   # wg, wu, wd
    stacks = {}                 # (K, N) -> [(codes, scales)] per layer
    dense = {}
    for k, n in sorted(set(layer)):
        w = torch.randn((e, k, n), generator=gen, device=dev) / k ** 0.5
        qt = quantize_weight(w, w4)
        del w
        dense[(k, n)] = ovp_dequantize(qt)
        stacks[(k, n)] = [(qt.data, qt.scale.reshape(e, n).contiguous())]
        for _ in range(1, K6_LAYERS):   # timing copies: random codes
            stacks[(k, n)].append((
                torch.randint(0, 256, qt.data.shape, generator=gen,
                              device=dev, dtype=torch.uint8),
                torch.rand((e, n), generator=gen, device=dev) + 0.5))
    fills = {"decode": (4, _routed_fill(gen, dev, 4, 1)),
             "prefill": (1, _routed_fill(gen, dev, 1, 16))}
    rows_out, worst = [], 0.0
    decode = {"ms": 0.0, "warm_ms": 0.0, "all_rows_ms": 0.0, "plain_ms": 0.0,
              "bound_ms": 0.0, "library_ms": 0.0, "stack_bytes_ms": 0.0}
    for label, (b, fill) in fills.items():
        c = 4
        live = torch.arange(c, device=dev) < fill[..., None]   # (B, E, C)
        touched = int((fill.sum(0) > 0).sum())
        filled = int(fill.sum())
        for k, n in sorted(set(layer)):
            a = torch.randn((b, e, c, k), generator=gen, device=dev)
            codes, sw = stacks[(k, n)][0]

            def kern(i=0, f=fill):
                cw, cs = stacks[(k, n)][i]
                return mm.run_grouped(a, None, cw, cs, w_dtype="int4",
                                      a_mode="fp", fill=f)

            def plain():
                return mm.grouped_ovp_matmul_plain(
                    a, None, codes, sw, w_dtype="int4", a_mode="fp",
                    a_dtype="int4", fill=fill)

            got, ref = kern(), plain()
            torch.cuda.synchronize()
            plan = mm.grouped_launch_plan(b, e, c, k, n, "int4",
                                          filled=True)
            blocks = mm.grouped_grid_blocks(plan, "int4")
            g, r = got[live], ref[live]
            err = float((g - r).abs().max())
            scale = float(r.abs().max())
            if not within(g, r, 1e-5, 1e-5 * scale):
                fail(f"K6 {label} B={b} E={e} C={c} K={k} N={n} with fill: "
                     f"max abs err {err:.3e} on filled rows over tolerance "
                     f"(rtol 1e-5, atol 1e-5*{scale:.3e})")
            if not bool(torch.isfinite(ref[~live]).all()) or \
                    bool((ref[~live] != 0).any()):
                fail(f"K6 {label}: the plain version's rows past the fill "
                     f"are not zeros")
            worst = max(worst, err)
            calls = [lambda i=i: kern(i) for i in range(K6_LAYERS)]

            def cold():
                for fn in calls:
                    fn()

            ms = time_ms(cold, 12)[0] / K6_LAYERS
            warm_ms, wall = time_ms(kern)
            all_ms, _ = time_ms(lambda: kern(0, None))
            plain_ms, _ = time_ms(plain, 10)
            lib_ms, _ = time_ms(
                lambda: torch.einsum("beck,ekn->becn", a, dense[(k, n)]), 10)
            n_bytes = touched * (k // 2 * n + 4 * n) \
                + filled * (k * 4 + n * 4) + b * e * 4
            b_ms, b_by = bound_ms(n_bytes, 2.0 * filled * k * n)
            stack_ms = (e * (k // 2 * n + 4 * n)) / HBM_BYTES_PER_S * 1e3
            rec = dict(shape=label, B=b, E=e, C=c, K=k, N=n,
                       touched_experts=touched, filled_rows=filled,
                       grid_blocks=blocks, split=plan.split,
                       max_abs_err=err, ms=ms, warm_ms=warm_ms,
                       wall_ms=wall, all_rows_ms=all_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                       stack_bytes_ms=stack_ms)
            rows_out.append(rec)
            if label == "decode":
                for key in ("ms", "warm_ms", "all_rows_ms", "plain_ms",
                            "bound_ms", "library_ms", "stack_bytes_ms"):
                    decode[key] += layer.count((k, n)) * rec[key]
                decode["bound_by"] = b_by
            print(f"[k6] {label:7s} B={b} E={e} C={c} K={k:4d} N={n:4d} "
                  f"fill: {touched} experts touched, {filled} rows; "
                  f"persistent grid {blocks} blocks (split {plan.split}, "
                  f"{plan.smem} shared bytes a block); "
                  f"err={err:.2e} on filled rows (tol rtol 1e-5, atol "
                  f"1e-5*max|ref|) kernel={ms:.4f}ms cold L2 ({warm_ms:.4f}"
                  f"ms warm, eager call {wall:.4f}ms; every row without "
                  f"the fill {all_ms:.4f}ms) plain={plain_ms:.4f}ms "
                  f"einsum(dequantized stack)={lib_ms:.4f}ms bound="
                  f"{b_ms:.5f}ms ({b_by}); reading the whole stack would "
                  f"take {stack_ms:.4f}ms")
    print(f"[k6] one MoE layer's 3 decode launches (wg, wu, wd) with the "
          f"fill: kernel {decode['ms']:.4f}ms cold L2 ({decode['warm_ms']:.4f}"
          f"ms warm; every row {decode['all_rows_ms']:.4f}ms), bound "
          f"{decode['bound_ms']:.4f}ms ({decode['bound_by']}), plain "
          f"{decode['plain_ms']:.4f}ms, einsum {decode['library_ms']:.4f}ms;"
          f" whole stacks at 3.35 TB/s {decode['stack_bytes_ms']:.4f}ms")
    k6_fill_paths(dev, gen, stacks, fills)
    del stacks, dense
    return rows_out, worst, decode


def k6_fill_paths(dev, gen, stacks, fills):
    """The K6 paths the served shapes do not reach, at K 2048 -> N 768
    (wg): the FMA body (K slices too large for shared memory) forced on
    the decode (B 4: 16-row tiles) and prefill (B 1: 8-row tiles) fills;
    a fill of B 72 x E 128 entries, above the FILL_SMEM that K6 caches in
    shared memory, so every block reads it from global memory; each held
    to the plain version on the filled rows (rtol 1e-5, atol 1e-5 *
    max|ref|). Then the decode launch with a fill that touches one expert
    (one row) and with a fill of zeros, timed with cold L2 as k6_phase
    does, beside the time to read the whole stack: both must stay under
    half of it, since they read at most one expert's weights."""
    import torch
    from repro_torch.kernels import ovp_matmul as mm

    e, c, k, n = 128, 4, 2048, 768
    codes, sw = stacks[(k, n)][0]
    stack_ms = (e * (k // 2 * n + 4 * n)) / HBM_BYTES_PER_S * 1e3
    big = 72
    cases = [(f"FMA body, {label} fill", b, fill,
              mm.grouped_launch_plan(b, e, c, k, n, "int4", body="fma"))
             for label, (b, fill) in fills.items()]
    cases.append((f"B {big} x E {e} = {big * e} fill entries (over "
                  f"{mm._FILL_SMEM}: read from global memory)", big,
                  _routed_fill(gen, dev, big, 1), None))
    for label, b, fill, plan in cases:
        a = torch.randn((b, e, c, k), generator=gen, device=dev)
        got = mm.run_grouped(a, None, codes, sw, w_dtype="int4",
                             a_mode="fp", fill=fill, plan=plan)
        ref = mm.grouped_ovp_matmul_plain(a, None, codes, sw, w_dtype="int4",
                                          a_mode="fp", a_dtype="int4",
                                          fill=fill)
        torch.cuda.synchronize()
        live = torch.arange(c, device=dev) < fill[..., None]
        g, r = got[live], ref[live]
        err = float((g - r).abs().max())
        if not within(g, r, 1e-5, 1e-5 * float(r.abs().max())):
            fail(f"K6 {label}: max abs err {err:.3e} on filled rows over "
                 f"tolerance (rtol 1e-5, atol 1e-5*max|ref|)")
        print(f"[k6 paths] {label}: B={b} E={e} C={c} K={k} N={n}, "
              f"{int(fill.sum())} filled rows, err={err:.2e} (tol rtol "
              f"1e-5, atol 1e-5*max|ref|)")
    b = 4
    a = torch.randn((b, e, c, k), generator=gen, device=dev)
    one = torch.zeros((b, e), dtype=torch.int32, device=dev)
    one[1, 37] = 1
    for label, fill in (("one expert, one row", one),
                        ("no expert", torch.zeros_like(one))):
        def cold(f=fill):
            for cw, cs in stacks[(k, n)]:
                mm.run_grouped(a, None, cw, cs, w_dtype="int4", a_mode="fp",
                               fill=f)

        ms = time_ms(cold, 12)[0] / len(stacks[(k, n)])
        print(f"[k6 paths] decode B={b} E={e} C={c} K={k} N={n}, fill "
              f"touching {label}: kernel={ms:.4f}ms cold L2; reading the "
              f"whole stack would take {stack_ms:.4f}ms")
        if ms >= stack_ms / 2:
            fail(f"K6 with a fill touching {label} took {ms:.4f}ms, not "
                 f"under half the whole stack's read time {stack_ms:.4f}ms")


K6_BODY_ROWS = (4, 8, 16, 32, 64)   # rows per expert, both K6 bodies


def k6_body_phase(dev):
    """K6 without a fill (the API's all-rows call) with each of its two
    bodies forced (`run_grouped(plan=)`), at E 8, K = N = 1024 and B 1 x
    C rows per expert for C in K6_BODY_ROWS, in fp (int4), quantize (int4,
    per-slot scale) and codes8 (int8 weights and activations) modes;
    each result held to the plain version (rtol 1e-5, atol 1e-5 *
    max|ref|) and timed, beside the body `grouped_launch_plan` picks.
    The FMA body runs 8-row tiles up to 8 rows an expert, 16-row tiles
    above. Returns {(mode, rows): {body: ms}}."""
    import torch
    from repro_torch.core import policy
    from repro_torch.core.ovp import ovp_quantize
    from repro_torch.core.qlinear import quantize_weight
    from repro_torch.core.quantizer import sigma_init_scale
    from repro_torch.kernels import ovp_matmul as mm

    gen = torch.Generator(device=dev).manual_seed(9)
    e, k, n = 8, 1024, 1024
    w = torch.randn((e, k, n), generator=gen, device=dev) / k ** 0.5
    w4 = quantize_weight(w, policy.OLIVE_W4.replace_all(
        compute_dtype="float32"))
    w8 = quantize_weight(w, policy.OLIVE_W8A8.replace_all(
        compute_dtype="float32", abits=0))
    out = {}
    for c in K6_BODY_ROWS:
        a = torch.randn((1, e, c, k), generator=gen, device=dev)
        a.view(-1)[::13] *= 25.0
        s4 = float(sigma_init_scale(a, "int4"))
        s8 = float(sigma_init_scale(a, "int8"))
        x8 = ovp_quantize(a, s8, "int8").data
        cases = {
            "fp": (a, None, w4, dict(w_dtype="int4", a_mode="fp",
                                     a_dtype="int4")),
            "quantize": (a, torch.full((1, e, c), s4, device=dev), w4,
                         dict(w_dtype="int4", a_mode="quantize",
                              a_dtype="int4")),
            "codes8": (x8, torch.full((1, e, c), s8, device=dev), w8,
                       dict(w_dtype="int8", a_mode="codes8",
                            a_dtype="int8")),
        }
        for mode, (lhs, sa, qt, kw) in cases.items():
            sw = qt.scale.reshape(e, n).contiguous()
            ref = mm.grouped_ovp_matmul_plain(lhs, sa, qt.data, sw, **kw)
            picked = mm.grouped_launch_plan(1, e, c, k, n, kw["w_dtype"],
                                            mode).body
            times = {}
            for body in mm.BODIES:
                plan = mm.grouped_launch_plan(1, e, c, k, n, kw["w_dtype"],
                                              mode, body=body)

                def call(plan=plan):
                    return mm.run_grouped(lhs, sa, qt.data, sw, plan=plan,
                                          **kw)

                got = call()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                if not within(got, ref, 1e-5, 1e-5 * float(ref.abs().max())):
                    fail(f"K6 {body} body, {mode}, E={e} C={c} K={k} N={n}:"
                         f" max abs err {err:.3e} against the plain version")
                times[body] = time_ms(call)[0]
            out[(mode, c)] = times
            print(f"[k6 bodies] {mode:8s} E={e} C={c:2d} K={k} N={n} no fill:"
                  f" decode body {times['decode']:.4f}ms, FMA body "
                  f"{times['fma']:.4f}ms; the plan picks {picked}; both "
                  f"within rtol 1e-5, atol 1e-5*max|ref| of the plain "
                  f"version")
    return out


def k6_api_phase(dev):
    """K6 in every activation mode through the kernel API as a user calls
    it (`kernels.ops.grouped_ovp_matmul`), at E 8, C (rows per expert)
    32, K = N = 1024, on outlier-laden activations: quantize and static
    (in-kernel OVP at the 3-sigma scale, per-slot or by value), codes4
    (packed by K7 at that scale) and codes8 with int8 weights; and a
    per-expert mixed W4/W8 stack (`MixedExpertQuant`, expert 1 at W8)
    through `backends.dispatch`. Counters are reset just before and read
    just after; every result is held against its plain version on the
    card (the mixed stack against the same dispatch on the CPU), rtol
    1e-5 + atol 1e-5 * max|ref|, and each mode is timed beside its plain
    version and `torch.matmul` on the dequantized operands."""
    import dataclasses

    import torch
    from repro_torch import backends
    from repro_torch.core import policy
    from repro_torch.core.ovp import (QuantizedTensor, ovp_dequantize,
                                      ovp_quantize)
    from repro_torch.core.qlinear import quantize_params
    from repro_torch.core.quantizer import sigma_init_scale
    from repro_torch.kernels import ops
    from repro_torch.kernels import ovp_encode as enc
    from repro_torch.kernels import ovp_matmul as mm

    gen = torch.Generator(device=dev).manual_seed(8)
    e, c, k, n = 8, 32, 1024, 1024
    w = torch.randn((e, k, n), generator=gen, device=dev) / k ** 0.5
    w4p = policy.OLIVE_W4.replace_all(compute_dtype="float32")
    w8p = policy.OLIVE_W8A8.replace_all(compute_dtype="float32", abits=0)
    qt4 = quantize_params({"experts": {"wg": w}}, w4p)["experts"]["wg"]
    qt8 = quantize_params({"experts": {"wg": w}}, w8p)["experts"]["wg"]
    prog = policy.PolicyProgram(rules=(("experts/*/1", w8p),), default=w4p)
    mixed = quantize_params({"experts": {"wg": w}}, prog)["experts"]["wg"]
    a = torch.randn((e, c, k), generator=gen, device=dev)
    a.view(-1)[::13] *= 25.0
    s4 = float(sigma_init_scale(a, "int4"))
    s8 = float(sigma_init_scale(a, "int8"))
    x8 = ovp_quantize(a, s8, "int8")
    sw4 = qt4.scale.reshape(e, n).contiguous()
    sw8 = qt8.scale.reshape(e, n).contiguous()
    sa4 = torch.full((1, e, c), s4, device=dev)
    sa8 = torch.full((1, e, c), s8, device=dev)
    s4_dev = torch.tensor(s4, device=dev)

    reset_counts()
    packed = enc.fused_ovp_encode(
        (a * mm._reciprocal(s4)).reshape(-1, k)).reshape(e, c, k // 2)
    x4 = QuantizedTensor(packed, s4_dev, "int4", -1, k)
    calls = {
        "quantize": lambda: ops.grouped_ovp_matmul(
            a, qt4, a_dtype="int4", act_scale=s4_dev),
        "static": lambda: ops.grouped_ovp_matmul(a, qt4, a_dtype="int4",
                                                 static_act_scale=s4),
        "codes4": lambda: ops.grouped_ovp_matmul(x4, qt4),
        "codes8": lambda: ops.grouped_ovp_matmul(x8, qt8),
    }
    got = {mode: fn() for mode, fn in calls.items()}
    got["mixed"] = backends.dispatch(a, mixed, w4p)
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(counts, "K6 API phase",
                 ("ovp_encode", "grouped[quantize]", "grouped[static]",
                  "grouped[codes4]", "grouped[codes8]", "grouped[fp]"))
    a4 = a[None]
    kq = dict(w_dtype="int4", a_mode="quantize", a_dtype="int4")
    k5 = dict(w_dtype="int4", a_mode="static", a_dtype="int4", s_static=s4)
    c4 = dict(w_dtype="int4", a_mode="codes4", a_dtype="int4")
    c8 = dict(w_dtype="int8", a_mode="codes8", a_dtype="int8")
    plains = {
        "quantize": lambda: mm.grouped_ovp_matmul_plain(
            a4, sa4, qt4.data, sw4, **kq)[0],
        "static": lambda: mm.grouped_ovp_matmul_plain(
            a4, None, qt4.data, sw4, **k5)[0],
        "codes4": lambda: mm.grouped_ovp_matmul_plain(
            packed[None], sa4, qt4.data, sw4, **c4)[0],
        "codes8": lambda: mm.grouped_ovp_matmul_plain(
            x8.data[None], sa8, qt8.data, sw8, **c8)[0],
    }
    dense = {"quantize": (ovp_dequantize(x4), ovp_dequantize(qt4)),
             "codes8": (ovp_dequantize(x8), ovp_dequantize(qt8))}
    dense["static"] = dense["codes4"] = dense["quantize"]
    rows = {}
    for mode, plain in plains.items():
        g, r = got[mode], plain()
        torch.cuda.synchronize()
        err = float((g - r).abs().max())
        if g.shape != (e, c, n) or not within(
                g, r, 1e-5, 1e-5 * float(r.abs().max())):
            fail(f"K6 API phase: {mode} {tuple(g.shape)} against its plain "
                 f"version: max abs err {err:.3e}")
        ad, wd = dense[mode]
        (ms, wall), (plain_ms, _) = time_ms(calls[mode]), time_ms(plain)
        lib_ms, _ = time_ms(lambda: torch.matmul(ad, wd))
        a_bytes = {"quantize": e * c * k * 4, "static": e * c * k * 4,
                   "codes4": e * c * k // 2, "codes8": e * c * k}[mode]
        w_bytes = e * k * n if mode == "codes8" else e * k * n // 2
        n_bytes = a_bytes + w_bytes + e * n * 4 + e * c * n * 4 \
            + (0 if mode == "static" else e * c * 4)
        b_ms, b_by = bound_ms(n_bytes, 2.0 * e * c * k * n)
        rows[mode] = dict(max_abs_err=err, ms=ms, wall_ms=wall,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by)
        print(f"[k6 api] {mode:8s} E={e} C={c} K={k} N={n} err={err:.2e} "
              f"(tol rtol 1e-5, atol 1e-5*max|ref|) kernel={ms:.4f}ms "
              f"(eager call {wall:.4f}ms) plain={plain_ms:.4f}ms "
              f"matmul(dequantized)={lib_ms:.4f}ms bound={b_ms:.5f}ms "
              f"({b_by})")
    cpu = [dataclasses.replace(q, data=q.data.cpu(), scale=q.scale.cpu())
           for q in mixed.groups]
    ref = backends.dispatch(a.cpu(), dataclasses.replace(
        mixed, groups=tuple(cpu)), w4p)
    g = got["mixed"].cpu()
    err = float((g - ref).abs().max())
    if g.shape != (e, c, n) or not within(g, ref, 1e-5,
                                          1e-5 * float(ref.abs().max())):
        fail(f"K6 API phase: mixed W4/W8 stack against the CPU: max abs err "
             f"{err:.3e}")
    ids = {q.normal_dtype: i for q, i in zip(mixed.groups,
                                             mixed.expert_ids)}
    print(f"[k6 api] MixedExpertQuant groups {ids} through "
          f"backends.dispatch: err={err:.2e} against the CPU plain path (tol "
          f"rtol 1e-5, atol 1e-5*max|ref|); launches "
          + " ".join(f"{key}={counts[key]}" for key in
                     ("ovp_encode", "grouped[quantize]", "grouped[static]",
                      "grouped[codes4]", "grouped[codes8]", "grouped[fp]"))
          + f", dispatch {counts['dispatch']}")
    return rows, counts


def free_device_memory() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def serve_phase_e(dev):
    """MoE serving through the launcher's entry point: Qwen3-30B-A3B at
    full published width (`--arch qwen3-moe-30b-a3b --quant
    olive_serve`, W4 OVP experts and attention, 4-bit OVP KV cache, fp32
    activations), phase A's 8 prompts and seed, 16 new tokens, 4 slots,
    max_len 256, first slab, then paged (`--paged 16 --prefill-chunk
    16`). The launcher draws and quantizes one layer at a time. Counters
    are reset just before and read just after each run: no dispatch
    fallback, every expert matmul on K6 (`grouped[fp]` = `cuda[stacked]`
    = 3 x layers x forward calls), K2 in the slab run, K3 and K4 in the
    paged run, every page returned. The slab model is profiled over
    decode steps and held against the CPU
    (`truncated_reference_check`), and
    freed before the paged one loads, so each run's peak memory counts
    one model. Returns each run's tokens and counts, and the profile."""
    import torch
    from repro_torch.launch import serve
    base = ["--arch", MOE_ARCH, "--quant", "olive_serve", "--requests", "8",
            "--max-new", "16", "--slots", "4", "--max-len", "256",
            "--seed", "0"]
    runs, prof, prof_paged = {}, None, None
    for label, extra, kernels in (
            ("slab", [], ("grouped[fp]", "ovp_matmul[fp]", "decode_attn",
                          "ovp_encode")),
            ("paged", ["--paged", "16", "--prefill-chunk", "16"],
             ("grouped[fp]", "ovp_matmul[fp]", "paged_decode_attn",
              "prefill_attn", "ovp_encode"))):
        free_device_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        res = serve.run(base + extra, device=dev)
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        phase = f"serve phase E ({label})"
        check_counts(counts, phase, kernels)
        check_attn_counts(res, counts, phase, paged=label == "paged")
        check_encode_counts(res["engine"], counts, phase)
        n_layers = res["model"].cfg.n_layers
        st = res["engine"].stats()
        forwards = st["prefills_run"] + st["prefill_chunks_run"] \
            + st["decodes_run"]
        want = 3 * n_layers * forwards
        if counts["grouped[fp]"] != want or \
                counts["dispatch"].get("cuda[stacked]", 0) != want:
            fail(f"{phase}: grouped[fp] launches {counts['grouped[fp]']}, "
                 f"stacked dispatches "
                 f"{counts['dispatch'].get('cuda[stacked]', 0)}, expected "
                 f"3 x {n_layers} layers x {forwards} forward calls = "
                 f"{want}")
        done = res["completed"]
        if len(done) != 8 or any(len(r.out_tokens) != 16 for r in done):
            fail(f"{phase}: {len(done)} requests finished with "
                 f"{[len(r.out_tokens) for r in done]} tokens, expected "
                 f"8 x 16")
        if label == "paged":
            pool = st["page_pool"]
            if pool["used_pages"] != 0 or pool["allocs"] != pool["frees"]:
                fail(f"{phase}: pages not all returned: {pool}")
        print(f"[serve E] {MOE_ARCH} ({n_layers} layers, the published "
              f"depth) W4 "
              f"experts + KV4, {label}: PTQ {res['ptq_s']:.2f}s (layer by "
              f"layer), peak device memory {peak_gb:.2f} GB, "
              f"{res['tokens']} tokens in {res['seconds']:.3f}s = "
              f"{res['tok_per_s']:.2f} tok/s, mean TTFT "
              f"{res['mean_ttft_s'] * 1e3:.2f}ms, mean step "
              f"{res['mean_step_s'] * 1e3:.2f}ms, {forwards} forward calls, "
              f"launches "
              + " ".join(f"{key}={counts[key]}" for key in kernels)
              + f", dispatch {counts['dispatch']}")
        audit_check(res["engine"], phase)
        capture_gate(res["engine"], f"E ({label})", steps=3)
        if label == "slab":
            prof = capture_ab(res, "E", steps=3, max_new=10)["graph"]
            truncated_reference_check(res, dev)
        else:
            prof_paged = profile_decode(
                res, f"{MOE_ARCH}, W4 experts + KV4, paged 16", steps=3,
                max_new=10)
        runs[label] = {"tokens": {r.uid: r.out_tokens for r in done},
                       "counts": counts, "tok_per_s": res["tok_per_s"],
                       "peak_gb": peak_gb}
        del res, done
    differ = sum(int(x != y) for uid, t in runs["paged"]["tokens"].items()
                 for x, y in zip(t, runs["slab"]["tokens"][uid]))
    print(f"[serve E] paged vs slab: {differ} of 128 tokens differ "
          f"(reported, not bounded: a 16-token chunk and a whole-prompt "
          f"prefill have other capacities, so they drop other tokens, as "
          f"in the reference); peak device memory slab "
          f"{runs['slab']['peak_gb']:.2f} GB, paged "
          f"{runs['paged']['peak_gb']:.2f} GB (one model each)")
    if prof is not None and prof["k6_ms"] is not None:
        print(f"[serve E] decode step (slab, 4 slots): K6 "
              f"{prof['k6_ms']:.3f} device ms per step, K2 "
              f"{prof['attn_ms']:.3f}, paged K3 {prof_paged['attn_ms']:.3f}, "
              f"device busy {prof['busy_ms']:.3f}ms = "
              f"{100 * prof['busy_ms'] / prof['prof_ms']:.1f}% of the "
              f"profiled wall; tok/s slab {runs['slab']['tok_per_s']:.2f}, "
              f"paged {runs['paged']['tok_per_s']:.2f}")
    return runs


def truncated_reference_check(res, dev, label: str = "W4 experts",
                              paged: bool = False, tag: str = "E"):
    """A 2-layer truncation of the served full-width model (same widths,
    the same quantized params) over an fp32 KV cache, on the card against
    the CPU's plain versions: prefill of one prompt + 2 greedy decode
    steps (`_logits_on`), or with `paged` a 24-token prompt prefilled in
    16-token chunks onto shuffled pages + 2 decode steps through the
    block table (`_paged_logits_on`: K4 and K3 over fp32 pools). On a
    MoE model the routed expert indices of every MoE call must be equal
    first (a router near-tie summed in another order can pick another
    expert, which moves the logits far more than rounding: the failure
    says so); then the greedy tokens must be equal and max |logit diff|
    <= 1e-3 * max|ref|, the bound of the other logit checks."""
    import dataclasses

    import torch
    from repro_torch.models.layers import recording_routes
    from repro_torch.models.model import build_model
    model, params = res["model"], res["params"]
    name = model.cfg.name
    small = build_model(dataclasses.replace(model.cfg, n_layers=2),
                        model.policy.replace_all(kv_bits=0))
    p2 = dict(params, layers=params["layers"][:2])
    if paged:
        def logits(device, tree):
            return _paged_logits_on(small, tree, device, PROMPT * 3)
        what = "chunked paged prefill (2 x 16)"
    else:
        def logits(device, tree):
            return _logits_on(small, tree, device)
        what = "prefill"
    with recording_routes() as r_dev:
        got = logits(dev, p2)
    with recording_routes() as r_cpu:
        ref = logits("cpu", _to(p2, "cpu"))
    if len(r_dev) != len(r_cpu):
        fail(f"{name} reference check: {len(r_dev)} MoE calls on the card, "
             f"{len(r_cpu)} on the CPU")
    for i, (x, y) in enumerate(zip(r_dev, r_cpu)):
        if not torch.equal(x.cpu(), y):
            n_diff = int((x.cpu() != y).sum())
            fail(f"{name} reference check: ROUTING differs at MoE call {i} "
                 f"(layer {i % 2}): {n_diff} of {y.numel()} routed expert "
                 f"indices differ between card and CPU (router logits "
                 f"summed in another order picked another expert at a "
                 f"near-tie); the logits were not compared")
    v = small.cfg.vocab
    if got.shape != (3, small.cfg.padded_vocab) or \
            not bool(torch.isfinite(got).all()):
        fail(f"{name} reference check: logits shape {tuple(got.shape)} or "
             f"non-finite values")
    err = float((got[:, :v] - ref[:, :v]).abs().max())
    tol = 1e-3 * float(ref[:, :v].abs().max())
    same = bool(torch.equal(got.argmax(-1), ref.argmax(-1)))
    routes = (f"routed expert indices equal in all {len(r_dev)} MoE calls, "
              if r_dev else "")
    print(f"[ref {tag}] {name} truncated to 2 layers, {label}, fp32 KV: "
          f"{what} + 2 decode steps, card vs CPU plain versions: {routes}"
          f"max |diff| {err:.3e} (tol {tol:.3e} = 1e-3 * max|ref|), greedy "
          f"tokens {'equal' if same else 'differ'}")
    if err > tol or not same:
        fail(f"{name} reference check: card and CPU disagree")



# --------------------------------------------------------------------------
# The rest of the serving CLI: the async front end and mixed W4/W8 programs
# --------------------------------------------------------------------------
TRACE_DIR = os.path.join(ROOT, "build", "traces")
MIXED_CALIB = os.path.join(ROOT, "build", "calib", f"{ARCH}-mixed_w48.json")
W8_EXPERTS = 8          # mixed E: experts 0-7 of every stack at W8
MIXED_E_LAYERS = 12     # mixed E's depth, cut from the published 48 for time
SERVE_ARGS = ["--requests", "8", "--max-new", "16", "--slots", "4",
              "--max-len", "256", "--seed", "0"]


def launcher_prompts(vocab: int, n: int = 8, seed: int = 0):
    """The launcher's synthetic workload: `n` prompts of 4-31 tokens."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(4, 32)))
            .astype(np.int32) for _ in range(n)]


def async_phase_a(dev, res_a, smi: str):
    """Phase A's model and params through fresh engines driven by the
    asyncio front end (`AsyncFrontend` feeding a `MetricsLedger`), slab,
    then paged 16 with chunk 16, on the launcher's workload (8 prompts of
    4-31 tokens, 16 new tokens each). Counters are reset just before and
    read just after each async run: no fallback, one attention launch a
    layer a step or chunk, K7 twice a layer a cache write. Checks: greedy
    tokens equal to a drained run of a fresh engine of the same config;
    the decode step built (captured) once, on the front end's step
    thread, not the caller's; the trace audit; graph against eager
    (`capture_gate`); the JSONL trace written under build/traces and read
    back by `load_trace` equal to the ledger's records and summary. TTFT
    and TPOT are printed beside the card. Returns each run's snapshot
    and counts."""
    import asyncio
    import threading

    from repro_torch.launch.serve import _fmt_dist
    from repro_torch.serve import AsyncFrontend, MetricsLedger, load_trace
    from repro_torch.serve.engine import EngineCfg, ServingEngine
    from repro_torch.serve.paging import PagePoolCfg
    t_phase = time.perf_counter()
    model, params = res_a["model"], res_a["params"]
    prompts = launcher_prompts(model.cfg.vocab)
    os.makedirs(TRACE_DIR, exist_ok=True)
    caller = threading.get_ident()

    async def serve(eng, ledger):
        async def consume(stream):
            return [tok async for tok in stream]

        async with AsyncFrontend(eng, metrics=ledger) as fe:
            streams = [fe.submit(p, max_new_tokens=16) for p in prompts]
            toks = await asyncio.gather(*(consume(s) for s in streams))
        return {s.uid: t for s, t in zip(streams, toks)}

    runs = {}
    for label, extra, kernels in (
            ("slab", {}, ("ovp_matmul[fp]", "decode_attn", "ovp_encode")),
            ("paged", dict(page_pool=PagePoolCfg(16), prefill_chunk=16),
             ("ovp_matmul[fp]", "paged_decode_attn", "prefill_attn",
              "ovp_encode"))):
        phase = f"async A ({label})"
        cfg = EngineCfg(batch_slots=4, max_len=256, **extra)
        drained = ServingEngine(model, params, cfg, device=dev)
        for p in prompts:
            drained.submit(p, max_new_tokens=16)
        want = {r.uid: r.out_tokens for r in drained.run_until_drained()}
        del drained
        free_device_memory()
        # the launcher's device, "cuda" without an index: the front end
        # sets its step thread's device from it
        eng = ServingEngine(model, params, cfg, device="cuda")
        builds = []

        def on_build(built=eng._decode.on_build):
            builds.append(threading.get_ident())
            built()

        eng._decode.on_build = on_build
        ledger = MetricsLedger()
        reset_counts()
        t0 = time.perf_counter()
        got = asyncio.run(serve(eng, ledger))
        wall = time.perf_counter() - t0
        counts = read_counts()
        res = {"engine": eng, "model": model}
        check_counts(counts, phase, kernels)
        check_attn_counts(res, counts, phase, paged=label == "paged")
        check_encode_counts(eng, counts, phase)
        if got != want:
            differ = sum(int(x != y) for uid, t in got.items()
                         for x, y in zip(t, want.get(uid, [])))
            fail(f"{phase}: async tokens differ from the drained run "
                 f"({differ} tokens, uids {sorted(got)} vs {sorted(want)})")
        if len(builds) != 1 or builds[0] == caller or \
                eng._decode.graph is None:
            fail(f"{phase}: the decode step was not captured once on the "
                 f"front end's step thread (builds on threads {builds}, "
                 f"caller {caller})")
        snap = ledger.snapshot()
        if snap["fallbacks"] or snap["requests"] != 8 or \
                snap["tokens"] != 128 or snap["steps"] != eng.steps_run:
            fail(f"{phase}: ledger summary {snap}")
        path = os.path.join(TRACE_DIR, f"async_a_{label}.jsonl")
        ledger.write_jsonl(path)
        trace = load_trace(path)
        if (trace["meta"], trace["steps"], trace["requests"],
                trace["summary"]) != (ledger.meta, ledger.step_records,
                                      ledger.request_records, snap):
            fail(f"{phase}: the trace read back differs from the ledger")
        inter = snap["prefill_interleave_ratio"]
        print(f"[async A] {ARCH} W4 + KV4 {label} through AsyncFrontend: "
              f"{snap['tokens']} tokens in {snap['steps']} steps, "
              f"{wall:.3f}s = {snap['tokens'] / wall:.1f} tok/s; greedy "
              f"tokens equal to the drained run; decode step captured once "
              f"on the front end's step thread; fallbacks 0; trace "
              f"{os.path.relpath(path, ROOT)} ({len(trace['steps'])} step "
              f"and {len(trace['requests'])} request records) read back "
              f"equal; launches "
              + " ".join(f"{k}={counts[k]}" for k in kernels)
              + (f"; interleave {inter:.2f}" if inter is not None else ""))
        print(f"[async A] {label} SLO ({smi}): TTFT "
              f"{_fmt_dist(snap['ttft_s'], 3)} | TPOT "
              f"{_fmt_dist(snap['tpot_s'], 3)} | latency "
              f"{_fmt_dist(snap['latency_s'], 3)}")
        audit_check(eng, phase)
        capture_gate(eng, phase)
        runs[label] = {"snapshot": snap, "counts": counts}
        del eng, res
    print(f"[async A] phase took {time.perf_counter() - t_phase:.1f}s")
    return runs


def check_k1_weight_counts(res, counts, phase: str, mode: str = "fp"):
    """K1 runs once per quantized linear (7 a layer; the head stays fp)
    per forward call, all in `mode`, and the launches with int8 weights
    are the W8 linears' (counted off the tree's leaves) each forward
    call. Returns the W8 linears' count."""
    from repro_torch.core.ovp import QuantizedTensor
    st = res["engine"].stats()
    forwards = st["prefills_run"] + st["prefill_chunks_run"] \
        + st["decodes_run"]
    leaves = [w for layer in res["params"]["layers"]
              for sub in ("attn", "mlp") for w in layer[sub].values()
              if isinstance(w, QuantizedTensor)]
    n_w8 = sum(w.normal_dtype == "int8" for w in leaves)
    want = {f"ovp_matmul[{mode}]": len(leaves) * forwards,
            "ovp_matmul<int8>": n_w8 * forwards,
            "ovp_matmul<int4>": (len(leaves) - n_w8) * forwards}
    got = {key: counts[key] for key in want}
    if got != want or len(leaves) != 7 * res["model"].cfg.n_layers:
        fail(f"{phase}: K1 launches {got}, expected {want} ({len(leaves)} "
             f"quantized linears, {n_w8} at W8, {forwards} forward calls)")
    return n_w8


def k1_layer_record(dev, gen, linears, rows: int, w_dtype: str,
                    mode: str = "fp", label: str = "k1"):
    """K1 at `linears` (one QuantizedTensor a launch) on `rows` rows of
    random activations, in `mode` (fp, or static: activations at one
    scale in `w_dtype`'s width, K5), against the plain version (rtol
    1e-5, atol 1e-5 * max|ref|, K1's tolerance), timed beside it,
    `torch.matmul` on the dequantized fp32 weight and the byte bound;
    prints each launch's plan (body, split, slice) and record. Returns
    the records summed over the launches (the worst error)."""
    import torch
    from repro_torch.core.ovp import ovp_dequantize
    from repro_torch.core.quantizer import sigma_init_scale
    from repro_torch.kernels import ovp_matmul as mm
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    tot = dict(dict.fromkeys(keys, 0.0), max_abs_err=0.0, bound_by="bytes")
    w_bytes = {"int4": 0.5, "int8": 1.0}[w_dtype]
    for qt in linears:
        if qt.normal_dtype != w_dtype:
            fail(f"{label}: a {qt.normal_dtype} linear, expected {w_dtype}")
        k, n = qt.orig_dim, qt.data.shape[-1]
        a = torch.randn((rows, k), generator=gen, device=dev)
        sw = qt.scale.reshape(-1).contiguous()
        kw = dict(w_dtype=w_dtype, a_mode=mode, a_dtype=w_dtype)
        if mode == "static":
            kw["s_static"] = float(sigma_init_scale(a, w_dtype))

        def kern():
            return mm.run(a, None, qt.data, sw, **kw)

        def plain():
            return mm.fused_ovp_matmul_plain(a, None, qt.data, sw, **kw)

        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        plan = mm.launch_plan(rows, k, n, w_dtype)
        if not within(got, ref, 1e-5, 1e-5 * scale):
            fail(f"{label} {mode} rows={rows} K={k} N={n} ({plan.body} "
                 f"body, split {plan.split}, slice {plan.slice}): max abs "
                 f"err {err:.3e} over tolerance (rtol 1e-5, atol "
                 f"1e-5*{scale:.3e})")
        wd = ovp_dequantize(qt)
        b_ms, b_by = bound_ms(
            rows * k * 4 + k * n * w_bytes + n * 4 + rows * n * 4,
            2.0 * rows * k * n)
        rec = dict(ms=time_ms(kern)[0], plain_ms=time_ms(plain)[0],
                   bound_ms=b_ms,
                   library_ms=time_ms(lambda: torch.matmul(a, wd))[0])
        del wd
        print(f"[{label}] {mode} rows={rows} K={k:5d} N={n:5d}: "
              f"{plan.body} body, split {plan.split}, slice {plan.slice} "
              f"pairs, {plan.blocks} blocks, {plan.smem} shared bytes; "
              f"err={err:.2e} (tol rtol 1e-5, atol 1e-5*max|ref|) kernel="
              f"{rec['ms']:.4f}ms plain={rec['plain_ms']:.4f}ms matmul="
              f"{rec['library_ms']:.4f}ms bound={b_ms:.5f}ms ({b_by})")
        for key in keys:
            tot[key] += rec[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["bound_by"] = b_by
    return tot


def k1_w8_layer(dev, layer):
    """K1 with int8 weights at a served W8 layer's 7 linears (the
    quantized leaves of the mixed model's layer 0), rows 4, in fp mode
    and in static mode with 8-bit activations (K5's W8A8 path)
    (`k1_layer_record`). Returns {mode: summed record}."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(11)
    linears = [layer["attn"][n] for n in ("wq", "wk", "wv", "wo")] \
        + [layer["mlp"][n] for n in ("wg", "wu", "wd")]
    out = {}
    for mode in ("fp", "static"):
        tot = k1_layer_record(dev, gen, linears, 4, "int8", mode,
                              label="k1 w8")
        print(f"[k1 w8] the mixed model's W8 layer 0, 7 launches, rows 4, "
              f"int8 weights, {mode} mode"
              + (" (int8 activations at one scale: K5)" if mode == "static"
                 else "")
              + f": err {tot['max_abs_err']:.2e} (tol rtol 1e-5, atol "
              f"1e-5*max|ref|), kernel {tot['ms']:.4f}ms, plain "
              f"{tot['plain_ms']:.4f}ms, matmul {tot['library_ms']:.4f}ms, "
              f"bound {tot['bound_ms']:.5f}ms ({tot['bound_by']})")
        out[mode] = tot
    return out


def mixed_phase_a(dev, smi: str):
    """Mixed W4/W8 policy programs on full-width Qwen1.5-0.5B through the
    launcher's entry point, the launcher's workload: `--quant
    olive_mixed_w48` (layers 0 and 23 W8, the rest W4, fp32 KV: the
    launcher's rewrite leaves no packed cache), `--quant olive_owq_style`
    (every layer's wq and wk W8), and `olive_mixed_w48 --policy-rules
    "layers/0/attn/kv=olive_serve,layers/23/attn/kv=olive_serve"` slab
    and paged (16, chunk 16): packed caches on the first and last layer,
    fp32 between, in one captured step. Counters reset just before and
    read just after each run: no fallback; K1 168 launches a forward
    call, those with int8 weights exactly the W8 linears' (14 or 48 a
    call); one K2/K3 a layer a step over the fp and packed caches alike,
    one K4 a layer a chunk; K7 only on the packed layers. Each engine
    passes the audit and `capture_gate`; each program, slab and paged, is
    held to its CPU twin (`reference_check`), and the mixed-KV slab step
    is profiled. Then one `--calibrate` run of `olive_mixed_w48`: every
    linear on K5, the W8 layers with 8-bit activations. Returns the
    runs' counts, the mixed-KV profile and the K1 W8 timings."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    base = ["--arch", ARCH] + SERVE_ARGS
    last = get_config(ARCH).n_layers - 1
    mixed_kv = (f"layers/0/attn/kv=olive_serve,"
                f"layers/{last}/attn/kv=olive_serve")
    w8_want = {"olive_mixed_w48": 2 * 7, "olive_owq_style": 2 * (last + 1)}
    runs, prof, k1w8 = {}, None, None
    for label, extra, paged, packed in (
            ("w48", ["--quant", "olive_mixed_w48"], False, ()),
            ("owq", ["--quant", "olive_owq_style"], False, ()),
            ("w48 kv", ["--quant", "olive_mixed_w48", "--policy-rules",
                        mixed_kv], False, (0, last)),
            ("w48 kv paged", ["--quant", "olive_mixed_w48", "--policy-rules",
                              mixed_kv, "--paged", "16", "--prefill-chunk",
                              "16"], True, (0, last))):
        phase = f"mixed A ({label})"
        free_device_memory()
        reset_counts()
        res = serve.run(base + extra, device=dev)
        counts = read_counts()
        eng, model = res["engine"], res["model"]
        attn = "paged_decode_attn" if paged else "decode_attn"
        check_counts(counts, phase, ("ovp_matmul[fp]", attn))
        check_attn_counts(res, counts, phase, paged)
        check_encode_counts(eng, counts, phase)
        kinds = tuple(i for i, layer in enumerate(eng.caches["layers"])
                      if "k_data" in layer["kv"])
        if kinds != packed:
            fail(f"{phase}: packed KV caches on layers {kinds}, expected "
                 f"{packed}")
        n_w8 = check_k1_weight_counts(res, counts, phase)
        if n_w8 != w8_want[extra[1]]:
            fail(f"{phase}: {n_w8} W8 linears, expected "
                 f"{w8_want[extra[1]]}")
        done = res["completed"]
        if len(done) != 8 or any(len(r.out_tokens) != 16 for r in done):
            fail(f"{phase}: {len(done)} requests finished with "
                 f"{[len(r.out_tokens) for r in done]} tokens, expected "
                 f"8 x 16")
        print(f"[mixed A] {ARCH} {' '.join(extra)}: W8 linears {n_w8} of "
              f"{7 * (last + 1)}, packed KV on layers {list(kinds) or 'none'} (fp32 KV "
              f"elsewhere); PTQ {res['ptq_s']:.2f}s, {res['tokens']} tokens "
              f"in {res['seconds']:.3f}s = {res['tok_per_s']:.1f} tok/s, "
              f"mean TTFT {res['mean_ttft_s'] * 1e3:.2f}ms, mean step "
              f"{res['mean_step_s'] * 1e3:.2f}ms; launches ovp_matmul[fp]="
              f"{counts['ovp_matmul[fp]']} (<int8> "
              f"{counts['ovp_matmul<int8>']}, <int4> "
              f"{counts['ovp_matmul<int4>']}) {attn}={counts[attn]} "
              f"prefill_attn={counts['prefill_attn']} ovp_encode="
              f"{counts['ovp_encode']}, dispatch {counts['dispatch']} "
              f"({smi})")
        audit_check(eng, phase)
        capture_gate(eng, phase)
        reference_check(model, res["params"], dev, label=f"mixed {label}",
                        paged=paged)
        if label == "w48":
            k1w8 = k1_w8_layer(dev, res["params"]["layers"][0])
        if label == "w48 kv":
            prof = profile_decode(res, f"mixed W4/W8, KV4 on layers 0 and "
                                       f"{last}, fp32 KV between")
        runs[label] = {"counts": counts,
                       "tokens": {r.uid: r.out_tokens for r in done}}
        del res, eng, model, done
    phase = "mixed A (w48 calibrate)"
    free_device_memory()
    reset_counts()
    res = serve.run(base + ["--quant", "olive_mixed_w48", "--calibrate",
                            "--calibration", MIXED_CALIB], device=dev)
    counts = read_counts()
    check_counts(counts, phase, ("ovp_matmul[static]", "decode_attn"))
    if counts["ovp_matmul[quantize]"] or counts["ovp_matmul[fp]"]:
        fail(f"{phase}: the dynamic quantize or fp mode ran: {counts}")
    if counts["act_scale"].get("dynamic", 0) or \
            not counts["act_scale"].get("static", 0):
        fail(f"{phase}: act-scale resolutions {counts['act_scale']}")
    n_w8 = check_k1_weight_counts(res, counts, phase, mode="static")
    pol = res["model"].policy
    a_side = {i: (pol.resolve(f"layers/{i}/attn/wq").abits,
                  pol.resolve(f"layers/{i}/attn/wq").a_normal_dtype)
              for i in sorted({0, last // 2, last})}
    if a_side != {i: (8, "int8") if i in (0, last) else (4, "int4")
                  for i in a_side}:
        fail(f"{phase}: activation bits and dtypes {a_side}")
    print(f"[mixed A] calibrate-then-serve olive_mixed_w48: "
          f"{len(res['artifact'].sites())} scales calibrated in "
          f"{res['calib_s']:.2f}s; every linear on K5 "
          f"(ovp_matmul[static]={counts['ovp_matmul[static]']}, <int8> "
          f"{counts['ovp_matmul<int8>']} = {n_w8} W8A8 linears with 8-bit "
          f"activations x forward calls), act-scale resolutions "
          f"{counts['act_scale']}, {res['tokens']} tokens at "
          f"{res['tok_per_s']:.1f} tok/s ({smi})")
    audit_check(res["engine"], phase)
    capture_gate(res["engine"], phase)
    runs["w48 calibrate"] = {"counts": counts}
    del res
    print(f"[mixed A] phase took {time.perf_counter() - t_phase:.1f}s")
    return runs, prof, k1w8


def k6_mixed_layer(dev, experts):
    """K6 on each group of a served layer's two-group expert stacks (wg,
    wu, wd of the mixed model's layer 0: experts 0-7 int8, 8-127 int4),
    fp mode, with each group's share of a seeded top-8 decode routing's
    fill (B 4 slots, C 4): filled rows against the plain version, timed
    warm (one stack replayed) beside the plain version, `torch.einsum`
    on the group's dequantized stack and the bound of the group's
    touched experts. Returns {w_dtype: summed record over the 3
    stacks}."""
    import torch
    from repro_torch.core.ovp import ovp_dequantize
    from repro_torch.kernels import ovp_matmul as mm
    gen = torch.Generator(device=dev).manual_seed(13)
    n_experts = experts["wg"].n_experts
    fill = _routed_fill(gen, dev, 4, 1, e=n_experts, top_k=min(8, n_experts))
    b, c = 4, 4
    out = {}
    for leaf in ("wg", "wu", "wd"):
        w = experts[leaf]
        for qt, idx in zip(w.groups, w.group_index):
            eg = qt.data.shape[0]
            k, n = qt.orig_dim, qt.data.shape[-1]
            fg = torch.index_select(fill, 1, idx).contiguous()
            a = torch.randn((b, eg, c, k), generator=gen, device=dev)
            sw = qt.scale.reshape(eg, n).contiguous()
            kw = dict(w_dtype=qt.normal_dtype, a_mode="fp")

            def kern():
                return mm.run_grouped(a, None, qt.data, sw, fill=fg, **kw)

            def plain():
                return mm.grouped_ovp_matmul_plain(
                    a, None, qt.data, sw, a_dtype=qt.normal_dtype, fill=fg,
                    **kw)

            got, ref = kern(), plain()
            torch.cuda.synchronize()
            live = torch.arange(c, device=dev) < fg[..., None]
            g, r = got[live], ref[live]
            err = float((g - r).abs().max()) if r.numel() else 0.0
            scale = float(r.abs().max()) if r.numel() else 0.0
            if not within(g, r, 1e-5, 1e-5 * scale):
                fail(f"K6 mixed {leaf} {qt.normal_dtype} group (E {eg}): "
                     f"max abs err {err:.3e} on filled rows")
            dense = ovp_dequantize(qt)
            touched = int((fg.sum(0) > 0).sum())
            filled = int(fg.sum())
            per_expert = (k if qt.normal_dtype == "int8" else k // 2) * n \
                + 4 * n
            b_ms, b_by = bound_ms(touched * per_expert
                                  + filled * (k * 4 + n * 4) + b * eg * 4,
                                  2.0 * filled * k * n)
            tot = out.setdefault(qt.normal_dtype, dict(
                max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                library_ms=0.0, bound_by=b_by, experts=eg, touched=0,
                rows=0))
            tot["ms"] += time_ms(kern)[0]
            tot["plain_ms"] += time_ms(plain, 10)[0]
            tot["library_ms"] += time_ms(lambda: torch.einsum(
                "beck,ekn->becn", a, dense), 10)[0]
            tot["bound_ms"] += b_ms
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["touched"] += touched
            tot["rows"] += filled
            del dense
    for dt, tot in out.items():
        print(f"[k6 mixed] layer 0's {dt} group (E {tot['experts']}), 3 "
              f"launches (wg, wu, wd), fill {tot['touched']} expert stacks "
              f"touched, {tot['rows']} rows: err {tot['max_abs_err']:.2e} "
              f"(tol rtol 1e-5, atol 1e-5*max|ref|), kernel "
              f"{tot['ms']:.4f}ms warm L2, plain {tot['plain_ms']:.4f}ms, "
              f"einsum {tot['library_ms']:.4f}ms, bound "
              f"{tot['bound_ms']:.5f}ms ({tot['bound_by']})")
    return out


def mixed_phase_e(dev, smi: str, n_layers: int = MIXED_E_LAYERS):
    """Qwen3-30B-A3B at full published width, `n_layers` deep (a depth
    under the published 48 is served as a registered cut of the config),
    through the launcher's entry point, slab, `--quant olive_serve
    --policy-rules "*experts/*/[0-7]=olive_w8a8"`: experts 0-7 of every stack W8, so
    each of the 144 stacks is a two-group `MixedExpertQuant` (int8 then
    int4), whose index tensors the stack holds on the card. Counters
    reset just before and read just after: no fallback; K6 once per
    group per stack per forward call (`grouped[fp]` = 2 x 3 x layers x
    forwards, half of them `grouped<int8>`), `cuda[stacked]` alike; K2
    and K7 as in phase E. Then the audit, `capture_gate`, `sync_check`
    (one host sync a captured step: the token fetch), K6 on each group
    of layer 0's stacks against the plain version, the decode-step
    profile, and the 2-layer card-vs-CPU check (routed experts first,
    then logits). Returns the counts, the K6 group records and the
    profile."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.core.ovp import MixedExpertQuant
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    phase = "mixed E"
    rules = f"*experts/*/[0-{W8_EXPERTS - 1}]=olive_w8a8"
    arch = MOE_ARCH
    if n_layers != get_config(MOE_ARCH).n_layers:
        arch = f"{MOE_ARCH}-{n_layers}-layers"
        ARCHS[arch] = dataclasses.replace(get_config(MOE_ARCH), name=arch,
                                          n_layers=n_layers)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    try:
        res = serve.run(["--arch", arch, "--quant", "olive_serve",
                         "--policy-rules", rules] + SERVE_ARGS, device=dev)
    finally:
        if arch != MOE_ARCH:
            del ARCHS[arch]
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    kernels = ("grouped[fp]", "ovp_matmul[fp]", "decode_attn", "ovp_encode")
    check_counts(counts, phase, kernels)
    check_attn_counts(res, counts, phase, paged=False)
    check_encode_counts(res["engine"], counts, phase)
    st = res["engine"].stats()
    forwards = st["prefills_run"] + st["prefill_chunks_run"] \
        + st["decodes_run"]
    stacks = [layer["moe"]["experts"][leaf]
              for layer in res["params"]["layers"]
              for leaf in ("wg", "wu", "wd")]
    n_experts = res["model"].cfg.n_experts
    want_ids = (tuple(range(W8_EXPERTS)),
                tuple(range(W8_EXPERTS, n_experts)))
    bad = [i for i, w in enumerate(stacks)
           if not isinstance(w, MixedExpertQuant)
           or w.expert_ids != want_ids
           or [g.normal_dtype for g in w.groups] != ["int8", "int4"]
           or w.order.device != w.groups[0].data.device]
    if bad or len(stacks) != 3 * n_layers:
        fail(f"{phase}: stacks {bad[:4]} are not two-group int8/int4 "
             f"MixedExpertQuant stacks with their index tensors on the card")
    per = 3 * n_layers * forwards
    want = {"grouped[fp]": 2 * per, "grouped<int8>": per,
            "grouped<int4>": per, "stacked dispatches": 2 * per}
    got = {key: counts[key] for key in want if key in counts}
    got["stacked dispatches"] = counts["dispatch"].get("cuda[stacked]", 0)
    if got != want:
        fail(f"{phase}: K6 launches {got}, expected {want} (2 groups x 3 "
             f"stacks x {n_layers} layers x {forwards} forward calls)")
    mixed_bytes = sum(g.data.numel() * g.data.element_size()
                      + g.scale.numel() * 4 for w in stacks for g in w.groups)
    w4_bytes = sum(w.n_experts * (w.groups[1].data.shape[1]
                                  * w.groups[1].data.shape[2]
                                  + 4 * w.groups[1].data.shape[2])
                   for w in stacks)
    done = res["completed"]
    if len(done) != 8 or any(len(r.out_tokens) != 16 for r in done):
        fail(f"{phase}: {len(done)} requests finished with "
             f"{[len(r.out_tokens) for r in done]} tokens, expected 8 x 16")
    print(f"[mixed E] {MOE_ARCH} ({n_layers} of 48 layers) olive_serve + "
          f"--policy-rules \"{rules}\": {len(stacks)} two-group stacks "
          f"(experts 0-{W8_EXPERTS - 1} int8, {W8_EXPERTS}-{n_experts - 1} "
          f"int4), expert bytes "
          f"{mixed_bytes / 1e9:.3f} GB against {w4_bytes / 1e9:.3f} GB all "
          f"W4 (+{100 * (mixed_bytes / w4_bytes - 1):.1f}%); PTQ "
          f"{res['ptq_s']:.2f}s, peak device memory {peak_gb:.2f} GB, "
          f"{res['tokens']} tokens in {res['seconds']:.3f}s = "
          f"{res['tok_per_s']:.2f} tok/s, mean TTFT "
          f"{res['mean_ttft_s'] * 1e3:.2f}ms, mean step "
          f"{res['mean_step_s'] * 1e3:.2f}ms, {forwards} forward calls; "
          f"launches grouped[fp]={counts['grouped[fp]']} (<int8> "
          f"{counts['grouped<int8>']}, <int4> {counts['grouped<int4>']}) "
          + " ".join(f"{key}={counts[key]}" for key in kernels[1:])
          + f", dispatch {counts['dispatch']} ({smi})")
    audit_check(res["engine"], phase)
    capture_gate(res["engine"], phase, steps=3)
    sync_check(res, phase)
    k6m = k6_mixed_layer(dev, res["params"]["layers"][0]["moe"]["experts"])
    prof = profile_decode(res, f"{MOE_ARCH}, W8 experts 0-7 + W4, KV4",
                          steps=3, max_new=10)
    truncated_reference_check(res, dev,
                              label=f"W8 experts 0-{W8_EXPERTS - 1} + W4")
    del res, stacks, done
    print(f"[mixed E] phase took {time.perf_counter() - t_phase:.1f}s")
    return {"counts": counts, "k6": k6m, "profile": prof}


# --------------------------------------------------------------------------
# The dense 7-8B configs and the baseline presets
# --------------------------------------------------------------------------
DENSE_ARCHS = ("qwen2-7b", "yi-6b", "minitron-8b")
PREFILL_BUCKETS = (16, 32)  # the slab prefill buckets of 4-31-token prompts
LONG_PROMPT = 1000      # tokens: the 1024 bucket, two slab attention blocks
BASELINES = ("int8", "int4", "ant4")


def dense_layer_shapes(cfg):
    """(K, N) of one dense layer's 7 linears: q, k, v, o, gate, up, down."""
    d, q = cfg.d_model, cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    return [(d, q), (d, kv), (d, kv), (q, d), (d, cfg.d_ff), (d, cfg.d_ff),
            (cfg.d_ff, d)]


def step_bytes(cfg):
    """Bytes a decode step must read, from `param_count`: the blocks'
    weights at 4 bits and the unquantized fp32 head (the embedding rows
    a step reads, the scales and the KV cache are left out)."""
    head = cfg.vocab * cfg.d_model
    return (cfg.param_count() - 2 * head) / 2, 4 * head


def k1_dense_phase(dev):
    """K1 at the widths of Qwen2-7B, Yi-6B and Minitron-8B: one layer's 7
    decode launches at rows 4 in fp mode, int4 OVP weights, and one
    prefill launch of Qwen2-7B's down projection (K 18944) at each slab
    prefill bucket of the launcher's prompts (`PREFILL_BUCKETS` rows),
    each through `k1_layer_record`. Returns {arch: the layer's summed
    record, "qwen2-7b wd prefill<rows>": each bucket's record}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import policy
    from repro_torch.core.qlinear import quantize_weight
    gen = torch.Generator(device=dev).manual_seed(12)
    w4 = policy.OLIVE_W4.replace_all(compute_dtype="float32")
    out = {}
    for arch in DENSE_ARCHS:
        linears = [quantize_weight(torch.randn((k, n), generator=gen,
                                               device=dev) / k ** 0.5, w4)
                   for k, n in dense_layer_shapes(get_config(arch))]
        tot = k1_layer_record(dev, gen, linears, 4, "int4",
                              label=f"k1 {arch}")
        print(f"[k1 {arch}] one layer's 7 decode launches, rows 4, fp: "
              f"kernel {tot['ms']:.4f}ms, matmul {tot['library_ms']:.4f}ms, "
              f"bound {tot['bound_ms']:.5f}ms, plain {tot['plain_ms']:.4f}ms")
        out[arch] = tot
        if arch == DENSE_ARCHS[0]:
            for rows in PREFILL_BUCKETS:
                out[f"{arch} wd prefill{rows}"] = k1_layer_record(
                    dev, gen, linears[-1:], rows, "int4",
                    label=f"k1 {arch} wd prefill")
        del linears
    return out


def serve_phase_f(dev, smi: str):
    """The dense 7-8B models at full published width through the
    launcher's entry point (`--arch A --quant olive_serve`, the
    launcher's workload): Qwen2-7B, Yi-6B and Minitron-8B slab, and
    Qwen2-7B paged (`--paged 16 --prefill-chunk 16`), the card freed
    between runs. Counters reset just before and read just after each
    run: no fallback; K1 `fp` once per quantized linear (7 a layer, int4
    weights) per forward call and none for the unquantized head; K2 (K3
    and K4 paged) once a layer a step or chunk; K7 twice a layer a cache
    write; 8 requests x 16 tokens; every page returned. Then the audit,
    `capture_gate(steps=3)`, the decode-step profile, and the 2-layer
    card-vs-CPU check (slab, or paged over fp32 pools). Prints
    PTQ seconds, peak device memory, tok/s, mean TTFT, mean step, the
    profile and the step's byte bound beside the card. Returns each
    run's counts, engine stats and profile."""
    import torch
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    runs = {}
    for arch, paged in [(a, False) for a in DENSE_ARCHS] \
            + [(DENSE_ARCHS[0], True)]:
        label = "paged 16, chunk 16" if paged else "slab"
        phase = f"serve phase F ({arch}, {label})"
        attn = "paged_decode_attn" if paged else "decode_attn"
        kernels = ("ovp_matmul[fp]", attn, "ovp_encode") \
            + (("prefill_attn",) if paged else ())
        extra = ["--paged", "16", "--prefill-chunk", "16"] if paged else []
        free_device_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = serve.run(["--arch", arch, "--quant", "olive_serve"]
                        + SERVE_ARGS + extra, device=dev)
        load_s = time.perf_counter() - t0 - res["seconds"]
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        eng, cfg = res["engine"], res["model"].cfg
        # the slab prefills of this run by bucket (one request each)
        buckets = {} if paged else dict(collections.Counter(
            eng._bucket(len(r.prompt)) for r in res["completed"]))
        check_counts(counts, phase, kernels)
        check_attn_counts(res, counts, phase, paged)
        check_encode_counts(eng, counts, phase)
        if check_k1_weight_counts(res, counts, phase):
            fail(f"{phase}: W8 linears under olive_serve")
        done = res["completed"]
        if len(done) != 8 or any(len(r.out_tokens) != 16 for r in done):
            fail(f"{phase}: {len(done)} requests finished with "
                 f"{[len(r.out_tokens) for r in done]} tokens, expected "
                 f"8 x 16")
        st = eng.stats()
        if paged:
            pool = st["page_pool"]
            if pool["used_pages"] != 0 or pool["allocs"] != pool["frees"]:
                fail(f"{phase}: pages not all returned: {pool}")
        w_bytes, head_bytes = step_bytes(cfg)
        step_bound = bound_ms(w_bytes + head_bytes, 0.0)[0]
        print(f"[serve F] {arch} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, Hkv {cfg.n_kv_heads} G "
              f"{cfg.n_heads // cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab}) W4 + KV4, {label}: PTQ {res['ptq_s']:.2f}s "
              f"(layer by layer; build and PTQ {load_s:.2f}s), peak device "
              f"memory {peak_gb:.2f} GB, {res['tokens']} tokens in "
              f"{res['seconds']:.3f}s = {res['tok_per_s']:.2f} tok/s, mean "
              f"TTFT {res['mean_ttft_s'] * 1e3:.2f}ms, mean step "
              f"{res['mean_step_s'] * 1e3:.2f}ms; launches "
              + " ".join(f"{key}={counts[key]}" for key in kernels)
              + f" ({st['prefills_run']} prefills, "
              f"{st['prefill_chunks_run']} chunks, {st['decodes_run']} "
              f"decode steps), dispatch {counts['dispatch']}; a decode "
              f"step's byte bound {step_bound:.3f}ms (W4 blocks "
              f"{w_bytes / 1e9:.2f} GB + fp32 head {head_bytes / 1e9:.2f} "
              f"GB at 3.35 TB/s) ({smi})")
        audit_check(eng, phase)
        capture_gate(eng, phase, steps=3)
        prof = profile_decode(res, f"{arch}, W4 + KV4, {label}", steps=3,
                              max_new=10)
        if prof["k1_ms"] is not None:
            print(f"[serve F] {arch} {label} decode step (4 slots): "
                  f"{prof['kernels_per_step']:.1f} device kernels, busy "
                  f"{prof['busy_ms']:.3f}ms of {prof['prof_ms']:.2f}ms "
                  f"profiled wall ({prof['step_ms']:.2f}ms plain), K1 "
                  f"{prof['k1_ms']:.3f}ms, {'K3' if paged else 'K2'} "
                  f"{prof['attn_ms']:.3f}ms; byte bound {step_bound:.3f}ms "
                  f"({smi})")
        truncated_reference_check(res, dev, label="W4", paged=paged,
                                  tag="F")
        if arch == DENSE_ARCHS[0] and not paged:
            long_prefill_check(res, dev)
        if sum(buckets.values()) != st["prefills_run"]:
            fail(f"{phase}: prefills by bucket {buckets}, "
                 f"{st['prefills_run']} prefills run")
        runs[(arch, paged)] = {"counts": counts, "stats": st,
                               "profile": prof, "buckets": buckets}
        del res, eng, done
    print(f"[serve F] phase took {time.perf_counter() - t_phase:.1f}s")
    return runs


def long_prefill_check(res, dev, t: int = LONG_PROMPT):
    """Slab prefill past one attention block (`layers.ATTN_CHUNK`, 512)
    at full width: a 2-layer truncation of the served model (same widths,
    the same quantized params, fp32 KV) in an engine of its own, whose
    prefill entry for the bucket of a `t`-token prompt (1024: two query
    blocks, three key blocks) runs twice: the first run warms up and
    captures, the second replays the graph. The two must agree bit for
    bit, and the replay with the same padded prompt's prefill on the
    CPU's plain versions: equal greedy token, max |logit diff| <= 1e-3 *
    max|ref|. Prints the device memory the engine and the two runs
    added at their peak."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models.layers import ATTN_CHUNK
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import EngineCfg, ServingEngine
    model, params = res["model"], res["params"]
    cfg = dataclasses.replace(model.cfg, n_layers=2)
    small = build_model(cfg, model.policy.replace_all(kv_bits=0))
    p2 = dict(params, layers=params["layers"][:2])
    bucket = ServingEngine._bucket(t)
    if bucket <= ATTN_CHUNK:
        fail(f"long prefill: a {t}-token prompt's bucket {bucket} is one "
             f"attention block")
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, size=t)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = ServingEngine(small, p2, EngineCfg(batch_slots=1, max_len=bucket),
                        device=dev)
    first, replay = [[x.clone() for x in eng._prefill(prompt)]
                     for _ in range(2)]
    torch.cuda.synchronize(dev)
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    entry = eng._prefill_cache[bucket]
    audit = eng.trace_audit()
    if entry.graph is None or audit["prefill_traces"] != 1:
        fail(f"long prefill: the {bucket} entry was not captured once: "
             f"{audit}")
    if not torch.equal(first[0], replay[0]):
        fail(f"long prefill: warm-up and replay differ by "
             f"{float((first[0] - replay[0]).abs().max()):.3e}")
    toks = torch.zeros((1, bucket), dtype=torch.int64)
    toks[0, :t] = torch.from_numpy(prompt)
    t0 = time.perf_counter()
    ref, _ = small.forward(_to(p2, "cpu"), {"tokens": toks}, mode="prefill",
                           caches=small.init_caches(1, bucket, device="cpu"))
    cpu_s = time.perf_counter() - t0
    v = cfg.vocab
    got, ref = replay[0].float().cpu()[:v], ref[0, t - 1, :v]
    err = float((got - ref).abs().max())
    tol = 1e-3 * float(ref.abs().max())
    same = int(replay[1]) == int(torch.argmax(ref))
    print(f"[long prefill] {cfg.name} truncated to 2 layers, W4, fp32 KV: "
          f"a {t}-token prompt through the captured {bucket} slab prefill "
          f"entry ({-(-bucket // ATTN_CHUNK)} query blocks of "
          f"{ATTN_CHUNK}), warm-up and replay bit-identical; card vs CPU "
          f"plain versions ({cpu_s:.1f}s): max |diff| {err:.3e} (tol "
          f"{tol:.3e} = 1e-3 * max|ref|), greedy token "
          f"{'equal' if same else 'differs'}; peak device memory added "
          f"{peak_gb:.3f} GB")
    if not np.isfinite(err) or err > tol or not same:
        fail("long prefill: card and CPU disagree")
    del eng, entry, first, replay


def serve_phase_g(dev, smi: str):
    """The baseline presets on full-width Qwen1.5-0.5B through the
    launcher's entry point (`--quant int8 | int4 | ant4`, slab, the
    launcher's workload): fake-quantized fp32 weights through
    `torch.matmul` over fp32 KV caches. Counters reset just before and
    read just after: no fallback, no K1 or K6 launch, no K7, K2 once a
    layer a decode step over the fp32 caches, 8 requests x 16 tokens;
    then the audit, `capture_gate(steps=3)` and the card-vs-CPU logits
    check (`reference_check`, fp32 KV: tolerance applied). Prints PTQ
    seconds (the per-tensor MSE searches) and tok/s. Returns each
    preset's counts."""
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    runs = {}
    for quant in BASELINES:
        phase = f"serve phase G ({quant})"
        free_device_memory()
        reset_counts()
        res = serve.run(["--arch", ARCH, "--quant", quant] + SERVE_ARGS,
                        device=dev)
        counts = read_counts()
        eng = res["engine"]
        check_counts(counts, phase, ("decode_attn",))
        check_attn_counts(res, counts, phase, paged=False)
        matmuls = {k: n for k, n in counts.items()
                   if k.startswith(("ovp_matmul", "grouped")) and n}
        if matmuls or check_encode_counts(eng, counts, phase):
            fail(f"{phase}: OVP kernels ran on a baseline: {matmuls}, "
                 f"ovp_encode={counts['ovp_encode']}")
        caches = {str(layer["kv"]["k"].dtype) if "k" in layer["kv"]
                  else "packed" for layer in eng.caches["layers"]}
        if caches != {"torch.float32"}:
            fail(f"{phase}: KV caches {caches}, expected fp32")
        done = res["completed"]
        if len(done) != 8 or any(len(r.out_tokens) != 16 for r in done):
            fail(f"{phase}: {len(done)} requests finished with "
                 f"{[len(r.out_tokens) for r in done]} tokens, expected "
                 f"8 x 16")
        print(f"[serve G] {ARCH} --quant {quant} (fake-quant fp32 weights, "
              f"fp32 KV): PTQ {res['ptq_s']:.2f}s, {res['tokens']} tokens "
              f"in {res['seconds']:.3f}s = {res['tok_per_s']:.1f} tok/s, "
              f"mean TTFT {res['mean_ttft_s'] * 1e3:.2f}ms, mean step "
              f"{res['mean_step_s'] * 1e3:.2f}ms; launches decode_attn="
              f"{counts['decode_attn']} ({eng.stats()['decodes_run']} "
              f"decode steps), no K1/K6/K7, dispatch {counts['dispatch']} "
              f"({smi})")
        audit_check(eng, phase)
        capture_gate(eng, f"G ({quant})", steps=3)
        reference_check(res["model"], res["params"], dev, label=quant)
        runs[quant] = {"counts": counts}
        del res, eng, done
    print(f"[serve G] phase took {time.perf_counter() - t_phase:.1f}s")
    return runs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)                         # card name, power limit
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    took = _build.build(["ovp_matmul", "ovp_encode", "decode_attn",
                         "prefill_attn"])
    print(f"[build] {json.dumps({k: round(v, 2) for k, v in took.items()})}"
          f" wall {time.perf_counter() - t0:.2f}s")

    _, k1_err, k1_main, k1_by = k1_phase(dev)
    k1_sweep_phase(dev)
    k1_share_phase(dev)
    wrapper_host_phase(dev)
    one_launch_check(dev)
    k2_rows, k2_err, k2_main = k2_phase(dev)
    _, k3_err, k3_main = k3_phase(dev)
    k2_err = max(k2_err, k23_split_phase(dev))
    attn_host_phase(dev)
    _, k4_err, k4_main = k4_phase(dev)
    _, k5_err, k5_main, k5_decode = k5_codes_phase(dev)
    _, k7_main = k7_phase(dev)
    k7_exhaustive(dev)
    counts_api = api_phase(dev)
    res, counts_a = serve_phase_a(dev)
    audit_check(res["engine"], "serve phase A")
    reference_check(res["model"], res["params"], dev)
    capture_ab(res, "A")
    capture_gate(res["engine"], "A")
    lru_check(res)
    sync_check(res, "A")
    async_phase_a(dev, res, card)
    res_b, counts_b = serve_phase_b(res["model"], res["params"], dev)
    audit_check(res_b["engine"], "serve phase B")
    capture_gate(res_b["engine"], "B")
    res_c, counts_c = serve_phase_c(dev, res)
    audit_check(res_c["engine"], "serve phase C")
    profile_decode(res_c, "W4 + KV4, paged 16")
    capture_gate(res_c["engine"], "C")
    sync_check(res_c, "C")
    paged_reference_check(res["model"], res["params"], dev)
    interleave_check(res_c, dev)
    defrag_check(res_c)
    runs_d = serve_phase_d(dev, res)
    for label, (res_d, _) in runs_d.items():
        audit_check(res_d["engine"], f"serve phase D ({label})")
        if label != "calibrate":
            capture_gate(res_d["engine"], f"D ({label})")
    static_reference_check(runs_d["load"][0], dev)
    prof_b = profile_decode(res_b, "W4A4 + KV4, dynamic 3-sigma scales")
    prof_d = profile_decode(runs_d["load"][0], "W4A4 + KV4, static scales")
    if prof_b["kernels_per_step"] is not None and \
            prof_d["kernels_per_step"] is not None:
        print(f"[profile] dynamic (B) vs static (D) W4A4 decode step: "
              f"{prof_b['kernels_per_step']:.1f} vs "
              f"{prof_d['kernels_per_step']:.1f} device kernels "
              f"({prof_b['kernels_per_step'] - prof_d['kernels_per_step']:.1f}"
              f" fewer), wall {prof_b['step_ms']:.2f} vs "
              f"{prof_d['step_ms']:.2f}ms, device busy "
              f"{prof_b['busy_ms']:.3f} vs {prof_d['busy_ms']:.3f}ms")
    step_wall_ab(res_b, runs_d["load"][0])
    counts_d = runs_d["calibrate"][1]
    # the MoE slice: phases A-D's models are freed first
    del res, res_b, res_c, runs_d, res_d, prof_b, prof_d
    free_device_memory()
    runs_mixed, _, k1w8 = mixed_phase_a(dev, card)
    free_device_memory()
    _, k2_err_moe, _ = k2_phase(dev, hkv=4, g=8, d=128)
    _, k3_err_moe, _ = k3_phase(dev, hkv=4, g=8, d=128)
    _, k4_err_moe, _ = k4_phase(dev, hkv=4, g=8, d=128)
    wide = layouts_phase(dev)
    _, k6_err, k6_decode = k6_phase(dev)
    k6_body_phase(dev)
    k6_api, counts_k6_api = k6_api_phase(dev)
    free_device_memory()
    runs_e = serve_phase_e(dev)
    counts_e = runs_e["slab"]["counts"]
    mixed_e = mixed_phase_e(dev, card)
    # the dense 7-8B configs and the baseline presets
    free_device_memory()
    k1_dense = k1_dense_phase(dev)
    free_device_memory()
    runs_f = serve_phase_f(dev, card)
    serve_phase_g(dev, card)

    def row(name, replaces, source, launches, err, rec, by=None):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": by or rec["bound_by"],
                "library_ms": rec["library_ms"]}

    k1_src = "src/repro/kernels/ovp_matmul.py:367"
    kernels = [
        row("ovp_matmul[fp]", k1_src, "ovp_matmul.cu",
            counts_a["ovp_matmul[fp]"], k1_err, k1_main["fp"], k1_by),
        row("ovp_matmul[quantize]", k1_src, "ovp_matmul.cu",
            counts_b["ovp_matmul[quantize]"], k1_err, k1_main["quantize"],
            k1_by),
        row("ovp_matmul[codes4]", k1_src, "ovp_matmul.cu",
            counts_api["ovp_matmul[codes4]"], k5_err["codes4"],
            k5_main["codes4"]),
        row("ovp_matmul[codes8]", k1_src, "ovp_matmul.cu",
            counts_api["ovp_matmul[codes8]"], k5_err["codes8"],
            k5_main["codes8"]),
        row("ovp_matmul[static]", "src/repro/kernels/ovp_matmul.py:263",
            "ovp_matmul.cu", counts_d["ovp_matmul[static]"],
            k5_err["static"], k5_decode),
        row("decode_attn", "src/repro/kernels/decode_attn.py:358",
            "decode_attn.cu", counts_a["decode_attn"], k2_err, k2_main),
        row("paged_decode_attn", "src/repro/kernels/decode_attn.py:404",
            "decode_attn.cu", counts_c["paged_decode_attn"], k3_err,
            k3_main),
        row("prefill_attn", "src/repro/kernels/prefill_attn.py:170",
            "prefill_attn.cu", counts_c["prefill_attn"], k4_err, k4_main),
        row("ovp_encode", "src/repro/kernels/ovp_encode.py:59",
            "ovp_encode.cu", counts_a["ovp_encode"], 0.0, k7_main),
        row("grouped[fp]", "src/repro/kernels/ovp_matmul.py:436",
            "ovp_matmul.cu", counts_e["grouped[fp]"], k6_err, k6_decode),
    ] + [row(f"grouped[{mode}]", "src/repro/kernels/ovp_matmul.py:436",
             "ovp_matmul.cu", counts_k6_api[f"grouped[{mode}]"],
             k6_api[mode]["max_abs_err"], k6_api[mode])
         for mode in ("quantize", "static", "codes4", "codes8")]
    # the launch counts mixed programs put on served models
    k2_fp = next(r for r in k2_rows if r["cache"] == "fp float32"
                 and r["pos"] == POS_CASES["mixed"])
    counts_w48 = runs_mixed["w48"]["counts"]
    kernels += [
        row("ovp_matmul[fp]<int8>", k1_src, "ovp_matmul.cu",
            counts_w48["ovp_matmul<int8>"], k1w8["fp"]["max_abs_err"],
            k1w8["fp"]),
        row("ovp_matmul[static]<int8>", "src/repro/kernels/ovp_matmul.py:263",
            "ovp_matmul.cu",
            runs_mixed["w48 calibrate"]["counts"]["ovp_matmul<int8>"],
            k1w8["static"]["max_abs_err"], k1w8["static"]),
        row("decode_attn[fp32 cache]", "src/repro/kernels/decode_attn.py:358",
            "decode_attn.cu", counts_w48["decode_attn"],
            k2_fp["max_abs_err"], k2_fp),
    ] + [row(f"grouped[fp]<{dt}>", "src/repro/kernels/ovp_matmul.py:436",
             "ovp_matmul.cu", mixed_e["counts"][f"grouped<{dt}>"],
             mixed_e["k6"][dt]["max_abs_err"], mixed_e["k6"][dt])
         for dt in ("int8", "int4")]
    # K1 at the dense 7-8B widths: launches from phase F's slab runs (the
    # down projection's prefill launches: one a layer a prefill)
    kernels += [row(f"ovp_matmul[fp]@{arch}", k1_src, "ovp_matmul.cu",
                    runs_f[(arch, False)]["counts"]["ovp_matmul[fp]"],
                    k1_dense[arch]["max_abs_err"], k1_dense[arch])
                for arch in DENSE_ARCHS]
    from repro_torch.configs import get_config
    seen = runs_f[("qwen2-7b", False)]["buckets"]
    if not set(seen) <= set(PREFILL_BUCKETS):
        fail(f"phase F's Qwen2-7B prefill buckets {sorted(seen)} are not "
             f"all timed ({PREFILL_BUCKETS})")
    for rows in PREFILL_BUCKETS:
        wd = k1_dense[f"qwen2-7b wd prefill{rows}"]
        kernels.append(row(
            f"ovp_matmul[fp]@qwen2-7b wd prefill{rows}", k1_src,
            "ovp_matmul.cu",
            seen.get(rows, 0) * get_config("qwen2-7b").n_layers,
            wd["max_abs_err"], wd))
    print(f"[attn D128] worst errors at Hkv 4, G 8, D 128 (tol atol 1e-5): "
          f"K2 {k2_err_moe:.2e}, K3 {k3_err_moe:.2e}, K4 {k4_err_moe:.2e}; "
          f"at the widened layouts: K2 {wide['k2']:.2e}, K3 "
          f"{wide['k3']:.2e}, K4 {wide['k4']:.2e}")
    print(f"[card] {smi.splitlines()[0]}")  # beside the numbers below
    moe = k1_main["moe_attn"]
    print(f"[k1 moe] Qwen3-30B-A3B attention block (4 launches, rows 4, "
          f"fp): kernel {moe['ms']:.4f}ms, matmul {moe['library_ms']:.4f}ms,"
          f" bound {moe['bound_ms']:.5f}ms, plain {moe['plain_ms']:.4f}ms")
    print("[note] ovp_matmul[fp], [quantize] and [static] times are the 7 "
          "launches of one layer's decode step (rows 4); [codes4] and "
          "[codes8] one launch at rows 4, K = N = 1024, library "
          "torch.matmul on the dequantized operands; decode_attn is one "
          "launch, packed cache, pos (0, 17, 255, 17); paged_decode_attn "
          "the same over a shuffled pool of 16-row pages; prefill_attn one "
          "launch, packed, C=16 at offset 240 of a 256-token stage, "
          "Qwen1.5-0.5B's shape (library: SDPA, attention half only); "
          "ovp_encode one launch of phase A's KV write (R 64 = 4 slots x "
          "16 kv heads, K 64, f32, a 3-sigma scale a row; max_abs_err: "
          "bytes differing, 0; library: none); grouped[fp] (K6) is the 3 launches of one Qwen3-30B-A3B "
          "layer's decode step (B 4, E 128, C 4) with a seeded top-8 "
          "routing's fill, cold L2, bound from the touched experts' bytes, "
          "library torch.einsum on the dequantized fp32 stack (every "
          "slot); grouped[quantize|static|codes4|"
          "codes8] one launch at E 8, C 32, K = N = 1024 (API). "
          "Launches: [fp], decode_attn and ovp_encode from serve phase "
          "A, "
          "[quantize] from phase B, [static] from phase D's calibrate run, "
          "paged_decode_attn and prefill_attn from phase C, [codes4] and "
          "[codes8] from the API phase, grouped[fp] from "
          "serve phase E's slab run, the other grouped modes from the K6 "
          "API phase. Mixed programs: ovp_matmul[fp]<int8> and "
          "[static]<int8> are the 7 launches of the olive_mixed_w48 "
          "model's W8 layer 0 at rows 4 (static: int8 activations at one "
          "scale, K5), launches from mixed A's w48 run and its calibrate "
          "run; decode_attn[fp32 cache] is K2's fp32-cache launch at pos "
          "(0, 17, 255, 17), launches from mixed A's w48 run (fp32 KV on "
          "every layer); grouped[fp]<int8|int4> are the 3 launches of one "
          "group of mixed E's layer 0 stacks (E 8 int8 / E 120 int4) with "
          "that group's share of a top-8 decode fill, warm L2, launches "
          "from mixed E. Dense 7-8B widths: ovp_matmul[fp]@<arch> is the "
          "7 launches of one layer's decode step at rows 4 (int4 weights), "
          "launches from phase F's slab run of that arch; ovp_matmul[fp]"
          "@qwen2-7b wd prefill<rows> one launch of the down projection "
          "(K 18944 -> N 3584) at <rows> rows, each slab prefill bucket "
          "of the launcher's prompts, launches: one a layer for each "
          "prefill of that bucket in phase F's Qwen2-7B slab run (the "
          "engine's completed requests by bucket)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
