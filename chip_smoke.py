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
   programs at full width, `MIXED_A_LAYERS` deep (cut for time), through
   the launcher (`--quant olive_mixed_w48`, `--quant olive_owq_style`,
   and `olive_mixed_w48 --policy-rules` with packed KV caches on the
   first and last layer only, slab and paged), K1's launches counted by
   weight dtype (14 or 2 x layers of 7 x layers a forward call with
   int8 weights), one K2/K3 a layer a
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
9. serve phase E: Qwen3-30B-A3B at full published width, `SLAB_E_LAYERS`
   = 24 of its 48 layers (cut for phase O's time; 48 until PR 30),
   through the launcher's entry point (`--arch qwen3-moe-30b-a3b
   --quant olive_serve`, phase A's prompts and seed, layer-by-layer
   init + PTQ), slab and then paged (`--paged 16 --prefill-chunk 16`,
   at `PAGED_E_LAYERS` of the 48 layers, cut for time), the slab model
   freed before the paged one loads:
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
   workload), slab (the paged Qwen2-7B run cut for time; phases C, E
   and L serve paged), the card freed between runs: no fallback, K1
   once per quantized linear per forward call (none for the
   unquantized fp32 head), K2 and K7 as in phase A, the audit, graph
   against eager, each run's decode-step profile beside the step's
   roofline, and a 2-layer card-vs-CPU check of each run
   (`truncated_reference_check`);
13. serve phase G: the baseline presets (`--quant int8 | int4 | ant4`)
   on full-width Qwen1.5-0.5B through the launcher: no OVP kernel (K1,
   K6, K7) launched, K2 once a layer a step over fp32 caches, the
   audit, graph against eager, and the card-vs-CPU logits check;
14. calibration at full width: K5 at one Qwen2-7B layer's 7 decode
   launches (rows 4, int4 and int8 weights) and one Qwen3-30B-A3B
   attention block (`k5_wide_phase`, against the plain version, timed
   beside `torch.matmul` and the byte bound); then serve phase H at
   full published width and depth, the calibration streamed layer by
   layer: H1, Qwen2-7B's weight sensitivity pass without the fp32 tree
   (`record_weights` one layer at a time, `site_sensitivity` on the
   card, `auto_mixed(budget_bits=4.5)`), then `--calibrate` with a
   `--policy-rules` W8A8 rule for each promoted site; H2, Qwen3-30B-A3B
   at `H2_LAYERS` = 8 of its 48 layers (cut for time) `--calibrate`:
   K5 launches by weight dtype per forward call, no K1
   `fp` or `quantize` launch, no dynamic scale, K6 on the experts, the
   audit, graph against eager, the calibrated decode-step profile, the
   2-layer card-vs-CPU check, peak device memory (H2 held to phase E's
   48-layer peak less the served weights and caches of the 40 layers
   cut, + 2 layers of fp32 weights + 1 GB), and on a 2-layer cut of
   Qwen2-7B the streamed artifact byte for byte the whole tree's;
15. the hybrid family, with the earlier models freed: serve phase I,
   RecurrentGemma-9B at full published width and depth (38 layers: 12
   periods of rglru, rglru, local_attn and 2 rglru; MQA 16 x 256,
   window 2048, d_rnn 4096) through the launcher (`--arch
   recurrentgemma-9b --quant olive_serve`, the launcher's workload,
   slab: each prompt prefilled at its exact length): no fallback, a
   decode step's launches exactly K1 292, K2 12 and K7 24 (the launch
   counters), the audit (one prefill entry per distinct length), graph
   against eager (recurrent states among the cache bytes), the sync check (and the ring's KV write under
   "error"), the decode-step profile beside its roofline, a 3-layer
   (one period) card-vs-CPU check, and the ring check: the 3-layer cut
   at max_len 2560 (a 2048-slot ring) serves a 2100-token prompt and 64
   greedy decode steps on the captured decode step, K2 at window 2048
   and ring 2048, held over an fp32 cache to one CPU window prefill of
   the same tokens (1e-3 * max|ref|, greedy tokens equal), and over the
   served KV4 ring K2 held to its plain version and timed beside SDPA;
   K1 at one rglru layer's 8 and one local layer's 7 decode launches
   (the served weights), and K2 at the served shape;
16. the xLSTM family, with the earlier models freed: serve phase J,
   xLSTM-350M at full published width and depth (24 layers: 12 periods
   of mlstm, slstm; d_model 1024, 4 heads: mLSTM heads of 512, sLSTM
   heads of 256; no KV cache) through the launcher (`--arch xlstm-350m
   --quant olive_serve`, the launcher's workload, slab, each prompt
   prefilled at its exact length): no fallback, a decode step's
   launches exactly K1 132 and no K2, K3, K4, K6 or K7 launch, the
   audit, graph against eager (every mLSTM and sLSTM state leaf among
   the cache bytes), the sync check, the decode-step profile beside its
   roofline (the state read and written among the bytes), a 2-layer
   (one period) card-vs-CPU check (a 300-token prompt through its captured prefill,
   then 32 greedy decode steps on the captured step, held to one CPU
   prefill of the same tokens at 1e-3 * max|ref|, greedy tokens equal),
   and K1 at one mLSTM layer's 5 and one sLSTM layer's 6 decode
   launches (the served weights, ragged N 1364 included);
17. the encoder-decoder, with the earlier models freed: phase K,
   SeamlessM4T-large-v2 at full published width and depth (24 encoder
   + 24 decoder layers, d_model 1024, MHA 16 x 64, GELU MLPs of 8192,
   untied 256206 vocab, 160-d audio frames), W4 + KV4 self caches and
   fp32 cross caches, random weights from seed 0 drawn and quantized
   layer by layer (the encoder as one stack); the launcher refuses the
   arch (its engine feeds no frames), so the path is `Model.forward`, as
   in the reference: 4 rows of 400 random frames and an 8-token prompt
   prefilled into 512-slot cross caches, then 32 greedy decode steps:
   exactly K1 385 and K7 48 in the prefill, K1 192, K2 48 (24 over the
   KV4 self caches, 24 over the fp32 cross caches at pos = src_len - 1,
   told apart by K2's cache-dtype counters) and K7 48 a decode step, no
   other kernel; every cross cache's src_len 400 and its tail unwritten;
   the encoder alone timed and counted (exactly K1 145); a decode
   step profiled beside its roofline (the cross caches' filled slots
   among the bytes); K1 at one decoder layer's 8 decode launches
   and at the frontend projection (K 160) and one encoder layer's 6
   launches at the prefill's 1600 rows, K2 over a served cross cache;
   a 2 + 2-layer card-vs-CPU check (32 decode steps, 1e-3 * max|ref|,
   greedy tokens equal) and the padded-vs-tight check (the same run over
   400-slot cross caches within 1e-4 * max|padded|);
18. the VLM: phase L, InternVL2-1B at full published width and depth
   (24 layers, d_model 896, 14 heads over 2 KV heads of 64, SwiGLU
   4864, untied 151655 vocab) through the launcher (`--arch internvl2-1b
   --quant olive_serve`, the launcher's workload, on tokens), slab and
   paged 16 / chunk 16: a decode step's launches exactly K1 168, K2 (K3)
   24 and K7 48, no other kernel, the audit, graph against eager, the
   sync check, the decode-step profile beside its roofline, the
   2-layer card-vs-CPU check; then `Model.forward` with 256 random
   1024-d patch embeddings in front of an 8-token prompt on 4 rows
   (K1 169 and K7 48 in the prefill) and 32 greedy decode steps at pos
   264 + i, with a 2-layer card-vs-CPU check; K1 at one layer's 7
   decode launches, and K2, K3 and K4 at Hkv 2 / G 7 / D 64 against
   their plain versions;
19. training: phase M, Qwen1.5-0.5B at full published width and depth
   (24 layers, d_model 1024, 16 x 64, d_ff 2816, tied 151936 vocab)
   through the training launcher (`repro_torch.launch.train`,
   `--quant olive_w4a4`: QAT with STE fake-quant of every linear's
   weight and activation, bf16 compute, every layer rematerialized,
   AdamW with bf16 moments, `--batch 8 --seq 512 --steps 8
   --ckpt-every 4 --eval-every 8` (`TRAIN_STEPS`, `TRAIN_CKPT_EVERY`;
   20 and 10, then 12 and 6, before cuts for time), checkpoints under
   `build/ckpt_m`): every loss finite and the last below the first; the
   final checkpoint save timed; a second launcher run restores step 4
   and reproduces steps 5-8's losses within rtol 1e-3; a 2-layer cut at full width takes the
   gradients of one train step on the card and on the CPU in fp32
   compute, QAT with W4 weights and with W4A4 (loss, gradient norm and
   every gradient leaf against the tolerances `TRAIN_CUT_CHECKS` states,
   beside the card's own one-ulp scale sensitivity); then the trained fp32 tree is quantized under
   `olive_serve` (activations off, as the launcher rewrites it) and
   serves 4 requests through the slab engine on captured steps,
   exactly K1 `fp` 168, K2 24 and K7 48 a decode step (168 and 48 a
   prefill), no other kernel. It prints the median step time after the
   first, tokens/s, peak device memory, checkpoint seconds and bytes,
   and the model FLOPs a step beside the H100 SXM data sheet's dense
   bf16 peak, and the profiled step's roofline;
20. the tooling: phase N (`tooling_phase_n`), the port of the
   reference's analysis and single-card roofline: `repro_torch.analysis.
   run_all()` (the vocabulary, kernel-contract, policy and hygiene
   passes) must give 0 findings; each kernel case of the kernel pass
   (the reference's eight: K1 and K6 with int4 and int8 weights, K7, K2
   slab, K3 paged, K4 paged; and the KV write through
   `layers.cache_write`) runs once on the card at its shape, held to its
   plain version on the card, its launches counted, timed beside the
   plain version, a library call and its bound, each plan's shared
   memory printed beside the card's opt-in limit (and the largest plan
   of the served sweep of each kernel), K4's and the KV write's pools
   written in place (pointers unchanged, untouched pages and slots
   bit-identical); the sanitize smoke (`python -m repro_torch.analysis
   --sanitize-smoke`) at the full width of Qwen1.5-0.5B under
   REPRO_SANITIZE=1, its trace audit clean and K1, K2 and K7 launched
   under the checks; and a child process whose NaN KV scale must fail
   the named check in front of K7, while this process goes on;
21. serving on a mesh: phase O (`serve_phase_o`), two ranks spawned on
   card 0, joined over gloo through a rendezvous file (NCCL refuses two
   ranks on one device), each serving the launcher's workload through
   `run()` with `--backend cuda_sharded --mesh 1,2` (column-, row- and
   expert-parallel matmuls, KV caches split by KV heads; gloo steps run
   eagerly): Qwen1.5-0.5B at full width and depth, slab and paged 16 /
   chunk 16, then Qwen3-30B-A3B at `MESH_E_LAYERS` = 4 of its 48 layers
   (cut for time), slab and paged, with EP 2. Gated per rank: tokens
   equal to the other rank's and to one rank's run of the same argv
   (phases A and C; the MoE cut served here on `cuda`), no fallback and
   every call on `cuda_sharded`, the launches of every forward call
   and of a decode step run alone (Qwen1.5: K1 168, K2 or K3 24, K7 48;
   K4 24 a chunk; the MoE cut: K1 16, K6 12 over 64 local experts), KV
   bytes half of one rank's, quantized weight bytes 0.50-0.55 of one
   rank's, the first prompt's prefill logits within `MESH_LOGIT_TOL` x
   max|ref| of one rank's and equal on both ranks, the audit naming
   the eager gloo steps. Printed per rank: a decode step's wall ms,
   collectives and bytes a step, peak memory (two ranks sharing one
   card over gloo: no speed claim). Then each new shard shape once
   against its plain version (`mesh_kernel_phase`): K1 over a Qwen1.5
   layer's column and row slices of both ranks, K6 at E 64 with each
   rank's slice of a top-8 fill, K2, K3 and K4 at the local Hkv (8, G
   1, D 64; 2, G 8, D 128), K7 on the local heads' KV write. Then four
   ranks on card 0 (`MESH_VLM_RANKS`): InternVL2-1B at full width cut to
   `MESH_VLM_LAYERS` = 4 of its 24 layers with `--mesh 1,4`: its 2 KV
   heads do not divide 4, so each rank holds 64 of the 256 slots of
   every KV cache (the reference's `cache_pspecs`) and a quarter of the
   vocabulary. Gated per rank: tokens equal to one rank's run of the
   same cut, KV and `table` bytes a quarter of one rank's, K2 launched
   0 times with every decode-attention call declined as
   `shard_hkv_lt_axis` (the partial attention and its rank-order
   combine compute it), K1 (5 column + 2 row launches a layer) and K7
   (2 a layer) launches a forward call and a decode step; K1 over that
   layer's rank shards at tp 4 and K7 at its KV write's shape against
   their plain versions.

22. training on a mesh: phase P (`train_phase_p`), two ranks spawned on
   card 0 over gloo as in phase O. P1: the training launcher with
   `--mesh 1x2` (`P_ARGS`: Qwen1.5-0.5B at full width and depth, QAT
   `olive_w4a4`, 8 x 512 tokens, `P_STEPS` = 2 steps from `--seed 0`,
   checkpoints every `P_CKPT_STEP` = 1 under `build/ckpt_p`; dp_only at
   train_4k's global batch: every parameter and AdamW moment split over
   both ranks), beside one rank's run of the same argv here: both
   ranks' losses equal; against one rank's, step 1's loss within
   `P_FIRST_RTOL` and grad norm within `P_GNORM_RTOL`, every loss within
   `P_LOSS_RTOL` (later grad norms printed: the states part after step
   1, see `P_FIRST_RTOL`); printed per rank: its parameter and moment
   bytes beside one rank's, its last step's wall ms (run alone after a
   barrier, `_LastStep`), all-gathers and rank sums and MB received,
   peak memory. P2: the mesh's step-1 checkpoint restored by one rank,
   which finishes step 2 within `P_LOSS_RTOL` of the mesh's loss. P3: xLSTM-350M at full width,
   `P_XLSTM_LAYERS` = 2 of its 24 layers (one period: mLSTM, sLSTM; cut
   for time), `--mesh 1x2` under the TP rules (the sLSTM keeps them), 3
   steps of 2 x 128 tokens, within `P_XLSTM_RTOL` of one rank. P4: the
   params of the mesh's step-2 checkpoint restored on the card and
   served under olive_serve through the slab engine (K1 168, K2 24, K7
   48 a decode step, gated as in phase M). P5: `python -m
   repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k`
   on both production meshes (256 and 512 fake ranks; "meta" tensors,
   no card), started in a child process after the build so it runs
   beside the card's phases, waited for here: both records "ok",
   their per-rank bytes, collectives and bottleneck printed; then in
   the same child the two smoke serve cells the reference committed
   (`qwen1.5-0.5b-smoke` decode_32k and prefill_32k, single, olive_kv):
   "ok", argument and output bytes a rank within 1 % of the committed
   records once the leaves `tests/test_torch_dryrun_records.py` names
   take the reference's counts (`P_SMOKE_NAMED`); and `qwen2-7b`
   decode_32k single olive_kv: "ok", its argument bytes a rank
   printed.

23. the examples: phase X (`examples_phase_x`), each example of
   `examples_torch/` through the function its `main` calls, on the
   bench-lm fixture (`bench_lm_30.npz`: 4 layers, d 128, Hkv 2, G 2, D
   32), launch counters reset just before each and read just after,
   each result held to the same function on the CPU: quickstart (one K1
   `fp` launch, kernel vs oracle under 1e-4, packed bytes and the
   victim pair as the CPU's); ptq_calibrate (K1 `fp`, `quantize` and
   int8 weights launched at the evaluations' 2048 rows, every
   perplexity row within `X_ROW_RTOL` of the CPU's, the same most
   sensitive sites, promoted set and verdict: DEGRADED in both packages
   on the committed 30-step weights); serve_quantized in its four modes
   (`X_MODES`, 12 requests x 24 tokens, captured steps: both engines'
   greedy tokens equal the CPU engines', K1 once per quantized linear
   per forward call by weight dtype, K2 once a layer a decode step by
   cache dtype, K7 twice a packed layer a forward call, no decline or
   fallback, the CPU's verdict, tok/s printed); train_e2e's e2e-20m run
   at its 120 steps (resumed at 60, verdict OK, tokens/s, peak memory,
   save and restore seconds) and e2e-100m at `X_BIG_STEPS` = 40 of its
   200 (cut for time; resumed at half, the loss falls). K1 (quickstart's
   shape; one layer at the evaluations' 2048 rows in `fp` and
   `quantize`, the `auto_mixed` W8 linear at 2048 rows; one layer at
   rows 4), K2 (B 4, S 192, Hkv 2, G 2, D 32, packed and fp32) and K7 (R
   8 x K 32) against their plain versions, timed. Prints the phase's
   seconds by example.

Every profile phase (A-M) prints its step's roofline (`step_roofline`:
`repro_torch.roofline.analyze` of the step's work counted from the
served tensors by `repro_torch.roofline.step_stats`) beside the
profiled device busy time.

Every serve phase runs the engine's captured steps (CUDA graphs, the
default) and checks them: the trace audit (`audit_check`: the decode step
built once, one prefill entry per prompt bucket or paged stage length
seen, each captured, none evicted); graph against eager in the same
engine (`capture_gate`: decode steps of 4 slots from the same caches
through the graph and through the same step run eagerly,
bit-identical logits, 0 cache bytes differing, equal greedy tokens), in
phases A, B, C, D (load and paged) and E (slab and paged); the sync
check allows no host sync in a captured decode step but the token
fetch; and in phase A the launcher's workload is drained by an eager
twin of the served engine (`capture=False`) and by the captured engine
in turns eager, graph, graph, eager (`capture_ab`, cut from phase E for
time:
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
import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ARCH = "qwen1.5-0.5b"


def fail(msg: str) -> None:
    sys.exit(f"[chip_smoke] FAIL: {msg}")


def time_ms(fn, iters: int = 50, graph: bool = True, replays: int = 1):
    """(device ms, wall ms) per call. Device: `iters` calls captured in one
    CUDA graph and replayed between CUDA events, so host launch cost is
    out; with `replays` > 1, the median of that many replays, each timed
    alone. Wall: CUDA events around the eager Python loop, host launch
    cost in. Operands stay resident in L2 between calls in both.
    `graph=False` (a function that copies from the host, which capture
    refuses) reports the wall time twice."""
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
    times = []
    for _ in range(replays):
        start.record()
        cuda_graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2], wall


def bound_ms(n_bytes: float, n_flops: float):
    """A kernel's bound (ms, "bytes" or "operations"): its bytes over the
    H100's HBM rate and its FLOPs over the fp32 CUDA-core peak, the peak
    PERF.md's kernel table states (`repro_torch.roofline.hw`)."""
    from repro_torch.roofline import hw
    t, by = hw.bound_s(n_bytes, n_flops, peak=hw.PEAK_FLOPS_FP32)
    return t * 1e3, by


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
             ("KV write I", 4, 256, "row"),
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
    (`order`): each process runs its own tree's `chip_smoke.py`, times
    the encode at every K7 case (`k7_tree_times`) and profiles one decode
    step of phase A's and, with `moe`, phase E's model (`step_kernels`;
    device kernels a captured step, busy and wall ms)."""
    trees = {"old": os.path.abspath(old_root), "new": ROOT}
    cases = [(label, r, k, dt) for label, r, k, _ in K7_SHAPES
             for dt in K7_DTYPES]
    got = {label: [] for label in trees}
    steps = {label: [] for label in trees}
    for label in order:
        code = ("import json, sys, torch; "
                f"sys.path.insert(0, {os.path.join(trees[label], 'src')!r}); "
                f"sys.path.insert(0, {trees[label]!r}); "
                "import chip_smoke as cs; "
                "dev = torch.device('cuda:0'); "
                "t = cs.k7_tree_times(dev); "
                f"print(json.dumps([t, cs.step_kernels(dev, {moe!r})]))")
        out = subprocess.run([sys.executable, "-c", code], check=True,
                             capture_output=True, text=True,
                             cwd=trees[label]).stdout
        lines = out.strip().splitlines()
        for line in lines:
            if line.startswith(("[profile] decode step", "[roofline]")):
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
    backends.sharded.reset_shard_launches()
    serve.reset_kernel_launches()


def read_counts():
    from repro_torch import backends
    from repro_torch.launch import serve
    return dict(serve.kernel_launches(), dispatch=backends.dispatch_stats(),
                act_scale=backends.act_scale_stats(),
                shard=backends.sharded.shard_launches())


def check_counts(counts, phase: str,
                 kernels=("ovp_matmul[fp]", "decode_attn")) -> None:
    fallbacks = [k for k in counts["dispatch"] if "->fallback" in k]
    if fallbacks:
        fail(f"{phase}: dispatch fell back: {counts['dispatch']}")
    for name in kernels:
        if counts[name] <= 0:
            fail(f"{phase}: kernel {name} was never launched")


def attn_layers(model) -> int:
    """The model's layers with an attention KV cache (all but the
    recurrent ones: rglru, mlstm, slstm)."""
    from repro_torch.models.model import RECURRENT_TYPES
    return sum(model.block_type(i) not in RECURRENT_TYPES
               for i in range(model.cfg.n_layers))


def check_attn_counts(res, counts, phase: str, paged: bool) -> None:
    """One attention launch per attention layer per forward call: K2
    (slab) or K3 (paged) once per layer per decode step, K4 once per
    layer per paged prefill chunk, and no other attention kernel."""
    layers = attn_layers(res["model"])
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
    layers = sum("k_data" in layer.get("kv", {})
                 for layer in eng.caches["layers"])
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
    served = next((layer["kv"] for layer in eng.caches["layers"]
                   if "kv" in layer), None)
    alone = "no KV cache" if served is None \
        else _kv_write_alone(eng, served, label)
    print(f"[sync {label}] one captured decode step under sync debug mode: "
          f"{len(syncs)} host syncs warned, {other} other than the token "
          f"fetch (limit 0), {in_layers} inside the layers (models, core, "
          f"backends, kernels), {from_kv} from the KV write (limit 0); by "
          f"place: "
          + (", ".join(f"{f}:{n} x{c}" for (f, n), c in sorted(where.items()))
             or "none") + f"; {alone}")
    if from_kv:
        fail(f"sync check {label}: the KV write synchronized the host "
             f"{from_kv} times")
    if other:
        fail(f"sync check {label}: {other} host syncs besides the token "
             f"fetch in one decode step")


def _kv_write_alone(eng, served, label: str) -> str:
    """The KV write alone, at the served step's shapes, under "error": a
    sync raises; a windowed model's ring write too, one token and a
    prefill. Returns what it checked."""
    import torch
    from repro_torch.models import layers
    cfg = eng.model.cfg
    paged, dev = "block_table" in served, served["k_data"].device
    cache = (layers.make_paged_kv_cache(16, 16, 4, 16, cfg.n_kv_heads,
                                        cfg.head_dim, kv_bits=4, device=dev)
             if paged else
             layers.make_kv_cache(4, 256, cfg.n_kv_heads, cfg.head_dim,
                                  kv_bits=4, device=dev))
    kv = torch.randn((2, 4, 1, cfg.n_kv_heads, cfg.head_dim), device=dev)
    pos = torch.tensor([0, 17, 255, 3], dtype=torch.int32, device=dev)
    policy = layers.rp(eng.model.policy, "attn", "kv")
    writes = [(cache, kv[0], kv[1], pos, 0)]
    if cfg.window:
        ring = layers.make_kv_cache(4, cfg.window, cfg.n_kv_heads,
                                    cfg.head_dim, kv_bits=4, device=dev)
        many = torch.randn((2, 4, 40, cfg.n_kv_heads, cfg.head_dim),
                           device=dev)
        writes += [(ring, kv[0], kv[1], pos + 3 * cfg.window, cfg.window),
                   (ring, many[0], many[1], pos + cfg.window - 20,
                    cfg.window)]
    for c, k, v, p, r in writes:
        layers.cache_write(c, k, v, p, policy, ring=r)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for c, k, v, p, r in writes:
            layers.cache_write(c, k, v, p, policy, ring=r)
    except RuntimeError as err:
        fail(f"sync check {label}: the KV write synchronized the host: "
             f"{err}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return (f"the {'paged' if paged else 'slab'} KV write "
            + (f"and the {cfg.window}-slot ring's (one token, 40 tokens) "
               if cfg.window else "") + "alone under \"error\": no sync")


def _prefill_keys(eng) -> set:
    """The compiled prefill entries the engine's completed requests
    needed: one per prompt bucket (slab; the exact length where the
    model cannot bucket) or ("paged", stage length), by the engine's own
    rounding."""
    keys = set()
    for req in eng.completed:
        bucket = eng._bucket(len(req.prompt)) if eng._bucket_ok \
            else len(req.prompt)
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
    from repro_torch.serve.engine import _leaves
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
    leaves = _leaves(eng.caches)        # KV caches and recurrent states
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


def profile_steps(step, steps: int = 3, warm: bool = True):
    """`steps` calls of `step()` under torch.profiler (after one call
    outside it when `warm`): per call, the profiled wall ms, the device
    busy ms, the device kernels and the zero-fills among them, K1/K5's
    decode-body calls and ms, K6's launches and ms, K2/K3's launches and
    ms, and the 8 costliest kernels as (ms, launches, name). The counts
    and ms are None when the profiler saw no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
        step()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def per_step(name):
        """(calls, ms) a step of the kernels whose name holds `name`."""
        hits = [e for e in kernels if name in e.key]
        return (sum(e.count for e in hits) / steps,
                sum(e.self_device_time_total for e in hits) / 1e3 / steps)

    out = {"wall_ms": wall,
           "busy_ms": sum(e.self_device_time_total
                          for e in kernels) / 1e3 / steps,
           "top": [(e.self_device_time_total / 1e3 / steps,
                    e.count // steps, e.key) for e in sorted(
                        kernels, key=lambda e: -e.self_device_time_total)[:8]]}
    if not kernels:
        return dict(out, kernels=None, fills=None, k1_calls=None,
                    k1_ms=None, k6_calls=None, k6_ms=None, attn_calls=None,
                    attn_ms=None)
    # zero-fill kernels (torch.zeros / fill_): a split-K matmul needs one;
    # K1/K5's decode-body kernels, each one whole call; K6's persistent
    # kernel (the MoE expert einsums); K2 / K3 (one kernel template, slab
    # or paged rows)
    out["kernels"] = sum(e.count for e in kernels) / steps
    out["fills"] = per_step("FillFunctor")[0]
    for key, name in (("k1", "ovp_dec_kernel"),
                      ("k6", "ovp_grouped_dec_kernel"),
                      ("attn", "decode_attn_kernel")):
        out[f"{key}_calls"], out[f"{key}_ms"] = per_step(name)
    return out


def step_roofline(label: str, stats, busy_ms=None, smi: str = ""):
    """Print one step's roofline (`repro_torch.roofline.analyze` of its
    `step_stats` count: t_bound, the term that sets it, bytes by part,
    FLOPs) beside the profiled device busy ms; returns the Roofline."""
    from repro_torch.roofline import analyze
    roof = analyze(stats)
    t_ms = roof.t_bound * 1e3
    parts = ", ".join(f"{k} {v / 1e6:.2f}" for k, v in stats.parts.items()
                      if v)
    busy = (f"busy {busy_ms:.3f}ms = {busy_ms / t_ms:.1f} x t_bound"
            if busy_ms is not None and t_ms else "busy not measured")
    print(f"[roofline] {label}: t_bound {t_ms:.4f}ms ({roof.bottleneck}; "
          f"compute {roof.t_compute * 1e3:.4f}ms at the dense bf16 peak, "
          f"memory {roof.t_memory * 1e3:.4f}ms); {stats.bytes / 1e6:.2f} MB "
          f"({parts}), {stats.flops:.4e} FLOPs, model FLOPs "
          f"{roof.model_flops_global:.4e}; {busy}"
          + (f" ({smi})" if smi else ""))
    return roof


def profile_decode(res, label: str = "W4 + KV4", steps: int = 6,
                   max_new: int = 32) -> None:
    """Where one decode step's time goes on the served model: `steps`
    steps of 4 active slots timed on the host clock, then as many more
    under torch.profiler (`profile_steps`) for the device busy time and
    the top kernels (4 requests of `max_new` tokens, drained after),
    beside the profiled steps' roofline (`step_roofline`, from the
    served tensors at the profiled positions)."""
    import numpy as np
    import torch
    from repro_torch.roofline import step_stats
    eng = res["engine"]
    rng = np.random.default_rng(3)
    for _ in range(4):
        eng.submit(rng.integers(0, eng.model.cfg.vocab, size=12),
                   max_new_tokens=max_new)
    while len(eng._active()) < 4:         # admission (and paged prefill)
        eng.step()
    torch.cuda.synchronize()
    pos0 = eng.pos.copy()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    stats = step_stats.mean([step_stats.decode_step_stats(
        eng.model, eng.params, eng.caches, pos0 + steps + i)
        for i in range(steps)])
    prof = profile_steps(eng.step, steps, warm=False)
    prof_ms, busy_ms = prof["wall_ms"], prof["busy_ms"]
    print(f"[profile] decode step (4 slots, {label}, {steps} steps): "
          f"{step_ms:.2f}ms "
          f"wall; under the profiler {prof_ms:.2f}ms wall, device busy "
          + (f"{busy_ms:.3f}ms ({100 * busy_ms / prof_ms:.1f}% of wall), "
             f"{prof['kernels']:.1f} device kernels per step, "
             f"{prof['fills']:.1f} of them zero-fills, "
             f"{prof['k1_calls']:.1f} K1/K5 calls ({prof['k1_ms']:.3f}ms)"
             + (f", K6 {prof['k6_ms']:.3f}ms over {prof['k6_calls']:.1f} "
                f"launches" if prof["k6_calls"] else "")
             + f", K2/K3 {prof['attn_ms']:.3f}ms over "
               f"{prof['attn_calls']:.1f} launches"
             if prof["kernels"] is not None
             else "not measured (no device events)"))
    for ms, n, key in prof["top"]:
        print(f"[profile]   {ms:8.3f}ms/step {n:5d} launches/step  "
              f"{key[:90]}")
    roof = step_roofline(f"decode step (4 slots, {label})", stats,
                         busy_ms if prof["kernels"] is not None else None)
    eng.run_until_drained()
    return {"step_ms": step_ms, "prof_ms": prof_ms, "busy_ms": busy_ms,
            "roofline": roof, "stats": stats,
            "kernels_per_step": prof["kernels"], "k6_ms": prof["k6_ms"],
            "k1_ms": prof["k1_ms"], "attn_ms": prof["attn_ms"],
            "k1_calls": prof["k1_calls"], "attn_calls": prof["attn_calls"]}


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
            stack_ms = bound_ms(e * (k // 2 * n + 4 * n), 0.0)[0]
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
          f" whole stacks at the HBM rate {decode['stack_bytes_ms']:.4f}ms")
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
    stack_ms = bound_ms(e * (k // 2 * n + 4 * n), 0.0)[0]
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

        # the median of 5 replays: one replay read 0.0152 and 0.0160 ms
        # against the 0.0151 ms gate on hosts that read 0.0135 on others
        ms = time_ms(cold, 12, replays=5)[0] / len(stacks[(k, n)])
        print(f"[k6 paths] decode B={b} E={e} C={c} K={k} N={n}, fill "
              f"touching {label}: kernel={ms:.4f}ms cold L2 (median of 5 "
              f"graph replays); reading the whole stack would take "
              f"{stack_ms:.4f}ms")
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


PAGED_E_LAYERS = 8      # phase E's paged run, cut from the published 48
#                         (12 until PR 28)
SLAB_E_LAYERS = 24      # phase E's slab run, cut from the published 48 for
#                         phase O's four-rank run (48 until PR 30)


@contextlib.contextmanager
def cut_arch(arch: str, n_layers: int):
    """The launcher's `--arch` for `arch` at full width and `n_layers`
    deep: the published config, or a cut of its depth registered for the
    block."""
    import dataclasses

    from repro_torch.configs import ARCHS, get_config
    full = get_config(arch)
    if n_layers == full.n_layers:
        yield arch
        return
    name = f"{arch}-{n_layers}-layers"
    ARCHS[name] = dataclasses.replace(full, name=name, n_layers=n_layers)
    try:
        yield name
    finally:
        del ARCHS[name]


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
    base = ["--quant", "olive_serve", "--requests", "8", "--max-new", "16",
            "--slots", "4", "--max-len", "256", "--seed", "0"]
    runs, prof, prof_paged = {}, None, None
    for label, depth, extra, kernels in (
            ("slab", SLAB_E_LAYERS, [], ("grouped[fp]", "ovp_matmul[fp]",
                                         "decode_attn", "ovp_encode")),
            ("paged", PAGED_E_LAYERS, ["--paged", "16", "--prefill-chunk",
                                       "16"],
             ("grouped[fp]", "ovp_matmul[fp]", "paged_decode_attn",
              "prefill_attn", "ovp_encode"))):
        free_device_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        with cut_arch(MOE_ARCH, depth) as arch:
            res = serve.run(["--arch", arch] + base + extra, device=dev)
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
        print(f"[serve E] {MOE_ARCH} ({n_layers} of the published 48 "
              f"layers) W4 experts + KV4, {label}: PTQ "
              f"{res['ptq_s']:.2f}s (layer by layer), peak device memory "
              f"{peak_gb:.2f} GB, "
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
            prof = profile_decode(res, "phase E, graph", steps=3,
                                  max_new=10)
            truncated_reference_check(res, dev)
        else:
            prof_paged = profile_decode(
                res, f"{MOE_ARCH}, W4 experts + KV4, paged 16", steps=3,
                max_new=10)
        runs[label] = {"tokens": {r.uid: r.out_tokens for r in done},
                       "counts": counts, "tok_per_s": res["tok_per_s"],
                       "peak_gb": peak_gb}
        del res, done
    print(f"[serve E] peak device memory slab {runs['slab']['peak_gb']:.2f} "
          f"GB ({SLAB_E_LAYERS} layers), paged "
          f"{runs['paged']['peak_gb']:.2f} GB "
          f"({PAGED_E_LAYERS} layers; one model each)")
    if prof is not None and prof["k6_ms"] is not None:
        print(f"[serve E] decode step (slab, 4 slots): K6 "
              f"{prof['k6_ms']:.3f} device ms per step, K2 "
              f"{prof['attn_ms']:.3f}, paged K3 {prof_paged['attn_ms']:.3f}, "
              f"device busy {prof['busy_ms']:.3f}ms = "
              f"{100 * prof['busy_ms'] / prof['prof_ms']:.1f}% of the "
              f"profiled wall; tok/s slab {runs['slab']['tok_per_s']:.2f}, "
              f"paged {runs['paged']['tok_per_s']:.2f} ({PAGED_E_LAYERS} "
              f"layers)")
    return runs


def truncated_reference_check(res, dev, label: str = "W4 experts",
                              paged: bool = False, tag: str = "E",
                              n_layers: int = 2):
    """A 2-layer (`n_layers`) truncation of the served full-width model
    (same widths,
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
    small = build_model(dataclasses.replace(model.cfg, n_layers=n_layers),
                        model.policy.replace_all(kv_bits=0))
    p2 = dict(params, layers=params["layers"][:n_layers])
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
                 f"(layer {i % n_layers}): {n_diff} of {y.numel()} routed "
                 f"expert "
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
    print(f"[ref {tag}] {name} truncated to {n_layers} layers, {label}, "
          f"fp32 KV: "
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
MIXED_E_LAYERS = 8      # mixed E's depth, cut from the published 48 for
#                         time (12 until PR 28)
MIXED_A_LAYERS = 12     # mixed A's depth, cut from the published 24 for time
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


K1_PER_LAYER = {"rglru": 8, "mlstm": 5, "slstm": 6}  # other layers: 7


def layer_linears(layer):
    """A served layer's quantized linears (K1's, not the experts' K6
    stacks), in the tree's order."""
    from repro_torch.core.ovp import QuantizedTensor
    from repro_torch.core.qlinear import tree_paths
    return [w for sub in ("attn", "rec", "mlp", "mlstm", "slstm")
            for _, w in tree_paths(layer.get(sub, {}))
            if isinstance(w, QuantizedTensor)]


def check_k1_weight_counts(res, counts, phase: str, mode: str = "fp"):
    """K1 runs once per quantized linear (7 an attention layer, 8 an
    RG-LRU layer, 5 an mLSTM layer, 6 an sLSTM layer; the head stays fp)
    per forward call, all in `mode`,
    and the launches with int8 weights are the W8 linears' (counted off
    the tree's leaves) each forward call. Returns the W8 linears'
    count."""
    st = res["engine"].stats()
    forwards = st["prefills_run"] + st["prefill_chunks_run"] \
        + st["decodes_run"]
    model = res["model"]
    leaves = [w for layer in res["params"]["layers"]
              for w in layer_linears(layer)]
    per_layer = sum(K1_PER_LAYER.get(model.block_type(i), 7)
                    for i in range(model.cfg.n_layers))
    n_w8 = sum(w.normal_dtype == "int8" for w in leaves)
    want = {f"ovp_matmul[{mode}]": len(leaves) * forwards,
            "ovp_matmul<int8>": n_w8 * forwards,
            "ovp_matmul<int4>": (len(leaves) - n_w8) * forwards}
    got = {key: counts[key] for key in want}
    if got != want or len(leaves) != per_layer:
        fail(f"{phase}: K1 launches {got}, expected {want} ({len(leaves)} "
             f"quantized linears, {n_w8} at W8, {forwards} forward calls)")
    return n_w8


def k1_layer_record(dev, gen, linears, rows: int, w_dtype: str,
                    mode: str = "fp", label: str = "k1"):
    """K1 at `linears` (one QuantizedTensor a launch) on `rows` rows of
    random activations, in `mode` (fp; quantize: activations at their
    dynamic 3-sigma scale in `w_dtype`'s width; or static: at one scale,
    K5), against the plain version (rtol
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
        sw = mm._col_scale(qt.scale, n, dev).contiguous()
        kw = dict(w_dtype=w_dtype, a_mode=mode, a_dtype=w_dtype)
        sa = None
        if mode == "static":
            kw["s_static"] = float(sigma_init_scale(a, w_dtype))
        if mode == "quantize":
            sa = torch.broadcast_to(sigma_init_scale(a, w_dtype),
                                    (rows,)).contiguous()

        def kern():
            return mm.run(a, sa, qt.data, sw, **kw)

        def plain():
            return mm.fused_ovp_matmul_plain(a, sa, qt.data, sw, **kw)

        got, ref = kern(), plain()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        plan = mm.launch_plan(rows, k, n, w_dtype, a_mode=mode)
        if not within(got, ref, 1e-5, 1e-5 * scale):
            fail(f"{label} {mode} rows={rows} K={k} N={n} ({plan.body} "
                 f"body, split {plan.split}, slice {plan.slice}): max abs "
                 f"err {err:.3e} over tolerance (rtol 1e-5, atol "
                 f"1e-5*{scale:.3e})")
        wd = ovp_dequantize(qt)
        b_ms, b_by = bound_ms(
            rows * k * 4 + k * n * w_bytes + n * 4 + rows * n * 4
            + (rows * 4 if sa is not None else 0), 2.0 * rows * k * n)
        rec = dict(ms=time_ms(kern)[0], plain_ms=time_ms(plain)[0],
                   bound_ms=b_ms,
                   library_ms=time_ms(lambda: torch.matmul(a, wd))[0])
        del wd
        print(f"[{label}] {mode} rows={rows} K={k:5d} N={n:5d}: "
              f"{plan.body} body, split {plan.split}, slice {plan.slice} "
              f"pairs, share {plan.share}, {plan.blocks} blocks, "
              f"{plan.smem} shared bytes; "
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
    """Mixed W4/W8 policy programs on full-width Qwen1.5-0.5B,
    `MIXED_A_LAYERS` deep (cut from the published 24 for time), through
    the launcher's entry point, the launcher's workload: `--quant
    olive_mixed_w48` (the first and last layer W8, the rest W4, fp32 KV:
    the launcher's rewrite leaves no packed cache), `--quant
    olive_owq_style` (every layer's wq and wk W8), and `olive_mixed_w48
    --policy-rules "layers/0/attn/kv=olive_serve,layers/<last>/attn/kv=
    olive_serve"` slab
    and paged (16, chunk 16): packed caches on the first and last layer,
    fp32 between, in one captured step. Counters reset just before and
    read just after each run: no fallback; K1 7 x layers launches a
    forward call, those with int8 weights exactly the W8 linears' (14 or
    2 x layers a call); one K2/K3 a layer a step over the fp and packed
    caches alike, one K4 a layer a chunk; K7 only on the packed layers.
    Each engine passes the audit and `capture_gate`; each program, slab
    and paged, is held to its CPU twin (`reference_check`), and the
    mixed-KV slab step is profiled. Then one `--calibrate` run of
    `olive_mixed_w48`: every linear on K5, the W8 layers with 8-bit
    activations. Returns the runs' counts, the mixed-KV profile and the
    K1 W8 timings."""
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    last = MIXED_A_LAYERS - 1
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
        with cut_arch(ARCH, MIXED_A_LAYERS) as arch:
            res = serve.run(["--arch", arch] + SERVE_ARGS + extra,
                            device=dev)
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
        print(f"[mixed A] {arch} {' '.join(extra)}: W8 linears {n_w8} of "
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
    with cut_arch(ARCH, MIXED_A_LAYERS) as arch:
        res = serve.run(["--arch", arch] + SERVE_ARGS + [
            "--quant", "olive_mixed_w48", "--calibrate", "--calibration",
            MIXED_CALIB], device=dev)
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
    import torch
    from repro_torch.core.ovp import MixedExpertQuant
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    phase = "mixed E"
    rules = f"*experts/*/[0-{W8_EXPERTS - 1}]=olive_w8a8"
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    with cut_arch(MOE_ARCH, n_layers) as arch:
        res = serve.run(["--arch", arch, "--quant", "olive_serve",
                         "--policy-rules", rules] + SERVE_ARGS, device=dev)
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


def k5_wide_phase(dev):
    """K5 (K1's static mode, activations at one calibrated scale) at the
    widths phase H serves it: one Qwen2-7B layer's 7 decode launches at
    rows 4 with int4 weights and with int8 weights (W8A8, the sites
    `auto_mixed` promotes), and one Qwen3-30B-A3B attention block's 4
    launches with int4 weights, each through `k1_layer_record` (held to
    the plain version at rtol 1e-5, atol 1e-5 * max|ref|; timed beside
    `torch.matmul` on the dequantized weight and the byte bound).
    Returns {"qwen2-7b <dtype>" | "moe attn": the summed record}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import policy
    from repro_torch.core.qlinear import quantize_weight
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for key, shapes, pol in (
            ("qwen2-7b int4", dense_layer_shapes(get_config("qwen2-7b")),
             policy.OLIVE_W4A4),
            ("qwen2-7b int8", dense_layer_shapes(get_config("qwen2-7b")),
             policy.OLIVE_W8A8),
            ("moe attn", QWEN3_ATTN, policy.OLIVE_W4A4)):
        w_dtype = "int8" if pol.wbits == 8 else "int4"
        linears = [quantize_weight(torch.randn((k, n), generator=gen,
                                               device=dev) / k ** 0.5, pol)
                   for k, n in shapes]
        tot = k1_layer_record(dev, gen, linears, 4, w_dtype, "static",
                              label=f"k5 {key}")
        print(f"[k5 {key}] {len(linears)} decode launches, rows 4, static "
              f"(one activation scale), {w_dtype} weights: err "
              f"{tot['max_abs_err']:.2e} (tol rtol 1e-5, atol "
              f"1e-5*max|ref|), kernel {tot['ms']:.4f}ms, matmul "
              f"{tot['library_ms']:.4f}ms, bound {tot['bound_ms']:.5f}ms "
              f"({tot['bound_by']}), plain {tot['plain_ms']:.4f}ms")
        out[key] = tot
        del linears
    return out


def serve_phase_f(dev, smi: str, with_paged: bool = False):
    """The dense 7-8B models at full published width through the
    launcher's entry point (`--arch A --quant olive_serve`, the
    launcher's workload): Qwen2-7B, Yi-6B and Minitron-8B slab (a paged
    Qwen2-7B run, `--paged 16 --prefill-chunk 16`, when `with_paged`:
    `main` leaves it out for time), the card freed between
    runs. Counters reset just before and read just after each
    run: no fallback; K1 `fp` once per quantized linear (7 a layer, int4
    weights) per forward call and none for the unquantized head; K2 (K3
    and K4 paged) once a layer a step or chunk; K7 twice a layer a cache
    write; 8 requests x 16 tokens; every page returned. Then the audit,
    `capture_gate(steps=3)`, the decode-step profile, and the 2-layer
    card-vs-CPU check (slab, or paged over fp32 pools). Prints
    PTQ seconds, peak device memory, tok/s, mean TTFT, mean step, the
    profile and the step's roofline beside the card. Returns each
    run's counts, engine stats and profile."""
    import torch
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    runs = {}
    for arch, paged in [(a, False) for a in DENSE_ARCHS] \
            + ([(DENSE_ARCHS[0], True)] if with_paged else []):
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
              f"decode steps), dispatch {counts['dispatch']} ({smi})")
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
                  f"{prof['attn_ms']:.3f}ms; roofline "
                  f"{prof['roofline'].t_bound * 1e3:.3f}ms ({smi})")
        truncated_reference_check(res, dev, label="W4", paged=paged,
                                  tag="F")
        if arch == DENSE_ARCHS[0] and not paged:
            long_prefill_check(res, dev)
        if sum(buckets.values()) != st["prefills_run"]:
            fail(f"{phase}: prefills by bucket {buckets}, "
                 f"{st['prefills_run']} prefills run")
        runs[(arch, paged)] = {"counts": counts, "stats": st,
                               "profile": prof, "buckets": buckets,
                               "peak_gb": peak_gb}
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


# --------------------------------------------------------------------------
# Phase H: calibration at full width, streamed, and the sensitivity pass
# --------------------------------------------------------------------------
H_DENSE = "qwen2-7b"
H_CALIB = {H_DENSE: os.path.join(ROOT, "build", "calib",
                                 "qwen2-7b-auto_mixed.json"),
           MOE_ARCH: os.path.join(ROOT, "build", "calib",
                                  f"{MOE_ARCH}.json")}
AUTO_MIXED_BUDGET = 4.5     # mean weight bits: 1/8 of the linears at W8
H2_LAYERS = 8               # H2's depth, cut from the published 48 for time
#                             (12 until PR 28)


def sensitivity_pass(dev, arch: str, seed: int = 0):
    """The weight sensitivity pass at full width without the fp32 tree:
    the tape planned over the tree's shapes (`record_weights` on
    `device="meta"` weights into a `SizeTape`), then each piece of
    `Model.init_stream` (the weights `--seed` draws, embedding and head
    first, then each layer) taped and dropped, `site_sensitivity` on the
    card and `auto_mixed(budget_bits=AUTO_MIXED_BUDGET)`. Returns the
    promoted sites (most sensitive first), the SQNR map and seconds."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import calibration as cal
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    model = build_model(get_config(arch))
    tape = cal.ActTape().plan(cal.record_weights(
        model.init(None, device="meta"), cal.SizeTape()).records)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for prefix, tree in model.init_stream(gen, dev):
        cal.record_weights(tree, tape, prefix=prefix)
        del tree
    sens = cal.site_sensitivity(tape, device=dev)
    prog = cal.auto_mixed(sens, budget_bits=AUTO_MIXED_BUDGET)
    promoted = [r.pattern for r in prog.rules if r.origin != "compat"]
    return promoted, sens, time.perf_counter() - t0


def layer_fp32_bytes(arch: str) -> int:
    """One layer's fp32 weight bytes, from its shapes."""
    from repro_torch.configs import get_config
    from repro_torch.core.qlinear import tree_paths
    from repro_torch.models.model import build_model
    pieces = build_model(get_config(arch)).init_stream(None, "meta")
    next(pieces)
    _, block = next(pieces)
    return sum(w.numel() * 4 for _, w in tree_paths(block))


def streamed_artifact_check(res, dev, base_policy) -> None:
    """On a 2-layer cut of the served config (full width) on the card,
    two seeded (2, 64) batches: `calibrate_streamed`'s artifact must be
    byte for byte `calibrate_model`'s on the whole fp32 tree drawn from
    the same seed, and its params equal `quantize_params` of that tree
    under the calibrated program."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import calibration as cal
    from repro_torch.core.qlinear import quantize_params, tree_paths
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(res["model"].cfg, n_layers=2)
    model = build_model(cfg, base_policy)
    rng = np.random.default_rng(9)
    batches = [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                       (2, 64)), device=dev)}
               for _ in range(2)]
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    whole = cal.calibrate_model(model, params, batches)
    want = quantize_params(params, cal.apply_calibration(base_policy, whole))
    del params
    got, streamed = cal.calibrate_streamed(
        model, torch.Generator(device=dev).manual_seed(0), batches, dev,
        lambda tree, prefix: quantize_params(tree, base_policy,
                                             prefix=prefix))
    blobs = []
    for name, art in (("whole", whole), ("streamed", streamed)):
        path = os.path.join(ROOT, "build", "calib",
                            f"{cfg.name}-2-layers-{name}.json")
        with open(art.save(path), "rb") as f:
            blobs.append(f.read())
    differ = [p for (p, a), (_, b) in zip(tree_paths(got), tree_paths(want))
              if not all(torch.equal(x, y) for x, y in zip(
                  _tensors(a), _tensors(b)))]
    print(f"[calib H] {cfg.name} cut to 2 layers, 2 batches of (2, 64), on "
          f"the card: streamed artifact {len(streamed.sites())} sites, "
          f"JSON {'byte-equal' if blobs[0] == blobs[1] else 'DIFFERS'} to "
          f"the whole tree's; quantized params "
          f"{'equal' if not differ else f'differ at {differ[:4]}'}")
    if blobs[0] != blobs[1] or differ:
        fail(f"phase H: the streamed calibration of {cfg.name} differs "
             f"from the whole tree's")


def _tensors(leaf):
    """A params leaf's tensors: a quantized one's codes and scales."""
    return (leaf.data, leaf.scale) if hasattr(leaf, "scale") else (leaf,)


def serve_phase_h(dev, smi: str, peak_f_gb: float, peak_e_gb: float):
    """Calibrate-then-serve at full published width and depth, the
    calibration streamed layer by layer (`calibrate_streamed`).

    H1, Qwen2-7B: the weight sensitivity pass (`sensitivity_pass`), then
    `--quant olive_serve --calibrate --policy-rules <each promoted
    site>=olive_w8a8` through the launcher, slab: the `auto_mixed`
    program, W4A4 with 1/8 of the linears W8A8, every linear on K5.
    H2, Qwen3-30B-A3B cut to `H2_LAYERS` of its 48 layers (for time):
    `--quant olive_serve --calibrate`, slab: the attention linears W4A4
    on K5, the experts weight-only on K6.

    Counters reset just before and read just after each run: no
    fallback; K5 once per quantized linear per forward call (by weight
    dtype, int8 exactly the promoted sites), no K1 `fp` or `quantize`
    launch and no dynamic act-scale resolution; K6 `grouped[fp]` = 3 x
    layers x forward calls on the MoE; K2 and K7 as in phase A. Then
    the audit, `capture_gate(steps=3)`, the decode-step profile and the
    2-layer card-vs-CPU check of the calibrated program (routing first
    on the MoE); on H1 also `streamed_artifact_check`. Prints peak
    device memory (H1 beside phase F's Qwen2-7B run; H2 held to phase
    E's 48-layer peak less the served weight and cache bytes of the
    layers cut, + 2 layers of fp32 weights + 1 GB) and the calibration
    and PTQ seconds. Returns each run's counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import PolicyProgram
    from repro_torch.launch import serve
    from repro_torch.roofline.step_stats import tree_bytes
    t_phase = time.perf_counter()
    promoted, sens, sens_s = sensitivity_pass(dev, H_DENSE)
    n_cand = 7 * get_config(H_DENSE).n_layers
    if len(promoted) != int((AUTO_MIXED_BUDGET - 4) / 4 * n_cand):
        fail(f"phase H: auto_mixed promoted {len(promoted)} of {n_cand} "
             f"linears at a {AUTO_MIXED_BUDGET}-bit budget")
    print(f"[sens H] {H_DENSE}: {len(sens)} weight sites taped one layer "
          f"at a time and ranked in {sens_s:.2f}s; auto_mixed("
          f"budget_bits={AUTO_MIXED_BUDGET}) promotes {len(promoted)} of "
          f"{n_cand} linears to W8A8, SQNR {sens[promoted[0]]:.2f}-"
          f"{sens[promoted[-1]]:.2f} dB (the rest up to "
          f"{max(sens.values()):.2f} dB): {promoted}")
    rules = ",".join(f"{site}=olive_w8a8" for site in promoted)
    runs = {}
    for arch, extra in ((H_DENSE, ["--policy-rules", rules]),
                        (MOE_ARCH, [])):
        phase = f"serve phase H ({arch})"
        moe = arch == MOE_ARCH
        free_device_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        depth = H2_LAYERS if moe else get_config(arch).n_layers
        with cut_arch(arch, depth) as name:
            reset_counts()
            res = serve.run(["--arch", name, "--quant", "olive_serve",
                             "--calibrate", "--calibration", H_CALIB[arch]]
                            + extra + SERVE_ARGS, device=dev)
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        eng, cfg = res["engine"], res["model"].cfg
        st = eng.stats()
        forwards = st["prefills_run"] + st["prefill_chunks_run"] \
            + st["decodes_run"]
        kernels = ("ovp_matmul[static]", "decode_attn", "ovp_encode") \
            + (("grouped[fp]",) if moe else ())
        check_counts(counts, phase, kernels)
        check_attn_counts(res, counts, phase, paged=False)
        check_encode_counts(eng, counts, phase)
        linears = 4 if moe else 7
        n_w8 = len(promoted) if not moe else 0
        want = {"ovp_matmul[static]": linears * cfg.n_layers * forwards,
                "ovp_matmul[fp]": 0, "ovp_matmul[quantize]": 0,
                "ovp_matmul<int8>": n_w8 * forwards,
                "ovp_matmul<int4>": (linears * cfg.n_layers - n_w8)
                * forwards,
                "grouped[fp]": 3 * cfg.n_layers * forwards if moe else 0}
        got = {key: counts[key] for key in want}
        if got != want:
            fail(f"{phase}: launches {got}, expected {want} ({forwards} "
                 f"forward calls)")
        if counts["act_scale"] != {"static": want["ovp_matmul[static]"]}:
            fail(f"{phase}: act-scale resolutions {counts['act_scale']}")
        sites = res["artifact"].sites()
        if len(sites) != linears * cfg.n_layers + 1:
            fail(f"{phase}: the artifact has {len(sites)} sites")
        done = res["completed"]
        if len(done) != 8 or any(len(r.out_tokens) != 16 for r in done):
            fail(f"{phase}: {len(done)} requests finished with "
                 f"{[len(r.out_tokens) for r in done]} tokens, expected "
                 f"8 x 16")
        # the MoE's fp32 tree cannot be on the card: held to a bound at
        # this run's depth, phase E's slab peak (`SLAB_E_LAYERS` deep)
        # less the served bytes (weights and caches, per layer from this
        # run) of the layers cut
        if moe:
            full_layers = SLAB_E_LAYERS
            per_layer = (tree_bytes(res["params"]["layers"])
                         + tree_bytes(eng.caches["layers"])) / cfg.n_layers
            cut = full_layers - cfg.n_layers
            peak_e_cut = peak_e_gb - cut * per_layer / 1e9
            bound = peak_e_cut + 2 * layer_fp32_bytes(arch) / 1e9 + 1.0
            beside = (f"bound {bound:.2f} GB = phase E's {peak_e_gb:.2f} "
                      f"at {full_layers} layers less {cut} x "
                      f"{per_layer / 1e9:.3f} GB of served weights and "
                      f"caches a layer ({peak_e_cut:.2f}) + 2 layers of fp32 "
                      f"weights + 1")
        else:
            beside = f"phase F's W4 run {peak_f_gb:.2f} GB"
        print(f"[serve H] {arch} ({cfg.n_layers} of "
              f"{get_config(arch).n_layers} layers) "
              + ("W4A4 attention + W4 experts" if moe else
                 f"auto_mixed W4A4 + {n_w8} W8A8 linears")
              + f" + KV4 on static scales, slab: {len(sites)} scales "
              f"calibrated in {res['calib_s']:.2f}s (streamed), PTQ "
              f"{res['ptq_s']:.2f}s, peak device memory {peak_gb:.2f} GB "
              f"({beside}), {res['tokens']} tokens in {res['seconds']:.3f}s "
              f"= {res['tok_per_s']:.2f} tok/s, mean TTFT "
              f"{res['mean_ttft_s'] * 1e3:.2f}ms, mean step "
              f"{res['mean_step_s'] * 1e3:.2f}ms; launches "
              + " ".join(f"{k}={v}" for k, v in got.items())
              + f" ({forwards} forward calls), act-scale resolutions "
              f"{counts['act_scale']}, dispatch {counts['dispatch']} "
              f"({smi})")
        if moe and peak_gb > bound:
            fail(f"{phase}: peak device memory {peak_gb:.2f} GB over the "
                 f"{beside}")
        audit_check(eng, phase)
        capture_gate(eng, f"H ({arch})", steps=3)
        prof = profile_decode(res, f"{arch}, calibrated, static scales",
                              steps=3, max_new=10)
        if prof["k1_ms"] is not None:
            print(f"[serve H] {arch} calibrated decode step (4 slots): "
                  f"{prof['kernels_per_step']:.1f} device kernels, busy "
                  f"{prof['busy_ms']:.3f}ms of {prof['prof_ms']:.2f}ms "
                  f"profiled wall ({prof['step_ms']:.2f}ms plain), K5 "
                  f"{prof['k1_ms']:.3f}ms"
                  + (f", K6 {prof['k6_ms']:.3f}ms" if moe else "")
                  + f", K2 {prof['attn_ms']:.3f}ms ({smi})")
        truncated_reference_check(
            res, dev, label="static scales, " + (
                "W4A4 attention, W4 experts" if moe else "auto_mixed"),
            tag="H")
        if not moe:
            base = PolicyProgram(rules=res["policy"].rules,
                                 default=res["policy"].default,
                                 name=res["policy"].name)
            streamed_artifact_check(res, dev, base)
        runs[arch] = {"counts": counts, "peak_gb": peak_gb,
                      "profile": prof}
        del res, eng, done
    print(f"[serve H] phase took {time.perf_counter() - t_phase:.1f}s")
    return runs


# --------------------------------------------------------------------------
# The hybrid family: RecurrentGemma-9B (RG-LRU blocks + local attention)
# --------------------------------------------------------------------------
HYBRID_ARCH = "recurrentgemma-9b"
# one decode step of the served model: K1 8 a rglru layer x 26 + 7 a
# local-attention layer x 12, K2 one a local layer, K7 two a local layer
HYBRID_STEP_LAUNCHES = {"ovp_matmul[fp]": 292, "decode_attn": 12,
                        "ovp_encode": 24}
HYBRID_CUT = 3          # the card-vs-CPU checks' depth: one whole period
RING_PROMPT = 2100      # tokens: past the 2048-token window
RING_STEPS = 64         # greedy decode steps over the ring
RING_MAX_LEN = 2560     # the local cache is min(window, max_len) slots


def _masked_library(q, kdense, vdense, valid, g: int):
    """SDPA on the dense f32 K/V under a (B, S) validity mask: one
    PyTorch call computing K2's function with a window or a ring."""
    import torch.nn.functional as F
    qh, kh, vh = (q.transpose(1, 2), kdense.transpose(1, 2),
                  vdense.transpose(1, 2))
    mask = valid[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                  attn_mask=mask,
                                                  enable_gqa=g > 1)


def k2_record(q, cache, pos, window: int, ring: int, label: str):
    """K2 at one call against its plain version (atol 1e-5), timed beside
    it, SDPA under the same mask and the bound (the bytes of the slots
    the mask keeps and the operations over them). Returns the record."""
    import torch
    from repro_torch.kernels import decode_attn as da
    b, _, h, d = q.shape
    kdense, vdense = da.read_cache_dense(cache, dtype=torch.float32)
    s_len, hkv = kdense.shape[1], kdense.shape[2]

    def kern():
        return da.fused_decode_attention(q, cache, pos, window=window,
                                         ring=ring)

    def plain():
        return da.decode_attention_plain(q, cache, pos, window=window,
                                         ring=ring)

    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not within(got, ref, 0.0, 1e-5):
        fail(f"K2 {label}: max abs err {err:.3e} over atol 1e-5")
    _, valid = da.slot_validity(pos.long(), torch.arange(s_len,
                                                         device=q.device),
                                window=window, ring=ring)
    n_valid = int(valid.sum())
    per_tok = hkv * (d + 8) if "k_data" in cache \
        else hkv * d * cache["k"].element_size() * 2
    b_ms, b_by = bound_ms(2 * b * h * d * 4 + b * 4 + n_valid * per_tok,
                          4.0 * n_valid * (h // hkv) * hkv * d)
    rec = dict(max_abs_err=err, ms=time_ms(kern)[0],
               plain_ms=time_ms(plain)[0],
               library_ms=time_ms(_masked_library(q, kdense, vdense, valid,
                                                  h // hkv))[0],
               bound_ms=b_ms, bound_by=b_by)
    print(f"[k2 {label}] B={b} S={s_len} Hkv={hkv} G={h // hkv} D={d} "
          f"window {window} ring {ring}, {n_valid} valid slots: err "
          f"{err:.2e} (tol atol 1e-5) kernel={rec['ms']:.4f}ms plain="
          f"{rec['plain_ms']:.4f}ms sdpa={rec['library_ms']:.4f}ms bound="
          f"{b_ms:.5f}ms ({b_by})")
    return rec


def ring_check(res, dev, smi: str, t: int = RING_PROMPT,
               steps: int = RING_STEPS, max_len: int = RING_MAX_LEN):
    """The local-attention ring on the card: a `HYBRID_CUT`-layer
    truncation of the served full-width model (rglru, rglru,
    local_attn; the same quantized params) in an engine of one slot at
    `max_len`, so the local cache is a 2048-slot ring. One `t`-token
    prompt (past the window: the prefill keeps tokens t-2048..t-1 in
    ring order) through its exact-length prefill entry twice (warm-up
    and capture, then a replay: bit for bit), then `steps` greedy decode
    steps through the captured decode step, each K2 at window 2048,
    ring 2048 (the wrapper's arguments are recorded while the step is
    built; the launches counted).

    Over an fp32 KV cache, the logits of the last prompt position and
    of every decode step are held against the same model's plain path
    on the CPU over the same tokens (the card's greedy tokens fed, as
    `_torch_parity.port_forced` does): one sliding-window prefill of
    the prompt and the fed tokens, its logits read at those positions
    (a CPU decode step would dequantize every full-width weight again;
    the prefill's window attention and RG-LRU scan compute the same
    function by another path). Max |diff| <= 1e-3 * max|ref|, greedy
    tokens equal. Then the served KV4 cache: the same steps must give
    finite logits; their distance to the fp32 run (a 4-bit KV cache is
    another function: first decode step, and where the greedy tokens
    part) and to the CPU's plain path with the same KV4 ring (the
    prompt's prefill into the ring, then one decode step fed the
    card's token) are printed, not bounded (a last-bit difference can
    move a value across a 4-bit boundary, as `reference_check` says),
    and K2 is timed on the final ring state (`k2_record`). Returns the
    K2 record and the launches of the KV4 run's decode steps."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels import decode_attn as da
    from repro_torch.models.layers import cache_len
    from repro_torch.models.model import block_forward, build_model
    from repro_torch.serve.engine import EngineCfg, ServingEngine, \
        _splice_slot
    model, params = res["model"], res["params"]
    cfg = dataclasses.replace(model.cfg, n_layers=HYBRID_CUT)
    p3 = dict(params, layers=params["layers"][:HYBRID_CUT])
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, size=t)
    seen, real_run = set(), da._run

    def recording(q, cache, pos, window, ring):
        seen.add((window, ring, cache_len(cache)))
        return real_run(q, cache, pos, window, ring)

    runs = {}
    for kv in ("fp32", "KV4"):
        small = build_model(cfg, model.policy if kv == "KV4"
                            else model.policy.replace_all(kv_bits=0))
        eng = ServingEngine(small, p3, EngineCfg(batch_slots=1,
                                                 max_len=max_len),
                            device=dev)
        site = eng.caches["layers"][2]["kv"]
        if cache_len(site) != cfg.window:
            fail(f"ring check: the local cache has {cache_len(site)} slots,"
                 f" not a {cfg.window}-slot ring")
        first, replay = [[x.clone() for x in eng._prefill(prompt)]
                         for _ in range(2)]
        if not torch.equal(first[0], replay[0]):
            fail(f"ring check {kv}: the {t}-token prefill's warm-up and "
                 f"replay differ")
        _splice_slot(eng.caches, eng._row_cache, 0)
        logits, tok = [replay[0]], int(replay[1])
        fed = []
        reset_counts()
        da._run = recording
        try:
            for i in range(steps):
                fed.append(tok)
                row, nxt = eng._decode.run(
                    tokens=np.array([[tok]], np.int64),
                    pos=np.array([t + i], np.int32))
                logits.append(row[0].clone())
                tok = int(nxt[0])
        finally:
            da._run = real_run
        counts = read_counts()
        check_counts(counts, f"ring check {kv}",
                     ("ovp_matmul[fp]", "decode_attn"))
        if counts["decode_attn"] != steps or eng._decode.graph is None:
            fail(f"ring check {kv}: {counts['decode_attn']} K2 launches "
                 f"over {steps} decode steps, captured "
                 f"{eng._decode.graph is not None}")
        runs[kv] = (torch.stack(logits).float().cpu(), fed, counts, eng)
    if seen != {(cfg.window, cfg.window, cfg.window)}:
        fail(f"ring check: K2 was called with (window, ring, slots) "
             f"{sorted(seen)}, expected the {cfg.window}-slot ring")
    got, fed, _, _ = runs["fp32"]
    # the CPU: one window prefill over the prompt and the fed tokens
    small = build_model(cfg, model.policy.replace_all(kv_bits=0))
    cpu_p = _to(p3, "cpu")
    toks = torch.as_tensor(np.concatenate([prompt, fed]))[None]
    t0 = time.perf_counter()
    x = small.embed(cpu_p, toks)
    positions = torch.arange(toks.shape[1])[None]
    for i, layer in enumerate(cpu_p["layers"]):
        x, _ = block_forward(layer, x, positions, cfg, small.policy,
                             site=f"layers/{i}")
    ref = small.head(cpu_p, x[:, t - 1:])[0].float()
    cpu_s = time.perf_counter() - t0
    v = cfg.vocab
    err = float((got[:, :v] - ref[:, :v]).abs().max())
    tol = 1e-3 * float(ref[:, :v].abs().max())
    same = bool(torch.equal(got[:, :v].argmax(-1), ref[:, :v].argmax(-1)))
    kv4, fed4 = runs["KV4"][0], runs["KV4"][1]
    first_diff = float((kv4[1, :v] - got[1, :v]).abs().max())
    part = next((i for i, (a, b) in enumerate(zip(fed4, fed)) if a != b),
                None)
    finite = bool(torch.isfinite(kv4).all())
    # the CPU over the same KV4 ring: the prompt's prefill, one decode step
    small4 = build_model(cfg, model.policy)
    caches = small4.init_caches(1, max_len, device="cpu")
    x = small4.embed(cpu_p, toks[:, :t])
    for i, layer in enumerate(cpu_p["layers"]):
        x, caches["layers"][i] = block_forward(
            layer, x, positions[:, :t], cfg, small4.policy,
            cache=caches["layers"][i], site=f"layers/{i}")
    ref4 = [small4.head(cpu_p, x[:, -1:])[0, 0]]
    lg, _ = small4.forward(cpu_p, {"tokens": torch.tensor([[fed4[0]]]),
                                   "pos": torch.tensor([t])},
                           mode="decode", caches=caches)
    ref4 = torch.stack(ref4 + [lg[0, 0]]).float()
    cpu4_diff = float((kv4[:2, :v] - ref4[:, :v]).abs().max())
    print(f"[ring I] {cfg.name} cut to {HYBRID_CUT} layers "
          f"({', '.join(small.block_type(i) for i in range(HYBRID_CUT))}), "
          f"max_len {max_len}: a {t}-token prompt through its captured "
          f"exact-length prefill entry (warm-up and replay bit-identical),"
          f" then {steps} greedy decode steps on the captured decode step, "
          f"K2 called with window {cfg.window}, ring {cfg.window} over a "
          f"{cfg.window}-slot ring ({runs['fp32'][2]['decode_attn']} K2 "
          f"launches); fp32 KV, card vs the CPU's plain path (one window "
          f"prefill of the {t + steps} tokens, {cpu_s:.1f}s): max |diff| "
          f"{err:.3e} over {steps + 1} positions (tol {tol:.3e} = 1e-3 * "
          f"max|ref|), greedy tokens {'equal' if same else 'differ'}; "
          f"the served KV4 ring: logits {'finite' if finite else 'NOT '}"
          f"{'' if finite else 'finite'}; at the first decode step "
          f"max |diff| {first_diff:.3e} to the fp32 run, greedy tokens "
          + (f"part from it at decode step {part + 1}" if part is not None
             else "equal to it") + f" (not bounded); against the CPU's "
          f"plain path over the same KV4 ring (prefill + 1 decode step) "
          f"max |diff| {cpu4_diff:.3e} (not bounded) ({smi})")
    if not np.isfinite(err) or err > tol or not same or not finite:
        fail("ring check: card and CPU disagree")
    eng = runs["KV4"][3]
    ring = eng.caches["layers"][2]["kv"]
    gen = torch.Generator(device=dev).manual_seed(21)
    q = torch.randn((1, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=dev)
    pos = torch.tensor([t + steps - 1], dtype=torch.int32, device=dev)
    rec = k2_record(q, ring, pos, cfg.window, cfg.window,
                    f"ring {cfg.window}, packed")
    return rec, runs["KV4"][2]["decode_attn"]


def serve_phase_i(dev, smi: str):
    """The hybrid family at full published width and depth through the
    launcher's entry point: RecurrentGemma-9B (`--arch
    recurrentgemma-9b --quant olive_serve`: 38 layers, 12 x (rglru,
    rglru, local_attn) + 2 rglru, d_model 4096, MQA 16 heads of 256,
    window 2048, d_ff 12288, d_rnn 4096, untied 256000 vocab), slab, the
    launcher's workload. Counters reset just before and read just after:
    no fallback; K1 `fp` once per quantized linear (8 a rglru layer, 7
    a local one) per forward call, none for the fp32 head; K2 once per
    local layer per decode step; K7 twice per local layer per cache
    write; a decode step's launches exactly `HYBRID_STEP_LAUNCHES`
    (292, 12, 24; the profiler's kernel counts are printed beside them,
    not gated: a trace can drop events); 8 requests x 16 tokens. Then
    the audit (one prefill entry per distinct prompt length: the model
    cannot bucket), `capture_gate` (the recurrent
    states among the cache bytes), `sync_check`, the decode-step profile
    beside the step's roofline, the `HYBRID_CUT`-layer card-vs-CPU
    check and `ring_check`. Then K1 at one rglru layer's 8 and one local layer's 7
    decode launches (the served weights, rows 4, `k1_layer_record`) and
    K2 at the served shape (B 4, S 256, window 2048 over 256 slots: no
    ring at max_len 256). Prints PTQ seconds, peak device memory, tok/s,
    mean TTFT and mean step beside the card. Returns the counts and the
    kernel records."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.layers import _quant_kv_token
    t_phase = time.perf_counter()
    phase = f"serve phase I ({HYBRID_ARCH}, slab)"
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    res = serve.run(["--arch", HYBRID_ARCH, "--quant", "olive_serve"]
                    + SERVE_ARGS, device=dev)
    load_s = time.perf_counter() - t0 - res["seconds"]
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    eng, model = res["engine"], res["model"]
    cfg = model.cfg
    kernels = tuple(HYBRID_STEP_LAUNCHES)
    check_counts(counts, phase, kernels)
    check_attn_counts(res, counts, phase, paged=False)
    check_encode_counts(eng, counts, phase)
    if check_k1_weight_counts(res, counts, phase):
        fail(f"{phase}: W8 linears under olive_serve")
    st = eng.stats()
    forwards = st["prefills_run"] + st["decodes_run"]
    step = {"ovp_matmul[fp]": counts["ovp_matmul[fp]"] / forwards,
            "decode_attn": counts["decode_attn"] / st["decodes_run"],
            "ovp_encode": counts["ovp_encode"] / forwards}
    others = {key: counts[key] for key in ("grouped[fp]",
                                           "paged_decode_attn",
                                           "prefill_attn")}
    if step != HYBRID_STEP_LAUNCHES or any(others.values()):
        fail(f"{phase}: a decode step's launches {step}, expected "
             f"{HYBRID_STEP_LAUNCHES}; other kernels {others}")
    done = res["completed"]
    if len(done) != 8 or any(len(r.out_tokens) != 16 for r in done):
        fail(f"{phase}: {len(done)} requests finished with "
             f"{[len(r.out_tokens) for r in done]} tokens, expected 8 x 16")
    print(f"[serve I] {HYBRID_ARCH} ({cfg.n_layers} layers: "
          f"{attn_layers(model)} local_attn, "
          f"{cfg.n_layers - attn_layers(model)} rglru; d_model "
          f"{cfg.d_model}, Hkv {cfg.n_kv_heads} G "
          f"{cfg.n_heads // cfg.n_kv_heads} D {cfg.head_dim}, window "
          f"{cfg.window}, d_rnn {cfg.d_rnn}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}) W4 + KV4, slab: PTQ {res['ptq_s']:.2f}s (layer by "
          f"layer; build and PTQ {load_s:.2f}s), peak device memory "
          f"{peak_gb:.2f} GB, {res['tokens']} tokens in "
          f"{res['seconds']:.3f}s = {res['tok_per_s']:.2f} tok/s, mean "
          f"TTFT {res['mean_ttft_s'] * 1e3:.2f}ms, mean step "
          f"{res['mean_step_s'] * 1e3:.2f}ms; launches "
          + " ".join(f"{key}={counts[key]}" for key in kernels)
          + f" ({st['prefills_run']} exact-length prefills, "
          f"{st['decodes_run']} decode steps; a decode step: "
          + ", ".join(f"{k} {v:g}" for k, v in step.items())
          + f"), dispatch {counts['dispatch']} ({smi})")
    audit_check(eng, phase)
    capture_gate(eng, "I", steps=3)
    sync_check(res, "I")
    prof = profile_decode(res, f"{HYBRID_ARCH}, W4 + KV4, slab", steps=3,
                          max_new=10)
    if prof["k1_ms"] is not None:
        print(f"[serve I] {HYBRID_ARCH} decode step (4 slots): "
              f"{prof['kernels_per_step']:.1f} device kernels, busy "
              f"{prof['busy_ms']:.3f}ms of {prof['prof_ms']:.2f}ms profiled "
              f"wall ({prof['step_ms']:.2f}ms plain), K1 "
              f"{prof['k1_ms']:.3f}ms over {prof['k1_calls']:g} calls, K2 "
              f"{prof['attn_ms']:.3f}ms over {prof['attn_calls']:g}; "
              f"roofline {prof['roofline'].t_bound * 1e3:.3f}ms ({smi})")
    truncated_reference_check(res, dev, label="W4", tag="I",
                              n_layers=HYBRID_CUT)
    k2_ring, ring_launches = ring_check(res, dev, smi)
    gen = torch.Generator(device=dev).manual_seed(22)
    recs = {}
    for i, what in ((0, "rglru"), (2, "local_attn")):
        linears = layer_linears(res["params"]["layers"][i])
        recs[what] = k1_layer_record(dev, gen, linears, 4, "int4",
                                     label=f"k1 {HYBRID_ARCH} {what}")
        print(f"[k1 {HYBRID_ARCH}] one {what} layer's {len(linears)} decode "
              f"launches, rows 4, fp: kernel {recs[what]['ms']:.4f}ms, "
              f"matmul {recs[what]['library_ms']:.4f}ms, bound "
              f"{recs[what]['bound_ms']:.5f}ms, plain "
              f"{recs[what]['plain_ms']:.4f}ms ({smi})")
    kv = [torch.randn((4, 256, cfg.n_kv_heads, cfg.head_dim),
                      generator=gen, device=dev) for _ in range(2)]
    (kd, ks), (vd, vs) = _quant_kv_token(kv[0]), _quant_kv_token(kv[1])
    q = torch.randn((4, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=dev)
    k2_served = k2_record(
        q, {"k_data": kd, "k_scl": ks, "v_data": vd, "v_scl": vs},
        torch.tensor(POS_CASES["mixed"], dtype=torch.int32, device=dev),
        cfg.window, 0, "served, packed")
    print(f"[serve I] phase took {time.perf_counter() - t_phase:.1f}s")
    del res, eng, done
    return {"counts": counts, "peak_gb": peak_gb, "profile": prof,
            "k1": recs, "k2": k2_served, "k2_ring": k2_ring,
            "ring_launches": ring_launches}


# --------------------------------------------------------------------------
# The xLSTM family: xLSTM-350M (mLSTM + sLSTM blocks, recurrent state only)
# --------------------------------------------------------------------------
XLSTM_ARCH = "xlstm-350m"
# one decode step of the served model: K1 5 an mLSTM layer (w_up, wq, wk,
# wv, w_down) x 12 + 6 an sLSTM layer (wz, three gates, wu2, wd2) x 12;
# no KV cache, so no K2, K3, K4 or K7
XLSTM_STEP_LAUNCHES = {"ovp_matmul[fp]": 132}
XLSTM_CUT = 2           # the card-vs-CPU check's depth: one whole period
XLSTM_PROMPT = 300      # tokens: 4 whole 64-token chunks and one of 44
XLSTM_STEPS = 32        # greedy decode steps on the captured step


def xlstm_reference_check(res, dev, smi: str, t: int = XLSTM_PROMPT,
                          steps: int = XLSTM_STEPS):
    """The prefill-to-decode handoff on the card: an `XLSTM_CUT`-layer
    truncation of the served full-width model (mlstm, slstm; the same
    W4 params) in an engine of one slot. One `t`-token prompt through
    its exact-length prefill entry twice (warm-up and capture, then a
    replay: bit for bit; the mLSTM prefill is chunkwise, 4 whole
    64-token chunks and one of 44), spliced into the slot, then `steps`
    greedy decode steps through the captured decode step (the per-token
    recurrences continue the state the prefill left). The logits of the
    last prompt position and of every decode step are held against the
    same model's plain path on the CPU over the same tokens (the card's
    greedy tokens fed, as `_torch_parity.port_forced` does): one
    stateless prefill of the prompt and the fed tokens, read at those
    positions (its chunks fall elsewhere: 5 whole and one of 12).
    Max |diff| <= 1e-3 * max|ref|, greedy tokens equal."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models.model import block_forward, build_model
    from repro_torch.serve.engine import EngineCfg, ServingEngine, \
        _splice_slot
    model, params = res["model"], res["params"]
    cfg = dataclasses.replace(model.cfg, n_layers=XLSTM_CUT)
    p2 = dict(params, layers=params["layers"][:XLSTM_CUT])
    small = build_model(cfg, model.policy)
    prompt = np.random.default_rng(8).integers(0, cfg.vocab, size=t)
    eng = ServingEngine(small, p2, EngineCfg(batch_slots=1,
                                             max_len=t + steps + 8),
                        device=dev)
    first, replay = [[x.clone() for x in eng._prefill(prompt)]
                     for _ in range(2)]
    if not torch.equal(first[0], replay[0]) or \
            eng._prefill_cache[t].graph is None:
        fail(f"xLSTM check: the {t}-token prefill's warm-up and replay "
             f"differ, or it was not captured")
    _splice_slot(eng.caches, eng._row_cache, 0)
    logits, tok, fed = [replay[0]], int(replay[1]), []
    reset_counts()
    for i in range(steps):
        fed.append(tok)
        row, nxt = eng._decode.run(tokens=np.array([[tok]], np.int64),
                                   pos=np.array([t + i], np.int32))
        logits.append(row[0].clone())
        tok = int(nxt[0])
    counts = read_counts()
    want = (5 + 6) * steps
    if eng._decode.graph is None or counts["ovp_matmul[fp]"] != want:
        fail(f"xLSTM check: {counts['ovp_matmul[fp]']} K1 launches over "
             f"{steps} decode steps (expected {want}), captured "
             f"{eng._decode.graph is not None}")
    got = torch.stack(logits).float().cpu()
    cpu_p = _to(p2, "cpu")
    toks = torch.as_tensor(np.concatenate([prompt, fed]))[None]
    t0 = time.perf_counter()
    x = small.embed(cpu_p, toks)
    positions = torch.arange(toks.shape[1])[None]
    for i, layer in enumerate(cpu_p["layers"]):
        x, _ = block_forward(layer, x, positions, cfg, small.policy,
                             site=f"layers/{i}")
    ref = small.head(cpu_p, x[:, t - 1:])[0].float()
    cpu_s = time.perf_counter() - t0
    v = cfg.vocab
    finite = bool(torch.isfinite(got).all())
    err = float((got[:, :v] - ref[:, :v]).abs().max())
    tol = 1e-3 * float(ref[:, :v].abs().max())
    same = bool(torch.equal(got[:, :v].argmax(-1), ref[:, :v].argmax(-1)))
    print(f"[ref J] {cfg.name} cut to {XLSTM_CUT} layers (mlstm, slstm), "
          f"W4: a {t}-token prompt through its captured exact-length "
          f"prefill entry (warm-up and replay bit-identical), then {steps} "
          f"greedy decode steps on the captured decode step "
          f"({counts['ovp_matmul[fp]']} K1 launches); card vs the CPU's "
          f"plain path (one prefill of the {t + steps} tokens, "
          f"{cpu_s:.1f}s): logits {'finite' if finite else 'NOT finite'}, "
          f"shape {tuple(got.shape)}, max |diff| {err:.3e} over "
          f"{steps + 1} positions (tol {tol:.3e} = 1e-3 * max|ref|), "
          f"greedy tokens {'equal' if same else 'differ'} ({smi})")
    if not finite or got.shape != (steps + 1, cfg.padded_vocab) or \
            not np.isfinite(err) or err > tol or not same:
        fail("xLSTM check: card and CPU disagree")
    del eng


def serve_phase_j(dev, smi: str):
    """The xLSTM family at full published width and depth through the
    launcher's entry point: xLSTM-350M (`--arch xlstm-350m --quant
    olive_serve`: 24 layers, 12 x (mlstm, slstm), d_model 1024, 4
    heads (mLSTM heads of 512, sLSTM heads of 256), sLSTM MLP 1364,
    untied 50304 vocab), slab, the launcher's workload, recurrent state
    only. Counters reset just before and read just after: no fallback;
    K1 `fp` once per quantized linear (5 an mLSTM layer, 6 an sLSTM
    layer) per forward call, none for the fp32 head; a decode step's
    launches exactly `XLSTM_STEP_LAUNCHES` and no K2, K3, K4, K6 or K7
    launch; 8 requests x 16 tokens. Then the audit (one prefill entry
    per distinct prompt length), `capture_gate` (every mLSTM and sLSTM
    state leaf among the cache bytes), `sync_check`, the decode-step
    profile beside the step's roofline, `xlstm_reference_check`, and
    K1 at one mLSTM layer's 5 and one sLSTM layer's 6 decode launches
    (the served weights, rows 4, the sLSTM MLP's ragged N 1364 and K
    1364 included). Prints PTQ seconds, peak device memory, tok/s, mean
    TTFT and mean step beside the card. Returns the counts, the peak,
    the profile and the K1 records."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.roofline.step_stats import tree_bytes
    from repro_torch.serve.engine import _leaves
    t_phase = time.perf_counter()
    phase = f"serve phase J ({XLSTM_ARCH}, slab)"
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    res = serve.run(["--arch", XLSTM_ARCH, "--quant", "olive_serve"]
                    + SERVE_ARGS, device=dev)
    load_s = time.perf_counter() - t0 - res["seconds"]
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    eng, model = res["engine"], res["model"]
    cfg = model.cfg
    check_counts(counts, phase, tuple(XLSTM_STEP_LAUNCHES))
    check_attn_counts(res, counts, phase, paged=False)
    check_encode_counts(eng, counts, phase)
    if check_k1_weight_counts(res, counts, phase):
        fail(f"{phase}: W8 linears under olive_serve")
    st = eng.stats()
    forwards = st["prefills_run"] + st["decodes_run"]
    step = {"ovp_matmul[fp]": counts["ovp_matmul[fp]"] / forwards}
    others = {key: counts[key] for key in (
        "ovp_matmul[quantize]", "ovp_matmul[static]", "grouped[fp]",
        "decode_attn", "paged_decode_attn", "prefill_attn", "ovp_encode")}
    if step != XLSTM_STEP_LAUNCHES or any(others.values()):
        fail(f"{phase}: a decode step's launches {step}, expected "
             f"{XLSTM_STEP_LAUNCHES}; other kernels {others}")
    done = res["completed"]
    if len(done) != 8 or any(len(r.out_tokens) != 16 for r in done):
        fail(f"{phase}: {len(done)} requests finished with "
             f"{[len(r.out_tokens) for r in done]} tokens, expected 8 x 16")
    # every cache leaf is a recurrent state: mLSTM c, n, m, conv and
    # sLSTM c, n, m, h, a layer each
    leaves = _leaves(eng.caches)
    sites = [site for layer in eng.caches["layers"] for site in layer]
    if len(leaves) != 4 * cfg.n_layers or \
            sorted(set(sites)) != ["mlstm", "slstm"]:
        fail(f"{phase}: {len(leaves)} cache leaves over sites "
             f"{sorted(set(sites))}, expected 4 a layer, mlstm and slstm")
    state_bytes = tree_bytes(eng.caches)
    print(f"[serve J] {XLSTM_ARCH} ({cfg.n_layers} layers: "
          f"{cfg.n_layers // 2} mlstm, {cfg.n_layers // 2} slstm; d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab}) W4, "
          f"recurrent state only, slab: PTQ {res['ptq_s']:.2f}s (layer by "
          f"layer; build and PTQ {load_s:.2f}s), peak device memory "
          f"{peak_gb:.2f} GB, {res['tokens']} tokens in "
          f"{res['seconds']:.3f}s = {res['tok_per_s']:.2f} tok/s, mean "
          f"TTFT {res['mean_ttft_s'] * 1e3:.2f}ms, mean step "
          f"{res['mean_step_s'] * 1e3:.2f}ms; launches ovp_matmul[fp]="
          f"{counts['ovp_matmul[fp]']} ({st['prefills_run']} exact-length "
          f"prefills, {st['decodes_run']} decode steps; a decode step: "
          f"{step['ovp_matmul[fp]']:g}), other kernels {others}, dispatch "
          f"{counts['dispatch']}; {len(leaves)} state leaves, "
          f"{state_bytes / 1e6:.1f} MB for {eng.cfg.batch_slots} slots "
          f"({smi})")
    audit_check(eng, phase)
    capture_gate(eng, "J", steps=3)
    sync_check(res, "J")
    prof = profile_decode(res, f"{XLSTM_ARCH}, W4, slab", steps=3,
                          max_new=10)
    if prof["k1_ms"] is not None:
        print(f"[serve J] {XLSTM_ARCH} decode step (4 slots): "
              f"{prof['kernels_per_step']:.1f} device kernels, busy "
              f"{prof['busy_ms']:.3f}ms of {prof['prof_ms']:.2f}ms profiled "
              f"wall ({prof['step_ms']:.2f}ms plain), K1 "
              f"{prof['k1_ms']:.3f}ms over {prof['k1_calls']:g} calls; "
              f"roofline {prof['roofline'].t_bound * 1e3:.3f}ms ({smi})")
    xlstm_reference_check(res, dev, smi)
    gen = torch.Generator(device=dev).manual_seed(24)
    recs = {}
    for i, what in ((0, "mlstm"), (1, "slstm")):
        linears = layer_linears(res["params"]["layers"][i])
        recs[what] = k1_layer_record(dev, gen, linears, 4, "int4",
                                     label=f"k1 {XLSTM_ARCH} {what}")
        print(f"[k1 {XLSTM_ARCH}] one {what} layer's {len(linears)} decode "
              f"launches, rows 4, fp: kernel {recs[what]['ms']:.4f}ms, "
              f"matmul {recs[what]['library_ms']:.4f}ms, bound "
              f"{recs[what]['bound_ms']:.5f}ms, plain "
              f"{recs[what]['plain_ms']:.4f}ms ({smi})")
    print(f"[serve J] phase took {time.perf_counter() - t_phase:.1f}s")
    del res, eng, done
    return {"counts": counts, "peak_gb": peak_gb, "profile": prof,
            "k1": recs, "step_bound_ms": prof["roofline"].t_bound * 1e3}


# --------------------------------------------------------------------------
# The last two families: the encoder-decoder and the VLM frontend
# --------------------------------------------------------------------------
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_ROWS = 4         # batch rows of phase K
ENCDEC_FRAMES = 400     # 160-d encoder frames a row
ENCDEC_XKV = 512        # cross-cache slots: the tail past src_len is masked
ENCDEC_PROMPT = 8       # decoder prompt tokens
ENCDEC_STEPS = 32       # greedy decode steps
ENCDEC_MAX_LEN = 64     # self-cache slots: prompt, steps and profiled steps
# the prefill: K1 on the frontend projection, 6 an encoder layer (q, k,
# v, o, wi, wd) and 10 a decoder layer (self q, k, v, o; cross q, k, v,
# o; wi, wd), K7 on the self caches' K and V; the encoder alone: its K1
# share of the prefill; a decode step: K1 8 a decoder layer (self q, k,
# v, o; cross q, o; wi, wd), K2 twice a layer (over the KV4 self cache
# and the fp32 cross cache, told apart by the cache-dtype counters), K7
# twice a layer
ENCDEC_PREFILL_LAUNCHES = {"ovp_matmul[fp]": 1 + 24 * 6 + 24 * 10,
                           "ovp_encode": 48}
ENCDEC_ENCODE_LAUNCHES = {"ovp_matmul[fp]": 1 + 24 * 6}
ENCDEC_STEP_LAUNCHES = {"ovp_matmul[fp]": 24 * 8, "decode_attn": 48,
                        "ovp_encode": 48}
ENCDEC_STEP_CACHE_LAUNCHES = {"decode_attn<int4>": 24,
                              "decode_attn<float32>": 24}
VLM_ARCH = "internvl2-1b"
VLM_PROMPT = 8          # tokens after the 256 patch embeddings
VLM_STEPS = 32
# a decode step of the served model: K1 7 a layer, K2 (K3 paged) and K7
# twice a layer; the prefill with patch embeddings adds the projection
VLM_STEP_LAUNCHES = {"ovp_matmul[fp]": 168, "decode_attn": 24,
                     "ovp_encode": 48}
VLM_PREFILL_LAUNCHES = {"ovp_matmul[fp]": 169, "ovp_encode": 48}
CUT_LAYERS = 2          # the card-vs-CPU checks' depth (encoder and decoder)


def launched(counts):
    """The nonzero launch counters by kernel and mode (the weight-dtype
    counters and the dispatch stats left out)."""
    return {key: n for key, n in counts.items()
            if key not in ("dispatch", "act_scale", "shard")
            and "<" not in key
            and n}


def greedy_forward(model, params, batch, caches, steps: int, pos0: int,
                   fed=None):
    """`Model.forward` as a user calls it: a prefill of `batch` into
    `caches`, then `steps` greedy decode steps at positions pos0 + i (the
    tokens `fed` (B, steps) instead of the greedy ones when given). The
    launch counters are reset just before the prefill and read just after
    it, then reset again and read after the decode steps. Returns (the
    last-position logits of every forward call (B, steps + 1, V), the
    tokens fed (B, steps), the prefill's counts, the decode steps' counts,
    the prefill's wall ms, a decode step's wall ms)."""
    import torch
    dev = batch["tokens"].device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    b = batch["tokens"].shape[0]
    sync()
    reset_counts()
    t0 = time.perf_counter()
    logits, caches = model.forward(params, batch, mode="prefill",
                                   caches=caches)
    sync()
    pre_ms = (time.perf_counter() - t0) * 1e3
    c_pre = read_counts()
    reset_counts()
    out, toks = [logits[:, -1]], []
    t0 = time.perf_counter()
    for i in range(steps):
        tok = out[-1].argmax(-1)[:, None] if fed is None \
            else fed[:, i:i + 1]
        toks.append(tok)
        logits, caches = model.forward(
            params, {"tokens": tok, "pos": torch.full(
                (b,), pos0 + i, dtype=torch.int32, device=dev)},
            mode="decode", caches=caches)
        out.append(logits[:, 0])
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    c_dec = read_counts()
    return (torch.stack(out, 1).float(), torch.cat(toks, 1), c_pre, c_dec,
            pre_ms, step_ms)


def check_launches(counts, want, phase: str) -> None:
    """No fallback, and exactly the launches `want` (kernel[mode] -> n),
    no other kernel."""
    check_counts(counts, phase, tuple(want))
    if launched(counts) != want:
        fail(f"{phase}: launches {launched(counts)}, expected exactly "
             f"{want}")


def encdec_reference_check(model, params, batch, dev, smi: str,
                           steps: int = ENCDEC_STEPS):
    """A `CUT_LAYERS`-deep cut of the served full-width encoder-decoder
    (the first 2 encoder and 2 decoder layers, the same W4 params) over
    fp32 self caches: the prefill of phase K's frames and prompt into
    `ENCDEC_XKV`-slot cross caches, then `steps` greedy decode steps, on
    the card; the same model on the CPU through the plain versions over
    the same tokens (the card's greedy tokens fed): logits within 1e-3 *
    max|ref|, greedy tokens equal. Then the padded-vs-tight check: the
    card's run again over cross caches of exactly `ENCDEC_FRAMES` slots,
    the same tokens fed: its logits within 1e-4 * max|padded| of the
    padded run's (the 112 unwritten tail slots get no softmax mass; the
    key split of K2 may differ, so bit identity is not required)."""
    import dataclasses

    import torch
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(model.cfg, n_layers=CUT_LAYERS,
                              n_enc_layers=CUT_LAYERS)
    small = build_model(cfg, model.policy.replace_all(kv_bits=0))
    p2 = dict(params, layers=params["layers"][:CUT_LAYERS],
              enc_blocks=params["enc_blocks"][:CUT_LAYERS])
    rows = batch["tokens"].shape[0]

    def run(device, tree, enc_len, fed=None):
        b = {key: val.to(device) for key, val in batch.items()}
        caches = small.init_caches(rows, ENCDEC_MAX_LEN, enc_len=enc_len,
                                   device=device)
        return greedy_forward(small, tree, b, caches, steps,
                              ENCDEC_PROMPT,
                              None if fed is None else fed.to(device))

    got, fed, *_ = run(dev, p2, ENCDEC_XKV)
    tight = run(dev, p2, ENCDEC_FRAMES, fed)[0]
    t0 = time.perf_counter()
    ref = run("cpu", _to(p2, "cpu"), ENCDEC_XKV, fed.cpu())[0]
    cpu_s = time.perf_counter() - t0
    got, tight = got.cpu(), tight.cpu()
    v = cfg.vocab
    finite = bool(torch.isfinite(got).all())
    err = float((got[..., :v] - ref[..., :v]).abs().max())
    tol = 1e-3 * float(ref[..., :v].abs().max())
    same = bool(torch.equal(got[..., :v].argmax(-1), ref[..., :v].argmax(-1)))
    pad = float((got - tight).abs().max())
    pad_tol = 1e-4 * float(got[..., :v].abs().max())
    print(f"[ref K] {cfg.name} cut to {CUT_LAYERS} encoder + {CUT_LAYERS} "
          f"decoder layers, W4, fp32 self caches: {ENCDEC_FRAMES} frames "
          f"and a {ENCDEC_PROMPT}-token prompt x {rows} rows into "
          f"{ENCDEC_XKV}-slot cross caches, {steps} greedy decode steps; "
          f"card vs the CPU's plain versions ({cpu_s:.1f}s): logits "
          f"{'finite' if finite else 'NOT finite'}, shape "
          f"{tuple(got.shape)}, max |diff| {err:.3e} (tol {tol:.3e} = "
          f"1e-3 * max|ref|), greedy tokens {'equal' if same else 'differ'};"
          f" padded ({ENCDEC_XKV}) vs tight ({ENCDEC_FRAMES}) cross caches "
          f"on the card: max |diff| {pad:.3e} (tol {pad_tol:.3e} = 1e-4 * "
          f"max|padded|{', bit-identical' if pad == 0 else ''}) ({smi})")
    if not finite or got.shape != (rows, steps + 1, cfg.padded_vocab) or \
            not err <= tol or not same:
        fail("phase K: card and CPU disagree")
    if not pad <= pad_tol:
        fail("phase K: the padded cross cache's tail took softmax mass")
    return {"err": err, "tol": tol, "pad": pad, "pad_tol": pad_tol}


def serve_phase_k(dev, smi: str):
    """The encoder-decoder at full published width and depth:
    SeamlessM4T-large-v2 (24 encoder + 24 decoder layers, d_model 1024,
    MHA 16 x 64, GELU MLPs of 8192, untied 256206 vocab, 160-d audio
    frames), olive_serve as the launcher rewrites it (W4 weights, KV4
    self caches, fp32 cross caches, activations unquantized), random
    weights from seed 0 drawn and quantized layer by layer (the encoder
    as one stack) through `Model.init`. The launcher refuses the arch
    (its engine feeds no frames), so the path is `Model.forward`, as in
    the reference: `ENCDEC_ROWS` rows of `ENCDEC_FRAMES` random frames
    and an `ENCDEC_PROMPT`-token prompt, prefilled into cross caches of
    `ENCDEC_XKV` slots, then `ENCDEC_STEPS` greedy decode steps.
    Counters reset just before and read just after the prefill and the
    decode steps: exactly `ENCDEC_PREFILL_LAUNCHES` and
    `ENCDEC_STEPS` x `ENCDEC_STEP_LAUNCHES`, no other kernel, no
    fallback; every cross cache's src_len 400 and its tail unwritten;
    finite logits. Then the encoder alone timed, a decode step profiled
    beside its roofline, K1 at one decoder
    layer's 8 decode launches (rows 4) and at the frontend and one
    encoder layer's 6 launches at the prefill's 1600 rows, K2 over a
    served cross cache at pos = src_len - 1, and
    `encdec_reference_check`. Returns the counts and records."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import quantize_params, tree_paths
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    from repro_torch.roofline import step_stats
    t_phase = time.perf_counter()
    phase = f"phase K ({ENCDEC_ARCH})"
    try:
        serve.run(["--arch", ENCDEC_ARCH, "--quant", "olive_serve"]
                  + SERVE_ARGS, device=dev)
        fail(f"{phase}: the launcher served an encoder-decoder")
    except ValueError as err:
        refusal = str(err)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(ENCDEC_ARCH)
    policy = get_policy("olive_serve").replace_all(compute_dtype="float32",
                                                   abits=0)
    model = build_model(cfg, policy)
    ptq_s = 0.0

    def quantize(tree, prefix):
        nonlocal ptq_s
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tree = quantize_params(tree, policy, prefix=prefix)
        torch.cuda.synchronize(dev)
        ptq_s += time.perf_counter() - t0
        return tree

    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev, quantize=quantize)
    load_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    rows = ENCDEC_ROWS
    batch = {"frames": torch.as_tensor(rng.standard_normal(
                 (rows, ENCDEC_FRAMES, cfg.frontend_dim)),
                 dtype=torch.float32, device=dev),
             "tokens": torch.as_tensor(rng.integers(
                 0, cfg.vocab, size=(rows, ENCDEC_PROMPT)), device=dev)}
    caches = model.init_caches(rows, ENCDEC_MAX_LEN, enc_len=ENCDEC_XKV,
                               device=dev)
    logits, _, c_pre, c_dec, pre_ms, step_ms = greedy_forward(
        model, params, batch, caches, ENCDEC_STEPS, ENCDEC_PROMPT)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check_launches(c_pre, ENCDEC_PREFILL_LAUNCHES, f"{phase} prefill")
    check_launches(c_dec, {key: n * ENCDEC_STEPS for key, n in
                           ENCDEC_STEP_LAUNCHES.items()},
                   f"{phase} decode steps")
    by_cache = {key: c_dec[key] for key in ENCDEC_STEP_CACHE_LAUNCHES}
    if by_cache != {key: n * ENCDEC_STEPS for key, n in
                    ENCDEC_STEP_CACHE_LAUNCHES.items()}:
        fail(f"{phase} decode steps: K2 launches by cache dtype "
             f"{by_cache}, expected {ENCDEC_STEP_CACHE_LAUNCHES} a step")
    for i, layer in enumerate(caches["layers"]):
        xkv = layer["xkv"]
        if xkv["src_len"].tolist() != [ENCDEC_FRAMES] * rows or \
                bool(xkv["k"][:, ENCDEC_FRAMES:].any()):
            fail(f"{phase}: layer {i}'s cross cache src_len "
                 f"{xkv['src_len'].tolist()} or its tail was written")
    if logits.shape != (rows, ENCDEC_STEPS + 1, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{phase}: logits {tuple(logits.shape)} or not finite")
    n_q = sum(hasattr(w, "scale") for _, w in tree_paths(params))
    torch.cuda.synchronize(dev)
    reset_counts()
    t0 = time.perf_counter()
    model.encode(params, batch["frames"])
    torch.cuda.synchronize(dev)
    enc_ms = (time.perf_counter() - t0) * 1e3
    c_enc = read_counts()
    check_launches(c_enc, ENCDEC_ENCODE_LAUNCHES, f"{phase} encoder")
    print(f"[serve K] {ENCDEC_ARCH} ({cfg.n_enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}) W4 + KV4 self caches + fp32 cross caches, through "
          f"Model.forward (the launcher refuses it: {refusal[:60]}...): "
          f"PTQ {ptq_s:.2f}s of {n_q} linears (layer by layer, the encoder "
          f"as one stack; build and PTQ {load_s:.2f}s), peak device memory "
          f"{peak_gb:.2f} GB; {rows} rows x {ENCDEC_FRAMES} frames + "
          f"{ENCDEC_PROMPT} tokens: prefill {pre_ms:.1f}ms (the encoder "
          f"alone {enc_ms:.1f}ms), {ENCDEC_STEPS} eager decode steps "
          f"{step_ms:.2f}ms a step; launches: prefill {launched(c_pre)}, "
          f"the encoder alone {launched(c_enc)}, decode steps "
          f"{launched(c_dec)} (K2 {by_cache}) ({smi})")
    pos = [ENCDEC_PROMPT + ENCDEC_STEPS]

    def one_step():
        tok = torch.zeros((rows, 1), dtype=torch.int64, device=dev)
        model.forward(params, {"tokens": tok, "pos": torch.full(
            (rows,), pos[0], dtype=torch.int32, device=dev)},
            mode="decode", caches=caches)
        pos[0] += 1

    p0 = pos[0] + 1             # profile_steps warms up with one step
    prof = profile_steps(one_step)
    stats = step_stats.mean([step_stats.decode_step_stats(
        model, params, caches, [p0 + i] * rows, src_len=ENCDEC_FRAMES)
        for i in range(3)])
    roof = step_roofline(f"{ENCDEC_ARCH} decode step ({rows} rows)", stats,
                         prof["busy_ms"] if prof["kernels"] else None, smi)
    bound = roof.t_bound * 1e3
    if prof["kernels"] is not None:
        print(f"[serve K] {ENCDEC_ARCH} decode step ({rows} rows, eager "
              f"Model.forward): {prof['kernels']:.1f} device kernels, busy "
              f"{prof['busy_ms']:.3f}ms of {prof['wall_ms']:.2f}ms profiled "
              f"wall, K1 {prof['k1_ms']:.3f}ms over {prof['k1_calls']:g} "
              f"calls, K2 {prof['attn_ms']:.3f}ms; roofline {bound:.3f}ms "
              f"({smi})")
    gen = torch.Generator(device=dev).manual_seed(25)
    dec0, enc0 = params["layers"][0], params["enc_blocks"][0]
    recs = {"decoder": k1_layer_record(
        dev, gen, [dec0["attn"][n] for n in ("wq", "wk", "wv", "wo")]
        + [dec0["xattn"][n] for n in ("wq", "wo")]
        + [dec0["mlp"][n] for n in ("wi", "wd")], 4, "int4",
        label=f"k1 {ENCDEC_ARCH} decoder")}
    recs["encoder"] = k1_layer_record(
        dev, gen, [params["frontend_proj"]["w_in"]]
        + [enc0["attn"][n] for n in ("wq", "wk", "wv", "wo")]
        + [enc0["mlp"][n] for n in ("wi", "wd")], rows * ENCDEC_FRAMES,
        "int4", label=f"k1 {ENCDEC_ARCH} encoder prefill")
    for what, n in (("decoder", 8), ("encoder", 7)):
        r = recs[what]
        print(f"[k1 {ENCDEC_ARCH}] " + (
            "one decoder layer's 8 decode launches, rows 4" if n == 8 else
            f"the frontend and one encoder layer's 6 launches, rows "
            f"{rows * ENCDEC_FRAMES}") + f", fp: kernel {r['ms']:.4f}ms, "
            f"matmul {r['library_ms']:.4f}ms, bound {r['bound_ms']:.5f}ms "
            f"({r['bound_by']}), plain {r['plain_ms']:.4f}ms ({smi})")
    xkv = caches["layers"][0]["xkv"]
    q = torch.randn((rows, 1, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=dev)
    recs["cross"] = k2_record(q, xkv, xkv["src_len"] - 1, 0, 0,
                              f"{ENCDEC_ARCH} cross")
    recs["check"] = encdec_reference_check(model, params, batch, dev, smi)
    print(f"[serve K] phase took {time.perf_counter() - t_phase:.1f}s")
    del params, caches, model
    return {"prefill": c_pre, "encode": c_enc, "decode": c_dec,
            "peak_gb": peak_gb,
            "profile": prof, "records": recs, "bound_ms": bound}


def vlm_forward_check(res, dev, smi: str, steps: int = VLM_STEPS):
    """The VLM frontend on the served full-width model: `Model.forward`
    with 256 random 1024-d patch embeddings in front of an
    `VLM_PROMPT`-token prompt on 4 rows (positions 0..263), then `steps`
    greedy decode steps at pos = 264 + i. Counters reset just before and
    read just after: the prefill exactly `VLM_PREFILL_LAUNCHES`, each
    decode step `VLM_STEP_LAUNCHES`; finite logits. Then the
    `CUT_LAYERS`-deep cut over fp32 KV, card against the CPU's plain
    versions on the same patches and tokens (the card's greedy tokens
    fed): logits within 1e-3 * max|ref|, greedy tokens equal. Returns
    the counts and the check."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models.model import build_model
    model, params = res["model"], res["params"]
    cfg = model.cfg
    rng = np.random.default_rng(1)
    rows, p = 4, cfg.n_frontend_tokens
    batch = {"patch_embeds": torch.as_tensor(rng.standard_normal(
                 (rows, p, cfg.frontend_dim)), dtype=torch.float32,
                 device=dev),
             "tokens": torch.as_tensor(rng.integers(
                 0, cfg.vocab, size=(rows, VLM_PROMPT)), device=dev)}
    max_len = p + VLM_PROMPT + steps
    logits, _, c_pre, c_dec, pre_ms, step_ms = greedy_forward(
        model, params, batch, model.init_caches(rows, max_len, device=dev),
        steps, p + VLM_PROMPT)
    phase = f"phase L ({VLM_ARCH}, Model.forward with patch embeddings)"
    check_launches(c_pre, VLM_PREFILL_LAUNCHES, f"{phase} prefill")
    check_launches(c_dec, {key: n * steps for key, n in
                           VLM_STEP_LAUNCHES.items()},
                   f"{phase} decode steps")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{phase}: logits not finite")
    small = build_model(dataclasses.replace(cfg, n_layers=CUT_LAYERS),
                        model.policy.replace_all(kv_bits=0))
    p2 = dict(params, layers=params["layers"][:CUT_LAYERS])

    def run(device, tree, fed=None):
        b = {key: val.to(device) for key, val in batch.items()}
        return greedy_forward(
            small, tree, b, small.init_caches(rows, max_len, device=device),
            steps, p + VLM_PROMPT, None if fed is None else fed.to(device))

    got, fed, *_ = run(dev, p2)
    t0 = time.perf_counter()
    ref = run("cpu", _to(p2, "cpu"), fed.cpu())[0]
    cpu_s = time.perf_counter() - t0
    got = got.cpu()
    v = cfg.vocab
    err = float((got[..., :v] - ref[..., :v]).abs().max())
    tol = 1e-3 * float(ref[..., :v].abs().max())
    same = bool(torch.equal(got[..., :v].argmax(-1), ref[..., :v].argmax(-1)))
    print(f"[ref L] {VLM_ARCH} W4 + KV4, {p} patch embeddings + "
          f"{VLM_PROMPT} tokens x {rows} rows: prefill {pre_ms:.1f}ms, "
          f"{steps} eager decode steps at pos {p + VLM_PROMPT}+i "
          f"{step_ms:.2f}ms a step; launches prefill {launched(c_pre)}, "
          f"decode steps {launched(c_dec)}; cut to {CUT_LAYERS} layers over "
          f"fp32 KV, card vs the CPU's plain versions ({cpu_s:.1f}s): max "
          f"|diff| {err:.3e} (tol {tol:.3e} = 1e-3 * max|ref|) over "
          f"{steps + 1} positions, greedy tokens "
          f"{'equal' if same else 'differ'} ({smi})")
    if not err <= tol or not same:
        fail(f"{phase}: card and CPU disagree")
    return {"prefill": c_pre, "decode": c_dec, "err": err, "tol": tol}


def serve_phase_l(dev, smi: str):
    """The VLM at full published width and depth through the launcher's
    entry point: InternVL2-1B (`--arch internvl2-1b --quant olive_serve`:
    24 layers, d_model 896, 14 heads over 2 KV heads of 64, SwiGLU 4864,
    untied 151655 vocab), on tokens as the reference launcher serves it,
    slab and then paged (`--paged 16 --prefill-chunk 16`), the card freed
    between runs, the launcher's workload. Counters reset just before and
    read just after each run: no fallback; K1 once per quantized linear
    (7 a layer) per forward call, K2 (K3 and K4 paged) once a layer a
    step or chunk, K7 twice a layer a cache write, no other kernel: a
    decode step's launches exactly `VLM_STEP_LAUNCHES` (K3 for K2 when
    paged); 8 requests x 16 tokens, every page returned. Then the audit,
    `capture_gate`, `sync_check`, the decode-step profile beside the
    step's roofline (`repro_torch.roofline`), the 2-layer card-vs-CPU check
    (`truncated_reference_check`), and on the slab run's model
    `vlm_forward_check` and K1 at one layer's 7 decode launches; last
    K2, K3 and K4 at Hkv 2 / G 7 / D 64 against their plain versions.
    Returns each run's counts and the records."""
    import torch
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    runs = {}
    for paged in (False, True):
        label = "paged 16, chunk 16" if paged else "slab"
        phase = f"serve phase L ({VLM_ARCH}, {label})"
        attn = "paged_decode_attn" if paged else "decode_attn"
        kernels = ("ovp_matmul[fp]", attn, "ovp_encode") \
            + (("prefill_attn",) if paged else ())
        extra = ["--paged", "16", "--prefill-chunk", "16"] if paged else []
        free_device_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = serve.run(["--arch", VLM_ARCH, "--quant", "olive_serve"]
                        + SERVE_ARGS + extra, device=dev)
        load_s = time.perf_counter() - t0 - res["seconds"]
        counts = read_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        eng, cfg = res["engine"], res["model"].cfg
        check_counts(counts, phase, kernels)
        check_attn_counts(res, counts, phase, paged)
        check_encode_counts(eng, counts, phase)
        if check_k1_weight_counts(res, counts, phase):
            fail(f"{phase}: W8 linears under olive_serve")
        if set(launched(counts)) != set(kernels):
            fail(f"{phase}: kernels launched {launched(counts)}, expected "
                 f"only {kernels}")
        st = eng.stats()
        forwards = st["prefills_run"] + st["prefill_chunks_run"] \
            + st["decodes_run"]
        if counts["ovp_matmul[fp]"] != \
                VLM_STEP_LAUNCHES["ovp_matmul[fp]"] * forwards:
            fail(f"{phase}: {counts['ovp_matmul[fp]']} K1 launches over "
                 f"{forwards} forward calls")
        done = res["completed"]
        if len(done) != 8 or any(len(r.out_tokens) != 16 for r in done):
            fail(f"{phase}: {len(done)} requests finished with "
                 f"{[len(r.out_tokens) for r in done]} tokens, expected "
                 f"8 x 16")
        if paged:
            pool = st["page_pool"]
            if pool["used_pages"] != 0 or pool["allocs"] != pool["frees"]:
                fail(f"{phase}: pages not all returned: {pool}")
        print(f"[serve L] {VLM_ARCH} ({cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, Hkv {cfg.n_kv_heads} G "
              f"{cfg.n_heads // cfg.n_kv_heads} D {cfg.head_dim}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab}) W4 + KV4, {label}: PTQ "
              f"{res['ptq_s']:.2f}s (layer by layer; build and PTQ "
              f"{load_s:.2f}s), peak device memory {peak_gb:.2f} GB, "
              f"{res['tokens']} tokens in {res['seconds']:.3f}s = "
              f"{res['tok_per_s']:.2f} tok/s, mean TTFT "
              f"{res['mean_ttft_s'] * 1e3:.2f}ms, mean step "
              f"{res['mean_step_s'] * 1e3:.2f}ms; launches "
              + " ".join(f"{key}={counts[key]}" for key in kernels)
              + f" ({st['prefills_run']} prefills, "
              f"{st['prefill_chunks_run']} chunks, {st['decodes_run']} "
              f"decode steps; a decode step: K1 168, "
              f"{'K3' if paged else 'K2'} 24, K7 48), dispatch "
              f"{counts['dispatch']} ({smi})")
        audit_check(eng, phase)
        capture_gate(eng, phase, steps=3)
        sync_check(res, f"L {label}")
        prof = profile_decode(res, f"{VLM_ARCH}, W4 + KV4, {label}",
                              steps=3, max_new=10)
        if prof["k1_ms"] is not None:
            print(f"[serve L] {VLM_ARCH} {label} decode step (4 slots): "
                  f"{prof['kernels_per_step']:.1f} device kernels, busy "
                  f"{prof['busy_ms']:.3f}ms of {prof['prof_ms']:.2f}ms "
                  f"profiled wall ({prof['step_ms']:.2f}ms plain), K1 "
                  f"{prof['k1_ms']:.3f}ms, {'K3' if paged else 'K2'} "
                  f"{prof['attn_ms']:.3f}ms; roofline "
                  f"{prof['roofline'].t_bound * 1e3:.3f}ms ({smi})")
        truncated_reference_check(res, dev, label="W4", paged=paged,
                                  tag="L")
        run = {"counts": counts, "stats": st, "profile": prof,
               "peak_gb": peak_gb,
               "bound_ms": prof["roofline"].t_bound * 1e3}
        if not paged:
            run["forward"] = vlm_forward_check(res, dev, smi)
            gen = torch.Generator(device=dev).manual_seed(26)
            run["k1"] = k1_layer_record(
                dev, gen, layer_linears(res["params"]["layers"][0]), 4,
                "int4", label=f"k1 {VLM_ARCH}")
            r = run["k1"]
            print(f"[k1 {VLM_ARCH}] one layer's 7 decode launches, rows 4, "
                  f"fp: kernel {r['ms']:.4f}ms, matmul {r['library_ms']:.4f}"
                  f"ms, bound {r['bound_ms']:.5f}ms, plain "
                  f"{r['plain_ms']:.4f}ms ({smi})")
        runs[paged] = run
        del res, eng, done
    free_device_memory()
    attn = {"k2": k2_phase(dev, 2, 7, 64, all_pos=False),
            "k3": k3_phase(dev, 2, 7, 64, all_pos=False),
            "k4": k4_phase(dev, 2, 7, 64, cs=(16,))}
    print(f"[attn L] worst errors at Hkv 2, G 7, D 64 (tol atol 1e-5): "
          + ", ".join(f"{k.upper()} {v[1]:.2e}" for k, v in attn.items()))
    print(f"[serve L] phase took {time.perf_counter() - t_phase:.1f}s")
    return {"runs": runs, "attn": attn}


# --------------------------------------------------------------------------
# Phase M: training (the training launcher at full width, resume,
# card against CPU, and the trained weights served)
# --------------------------------------------------------------------------
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_STEPS = 8        # cut from 20, then 12, for time (phases O, P)
TRAIN_CKPT_EVERY = 4   # the resumed run restores this step, then runs the rest
# the launcher reports a held-out perplexity from 20 steps on, or with
# --eval-every (the trainer's in-loop evaluation at the last step)
TRAIN_ARGS = ["--quant", "olive_w4a4", "--batch", "8", "--seq", "512",
              "--steps", str(TRAIN_STEPS), "--ckpt-every",
              str(TRAIN_CKPT_EVERY), "--eval-every", str(TRAIN_STEPS),
              "--seed", "0"]
TRAIN_CKPT = os.path.join(ROOT, "build", "ckpt_m")
TRAIN_RESUME_RTOL = 1e-3    # the resumed steps vs the uninterrupted run
TRAIN_CUT = 2               # the card-vs-CPU step's depth
TRAIN_CUT_BATCH = (2, 64)   # its batch: rows, tokens
# Card vs CPU, the gradients of one fp32 QAT step: (preset, loss rtol,
# grad-norm rtol, worst gradient leaf's |difference| over its max). The
# fake-quant's per-tensor 3-sigma scale is a reduction whose last bits
# differ between the two, and a code that flips moves by a whole step:
# the card's own gradients with every scale one ulp up (`TRAIN_ULP`,
# printed beside) show how far that alone moves each number. W4A4's
# 4-bit activations flip outlier codes, which moves whole gradient rows,
# so its leaves are only bounded.
TRAIN_CUT_CHECKS = (("olive_w4", 1e-4, 1e-3, 2e-2),
                    ("olive_w4a4", 1e-2, 1e-2, 1.0))
TRAIN_ULP = 2.0 ** -23      # the scales' relative change of the ulp step


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _grad_norm(grads) -> float:
    return sum(float((g.double() ** 2).sum()) for g in grads.values()) ** 0.5


def _ulp_step(model, params, batch, base) -> dict:
    """The card's gradients with every fake-quant scale `TRAIN_ULP`
    relative up (`sigma_init_scale` scaled), against `base`, the same
    step unperturbed: how far one ulp of a scale moves the loss, the
    gradient norm and the worst gradient leaf."""
    from repro_torch.core import qlinear
    from repro_torch.core.qlinear import tree_paths
    from repro_torch.train.train_step import value_and_grad
    real = qlinear.sigma_init_scale
    qlinear.sigma_init_scale = \
        lambda x, nd: real(x, nd) * (1.0 + TRAIN_ULP)
    try:
        loss, _, grads = value_and_grad(model, params, batch)
    finally:
        qlinear.sigma_init_scale = real
    grads = dict(tree_paths(grads))
    worst = max(float((grads[p] - g).abs().max() / g.abs().max())
                for p, g in base["grads"].items() if g.abs().max() > 0)
    return {"loss_rel": abs(float(loss) - base["loss"]) / abs(base["loss"]),
            "gnorm_rel": abs(_grad_norm(grads) - base["gnorm"])
            / base["gnorm"], "grad_rel": worst}


def train_card_vs_cpu(dev, smi: str) -> dict:
    """The gradients of one QAT train step of a `TRAIN_CUT`-layer cut of
    the config at full width on the card and on the CPU, fp32 compute,
    the same drawn weights and batch, under each preset of
    `TRAIN_CUT_CHECKS`: loss, gradient norm and every gradient leaf (the
    AdamW update on them is held to the reference on the CPU)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import tree_paths
    from repro_torch.data.loader import LoaderCfg, SyntheticLoader
    from repro_torch.data.synthetic import CorpusCfg
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    from repro_torch.train.train_step import value_and_grad
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_CUT)
    rows, seq = TRAIN_CUT_BATCH
    batch = SyntheticLoader(LoaderCfg(
        global_batch=rows, seq_len=seq,
        corpus=CorpusCfg(vocab=cfg.vocab))).global_batch_at(0)
    params = {str(dev): build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0), device=dev)}
    params["cpu"] = tree_unflatten(params[str(dev)], [
        p.cpu() for p in tree_leaves(params[str(dev)])])
    out = {}
    for quant, loss_tol, gnorm_tol, grad_tol in TRAIN_CUT_CHECKS:
        model = build_model(cfg, dataclasses.replace(
            get_policy(quant), qat=True, compute_dtype="float32"))
        got = {}
        for where in ("cpu", str(dev)):
            on = {k: v.to(where) for k, v in batch.items()}
            t0 = time.perf_counter()
            loss, _, grads = value_and_grad(model, params[where], on)
            grads = dict(tree_paths(grads))
            got[where] = {"loss": float(loss), "grads": grads,
                          "gnorm": _grad_norm(grads),
                          "s": time.perf_counter() - t0}
        ref, card = got["cpu"], got[str(dev)]
        ulp = _ulp_step(model, params[str(dev)],
                        {k: v.to(dev) for k, v in batch.items()}, card)
        loss_err = abs(card["loss"] - ref["loss"]) / abs(ref["loss"])
        gnorm_err = abs(card["gnorm"] - ref["gnorm"]) / ref["gnorm"]
        grad_err = max(float((card["grads"][p].cpu() - g).abs().max())
                       / float(g.abs().max())
                       for p, g in ref["grads"].items() if g.abs().max() > 0)
        print(f"[train M] card vs CPU, {TRAIN_CUT}-layer cut at full width, "
              f"the gradients of one fp32 QAT {quant} step of {rows} x {seq} "
              f"tokens: loss {card['loss']:.6f} vs {ref['loss']:.6f} (rel "
              f"{loss_err:.2e}, tol {loss_tol}), grad norm "
              f"{card['gnorm']:.5f} vs {ref['gnorm']:.5f} (rel "
              f"{gnorm_err:.2e}, tol {gnorm_tol}), worst gradient leaf "
              f"{grad_err:.2e} of its max (tol {grad_tol}); {card['s']:.3f}s "
              f"card, {ref['s']:.3f}s CPU; the card against itself with "
              f"every scale one ulp up: loss {ulp['loss_rel']:.2e}, grad "
              f"norm {ulp['gnorm_rel']:.2e}, worst leaf "
              f"{ulp['grad_rel']:.2e} [{smi}]")
        if not (loss_err <= loss_tol and gnorm_err <= gnorm_tol
                and grad_err <= grad_tol):
            fail(f"phase M: the card's {quant} gradients disagree with the "
                 f"CPU's")
        out[quant] = {"loss_rel": loss_err, "gnorm_rel": gnorm_err,
                      "grad_rel": grad_err, "ulp": ulp}
    return out


def train_serve_check(dev, params, smi: str,
                      label: str = "phase M serve"):
    """The trained fp32 tree quantized under olive_serve (activations
    off, the launcher's rewrite) and served: 4 requests through the slab
    engine on captured steps, the launches gated exactly."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.policy import OLIVE_SERVE
    from repro_torch.core.qlinear import quantize_params
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import EngineCfg, ServingEngine
    policy = OLIVE_SERVE.replace_all(compute_dtype="float32", abits=0)
    model = build_model(get_config(TRAIN_ARCH), policy)
    t0 = time.perf_counter()
    qparams = quantize_params(params, policy)
    ptq_s = time.perf_counter() - t0
    eng = ServingEngine(model, qparams, EngineCfg(batch_slots=4, max_len=256),
                        device=dev)
    rng = np.random.default_rng(3)
    for _ in range(4):
        eng.submit(rng.integers(0, model.cfg.vocab,
                                size=int(rng.integers(4, 32))),
                   max_new_tokens=16)
    reset_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    dt = time.perf_counter() - t0
    counts = read_counts()
    res = {"engine": eng, "model": model}
    check_counts(counts, label)
    check_attn_counts(res, counts, label, paged=False)
    check_encode_counts(eng, counts, label)
    st = eng.stats()
    forwards = st["decodes_run"] + st["prefills_run"]
    if counts["ovp_matmul[fp]"] != 7 * model.cfg.n_layers * forwards:
        fail(f"{label}: K1 launches {counts['ovp_matmul[fp]']}, "
             f"expected 7 x {model.cfg.n_layers} x {forwards} forward calls")
    if len(done) != 4 or any(len(r.out_tokens) != 16 for r in done):
        fail(f"{label}: expected 4 requests x 16 tokens")
    audit_check(eng, label)
    toks = sum(len(r.out_tokens) for r in done)
    print(f"[{label}] served the trained weights (olive_serve W4 + KV4, PTQ "
          f"{ptq_s:.2f}s): {toks} tokens in {dt:.3f}s, launches a decode "
          f"step K1 {7 * model.cfg.n_layers}, K2 {model.cfg.n_layers}, K7 "
          f"{2 * model.cfg.n_layers} (totals ovp_matmul[fp]="
          f"{counts['ovp_matmul[fp]']} decode_attn={counts['decode_attn']} "
          f"ovp_encode={counts['ovp_encode']} over {st['decodes_run']} "
          f"decode steps and {st['prefills_run']} prefills) [{smi}]")
    return counts


def train_phase_m(dev, smi: str) -> dict:
    """Phase M: the training slice through its launcher (see the module
    docstring, item 19)."""
    import shutil
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.roofline import hw, step_stats
    t_phase = time.perf_counter()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, *TRAIN_ARGS, "--ckpt-dir", TRAIN_CKPT]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = train.run(argv, device=dev)
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    hist, trainer = res["history"], res["trainer"]
    losses, times = hist["loss"], hist["step_time"]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        fail(f"phase M: losses {losses}: not {TRAIN_STEPS} finite losses "
             f"ending below the first")
    cfg = get_config(TRAIN_ARCH)
    rows, seq = (int(TRAIN_ARGS[TRAIN_ARGS.index(flag) + 1])
                 for flag in ("--batch", "--seq"))
    step_ms = statistics.median(times[1:]) * 1e3
    unused = trainer.state.params["lm_head"]["w_out"] \
        if cfg.tie_embeddings else None     # a tied head reads the table
    n_params = sum(p.numel() for p in tree_leaves(trainer.state.params)
                   if p is not unused)
    n_layers = sum(p.numel() for p in tree_leaves(
        trainer.state.params["layers"]))
    tokens = rows * seq
    flops = 6 * n_params * tokens + 2 * n_layers * tokens   # + remat
    print(f"[train M] {TRAIN_ARCH} QAT olive_w4a4, bf16 compute, remat, "
          f"{rows} x {seq} tokens a step: losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, held-out ppl {res['ppl']:.3f}; first step "
          f"{times[0] * 1e3:.1f} ms, median step after it {step_ms:.1f} ms "
          f"= {tokens / step_ms * 1e3:.0f} tokens/s; peak device memory "
          f"{peak_gb:.2f} GB; run {run_s:.1f}s [{smi}]")
    print(f"[train M] model FLOPs a step: 6 x {n_params} params x {tokens} "
          f"tokens + 2 x {n_layers} layer params x {tokens} (remat's "
          f"recompute) = {flops:.3e} (attention's T^2 terms left out); at "
          f"the median step {flops / (step_ms / 1e3) / 1e12:.1f} TFLOP/s = "
          f"{flops / (step_ms / 1e3) / hw.PEAK_FLOPS_BF16 * 100:.1f} % of "
          f"the H100 SXM data sheet's dense bf16 peak "
          f"({hw.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s) [{smi}]")
    # resume: restore the first checkpoint and run the steps after it again
    mid, last = TRAIN_CKPT_EVERY, TRAIN_STEPS
    shutil.rmtree(os.path.join(TRAIN_CKPT, f"step_{last:08d}"))
    res2 = train.run(argv, device=dev)
    save_s = trainer.ckpt_seconds["save"]
    restore_s = res2["trainer"].ckpt_seconds["restore"]
    n_bytes = _dir_bytes(os.path.join(TRAIN_CKPT, f"step_{last:08d}"))
    print(f"[train M] checkpoint of step {last} (fp32 params, bf16 moments): "
          f"{n_bytes} bytes on disk, its save {save_s:.2f}s (from the start "
          f"to the file's publication), "
          f"the resumed run's restore of step {mid} {restore_s:.2f}s "
          f"[{smi}]")
    again = res2["history"]["loss"]
    if res2["history"]["step"] != list(range(mid + 1, last + 1)):
        fail(f"phase M: the resumed run ran steps {res2['history']['step']}")
    worst = max(abs(a - b) / abs(b) for a, b in zip(again, losses[mid:]))
    print(f"[train M] resumed at step {mid}: steps {mid + 1}-{last} losses "
          f"within "
          f"{worst:.2e} relative of the uninterrupted run's (tol "
          f"{TRAIN_RESUME_RTOL}) [{smi}]")
    if worst > TRAIN_RESUME_RTOL:
        fail(f"phase M: resumed losses {again} vs {losses[mid:]}")
    # one more step of the resumed trainer, profiled
    t2 = res2["trainer"]
    batch = t2._batch(t2.step)

    def train_step():
        t2.state, metrics = t2.step_fn(t2.state, batch)
        float(metrics["loss"])

    prof = profile_steps(train_step, steps=1, warm=False)
    print(f"[train M] one profiled train step: wall {prof['wall_ms']:.1f} ms "
          f"under the profiler, device busy {prof['busy_ms']:.1f} ms, "
          f"{prof['kernels']} device kernels; costliest: "
          + "; ".join(f"{ms:.1f} ms x{n} {name[:60]}"
                      for ms, n, name in prof["top"][:5]) + f" [{smi}]")
    opt = t2.state.opt
    roof = step_roofline(
        f"{TRAIN_ARCH} train step ({rows} x {seq}, remat)",
        step_stats.train_step_stats(t2.model, t2.state.params, rows, seq,
                                    opt_state=(opt.mu, opt.nu)),
        prof["busy_ms"] if prof["kernels"] else None, smi)
    params = res["state"].params
    del res2, res, trainer, t2, batch
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    free_device_memory()
    cut = train_card_vs_cpu(dev, smi)
    free_device_memory()
    counts = train_serve_check(dev, params, smi)
    took = time.perf_counter() - t_phase
    print(f"[train M] phase took {took:.1f}s")
    return {"counts": counts, "step_ms": step_ms, "peak_gb": peak_gb,
            "profile": prof,
            "roofline": roof,
            "cut": cut, "save_s": save_s, "restore_s": restore_s,
            "bytes": n_bytes, "flops": flops, "took": took}


# --------------------------------------------------------------------------
# Phase N: the tooling (repro_torch.analysis, repro_torch.roofline)
# --------------------------------------------------------------------------
# each analysis case's counter, launches a call, TPU kernel replaced, and
# source: the reference's eight kernel cases and the KV write
N_CASES = {
    "fused_matmul_w4a16": ("ovp_matmul[fp]", 1, "ovp_matmul.py:367",
                           "ovp_matmul.cu"),
    "fused_matmul_w8a16": ("ovp_matmul[fp]", 1, "ovp_matmul.py:367",
                           "ovp_matmul.cu"),
    "grouped_matmul_w4a16": ("grouped[fp]", 1, "ovp_matmul.py:436",
                             "ovp_matmul.cu"),
    "grouped_matmul_w8a16": ("grouped[fp]", 1, "ovp_matmul.py:436",
                             "ovp_matmul.cu"),
    "ovp_encode": ("ovp_encode", 1, "ovp_encode.py:59", "ovp_encode.cu"),
    "decode_attn_slab_packed": ("decode_attn", 1, "decode_attn.py:358",
                                "decode_attn.cu"),
    "decode_attn_paged_packed": ("paged_decode_attn", 1,
                                 "decode_attn.py:404", "decode_attn.cu"),
    "prefill_attn_paged_packed": ("prefill_attn", 1, "prefill_attn.py:170",
                                  "prefill_attn.cu"),
    "kv_write_packed": ("ovp_encode", 2, "ovp_encode.py:59",
                        "ovp_encode.cu"),
}
# a child process whose NaN KV scale must fail the sanitizer's named
# check in front of K7 (blocking launches tie the device assert to it)
SANITIZE_CHILD = r"""
import sys
import torch
from repro_torch import backends
from repro_torch.core.policy import OLIVE_SERVE
x = torch.randn((64, 64), device="cuda")
scale = torch.ones((64,), device="cuda")
scale[3] = float("nan")
try:
    backends.encode_kv(x, scale, policy=OLIVE_SERVE)
    torch.cuda.synchronize()
except AssertionError as err:
    print(f"child failed on: {err}")
    sys.exit(3)
print("child: no check failed")
"""
SANITIZE_CHECK = "encode_kv: the KV scale must be positive and finite"


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_clone(v) for v in tree)
    return tree.clone() if hasattr(tree, "clone") else tree


def _dense_weight(wd, sw, w_dtype: str):
    """Codes (…, K/2 | K, N) and scales (…, N) -> the dense fp32 weight."""
    import torch
    from repro_torch.kernels import ovp_matmul as mm
    even, odd = mm.weight_planes(wd, w_dtype)
    w = torch.stack([even, odd], dim=-2)
    return w.reshape(*w.shape[:-3], -1, w.shape[-1]) * sw[..., None, :]


def _case_work(name: str, args, out):
    """(bytes, FLOPs, library call or None) of one analysis case: each
    input read once and each output written once; the library call is
    one PyTorch call computing the same function."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn as da
    from repro_torch.roofline.step_stats import tree_bytes
    if "matmul" in name:
        a, wd, sw = args
        w_dtype = "int8" if "w8" in name else "int4"
        dense = _dense_weight(wd, sw, w_dtype)
        k, n = dense.shape[-2:]
        rows = a.numel() // k           # each row against one (K, N)
        lib = (lambda: torch.matmul(a, dense)) if dense.ndim == 2 else \
            (lambda: torch.einsum("beck,ekn->becn", a, dense))
        return tree_bytes(args) + tree_bytes(out), 2.0 * rows * k * n, lib
    if name == "ovp_encode":
        return tree_bytes(args) + tree_bytes(out), 0.0, None
    if name.startswith("decode_attn"):
        q, cache, pos = args
        live = int(pos.sum()) + len(pos)        # slots 0..pos of each row
        slab = da.gather_paged_cache(cache) if "block_table" in cache \
            else cache
        per_slot = sum(slab[k][0, 0].numel() * slab[k].element_size()
                       for k in ("k_data", "v_data", "k_scl", "v_scl"))
        kd = da.dequant_kv(slab["k_data"], slab["k_scl"])
        vd = da.dequant_kv(slab["v_data"], slab["v_scl"])
        h, d = q.shape[2], q.shape[3]
        table = cache["block_table"].numel() * 4 if "block_table" in cache \
            else 0
        return (q.numel() * 4 + live * per_slot + pos.numel() * 4 + table
                + tree_bytes(out), 4.0 * h * d * live,
                _attn_library(q, kd, vd, pos, h // kd.shape[2]))
    if name.startswith("prefill_attn"):
        q, cache, positions = args
        c, h, d = q.shape[1:]
        s = cache["stage_k"].shape[1]
        ps = cache["k_data"].shape[1]
        per_slot = sum(cache[k][0, 0].numel() * cache[k].element_size()
                       for k in ("k_data", "v_data", "k_scl", "v_scl"))
        off = int(positions[0, 0])
        keys = c * off + c * (c + 1) // 2
        kh = cache["stage_k"].transpose(1, 2)
        vh = cache["stage_v"].transpose(1, 2)
        qpos = torch.arange(off, off + c, device=q.device)
        mask = qpos[:, None] >= torch.arange(s, device=q.device)[None]
        lib = (lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kh, vh, attn_mask=mask,
            enable_gqa=h != kh.shape[1]))
        return (q.numel() * 4 + 2 * cache["stage_k"].numel() * 4
                + (s // ps) * ps * per_slot + tree_bytes(out[0]),
                4.0 * h * d * keys, lib)
    cache, k, v, pos = args                  # the KV write
    per_slot = sum(cache[key][0, 0].numel() * cache[key].element_size()
                   for key in ("k_data", "v_data", "k_scl", "v_scl"))
    return k.numel() * 4 + v.numel() * 4 + len(pos) * per_slot, 0.0, None


def _untouched(name: str, args):
    """Index of the pool pages (K4) or cache slots (the KV write) the call
    must not write, as a (leaf key -> bool mask over dim 0 or (0, 1))."""
    import torch
    cache = next(a for a in args if isinstance(a, dict))
    leaf = cache["k_data"]
    if name.startswith("prefill_attn"):
        pages = cache["stage_k"].shape[1] // leaf.shape[1]
        keep = torch.ones(leaf.shape[0], dtype=torch.bool)
        keep[cache["block_table"][0, :pages].long().cpu()] = False
        return keep
    pos = args[3].long().cpu()
    keep = torch.ones(leaf.shape[:2], dtype=torch.bool)
    keep[torch.arange(len(pos)), pos] = False
    return keep


def analysis_case_phase(dev, smi: str):
    """Each analysis case (`repro_torch.analysis.kernels.repo_cases`: the
    reference's eight kernel cases and the KV write) once on the card at
    its shape, held to its plain version on the card (same inputs), its
    launches counted, timed beside the plain version, a library call and
    its bound; each plan's shared memory beside the card's opt-in limit;
    K4's and the KV write's pools written in place (pointers unchanged,
    untouched pages and slots bit-identical)."""
    import torch
    from repro_torch.analysis import kernels as ak
    props = torch.cuda.get_device_properties(dev)
    optin = getattr(props, "shared_memory_per_block_optin", None)
    recs = {}
    for case in ak.repo_cases():
        counter, want, replaces, source = N_CASES[case.name]
        fn, args = case.build(dev)
        ref_args = _tree_clone(args)
        cache = next((a for a in args if isinstance(a, dict)), None)
        before = _tree_clone(cache) if case.pool_leaves else None
        ptrs = {k: cache[k].data_ptr() for k in case.pool_leaves}
        reset_counts()
        got = fn(*args)
        torch.cuda.synchronize(dev)
        launches = read_counts()[counter]
        ref = case.plain(*ref_args)
        torch.cuda.synchronize(dev)
        if launches != want:
            fail(f"phase N {case.name}: {launches} {counter} launches, "
                 f"expected {want}")
        notes = []
        if case.pool_leaves:
            back = got if isinstance(got, dict) else got[-1]
            ref_cache = ref if isinstance(ref, dict) else ref[-1]
            keep = _untouched(case.name, args).to(dev)
            for key in case.pool_leaves:
                if back[key].data_ptr() != ptrs[key]:
                    fail(f"phase N {case.name}: {key} came back in another "
                         f"buffer")
                old, new = before[key], back[key]
                if not torch.equal(new[keep], old[keep]):
                    fail(f"phase N {case.name}: {key}'s untouched "
                         f"{'pages' if keep.ndim == 1 else 'slots'} changed")
            written = ~keep
            code_bytes = sum(int((back[k][written] != ref_cache[k][written])
                                 .sum()) for k in ("k_data", "v_data"))
            total = sum(back[k][written].numel() for k in ("k_data", "v_data"))
            scl = max(float(((back[k] - ref_cache[k]).abs()
                             / ref_cache[k].abs().clamp_min(1e-30)).max())
                      for k in ("k_scl", "v_scl"))
            # K4 sums its row statistics in another order than the plain
            # version (0.01 % of code bytes, at least one byte, as in
            # k4_phase); K7 is exact
            code_tol = max(1, int(1e-4 * total)) \
                if case.name.startswith("prefill") else 0
            if code_bytes > code_tol or scl > 1e-6:
                fail(f"phase N {case.name}: {code_bytes} of {total} written "
                     f"code bytes differ (tol {code_tol}), scales by "
                     f"{scl:.2e} relative (tol 1e-6)")
            notes.append(f"pools in place, untouched "
                         f"{int(keep.sum())} "
                         f"{'pages' if keep.ndim == 1 else 'slots'} "
                         f"bit-identical, {code_bytes} of {total} written "
                         f"code bytes differing, scales {scl:.1e} relative")
        out, out_ref = (got[0], ref[0]) if isinstance(got, tuple) else \
            (got, ref)
        if isinstance(out, dict):
            err = 0.0
        elif out.dtype == torch.uint8:
            err = float((out != out_ref).sum())     # bytes differing
            if err:
                fail(f"phase N {case.name}: {int(err)} bytes differ from "
                     f"the plain version")
        else:
            err = float((out - out_ref).abs().max())
            scale = float(out_ref.abs().max())
            rtol, atol = (1e-5, 1e-5 * scale) if "matmul" in case.name \
                else (0.0, 1e-5)
            if not within(out, out_ref, rtol, atol):
                fail(f"phase N {case.name}: max abs err {err:.3e} over "
                     f"rtol {rtol}, atol {atol:.2e}")
        n_bytes, flops, lib = _case_work(case.name, args, got)
        ms, _ = time_ms(lambda: fn(*args))
        plain_ms, _ = time_ms(lambda: case.plain(*ref_args), 10, graph=False)
        lib_ms = time_ms(lib)[0] if lib is not None else None
        b_ms, b_by = bound_ms(n_bytes, flops)
        smem = [ak.describe(x).smem for x in case.launches()]
        recs[case.name] = dict(
            counter=counter, launches=launches, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
            bound_by=b_by, replaces=f"src/repro/kernels/{replaces}",
            source=source, smem=smem)
        print(f"[analysis N] {case.name}: {counter} x{launches}, err "
              f"{err:.2e}, kernel {ms:.4f}ms, plain {plain_ms:.4f}ms "
              f"(eager), library "
              + (f"{lib_ms:.4f}ms" if lib_ms is not None else "none")
              + f", bound {b_ms:.3e}ms ({b_by}); shared memory a block "
              f"{smem} of the card's opt-in {optin}"
              + ("; " + "; ".join(notes) if notes else "") + f" ({smi})")
        if optin is not None and max(smem) > optin:
            fail(f"phase N {case.name}: a plan's {max(smem)} shared bytes "
                 f"exceed the card's opt-in {optin}")
    sweep = {}
    for name, launch in ak.served_launches():
        kern = launch.kernel
        if launch.smem > sweep.get(kern, (0, ""))[0]:
            sweep[kern] = (launch.smem, name)
    for kern, (most, where) in sorted(sweep.items()):
        print(f"[analysis N] served sweep: {kern}'s largest plan "
              f"{most} shared bytes a block ({where}) of the card's opt-in "
              f"{optin} ({smi})")
        if optin is not None and most > optin:
            fail(f"phase N: {where} needs {most} shared bytes, over the "
                 f"card's opt-in {optin}")
    return recs


def tooling_phase_n(dev, smi: str):
    """Phase N: the port's tooling on the card (see the module docstring,
    item 20). Returns the case records and the sanitize smoke's result."""
    import torch
    from repro_torch import analysis
    from repro_torch.analysis import sanitize
    from repro_torch.analysis.__main__ import sanitize_smoke
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    findings = analysis.run_all()
    print(f"[analysis N] run_all(): {len(findings)} finding(s) in "
          f"{time.perf_counter() - t0:.1f}s" + "".join(
              f"\n[analysis N]   {f}" for f in findings))
    if findings:
        fail(f"phase N: {len(findings)} analysis finding(s)")
    recs = analysis_case_phase(dev, smi)
    t0 = time.perf_counter()
    try:
        smoke = sanitize_smoke("cuda")
    finally:
        os.environ.pop("REPRO_SANITIZE", None)
    checks = "; ".join(f"{msg[:48]}... x{n}"
                       for msg, n in smoke["checks"].items())
    print(f"[analysis N] sanitize smoke ({smoke['arch']}, olive_serve W4 + "
          f"KV4, slab, captured steps, 4 prompts x 8 tokens, "
          f"REPRO_SANITIZE=1, logits checked): audit {smoke['audit']}, "
          f"launches {smoke['launches']}, {smoke['tokens']} tokens, checks "
          f"placed {checks}; {time.perf_counter() - t0:.1f}s ({smi})")
    if sanitize.enabled():
        fail("phase N: REPRO_SANITIZE left on after the smoke")
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_SANITIZE="1", CUDA_LAUNCH_BLOCKING="1")
    child = subprocess.run([sys.executable, "-c", SANITIZE_CHILD], env=env,
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=180)
    said = (child.stdout + child.stderr).strip().splitlines()
    print(f"[analysis N] child with a NaN KV scale: exit {child.returncode}"
          f" in {time.perf_counter() - t0:.1f}s, "
          f"{said[-1] if said else 'no output'!r}")
    if child.returncode != 3 or SANITIZE_CHECK not in child.stdout:
        fail(f"phase N: the child did not fail on the named check "
             f"({SANITIZE_CHECK!r}): exit {child.returncode}, "
             f"{child.stdout[-400:]} {child.stderr[-800:]}")
    alive = float(torch.ones(4, device=dev).sum())
    if alive != 4.0:
        fail("phase N: the parent's CUDA context is not usable")
    print(f"[analysis N] the parent goes on: its CUDA context answers "
          f"({alive:g}); phase took {time.perf_counter() - t_phase:.1f}s")
    return {"cases": recs, "smoke": smoke}


# --------------------------------------------------------------------------
# Phase O: serving on a mesh (two ranks sharing the card over gloo)
# --------------------------------------------------------------------------
MESH_E_LAYERS = 4       # phase O's Qwen3-30B-A3B depth, cut from the 48
MESH_STEPS = 4          # decode steps timed alone in each rank and run
MESH_LOGIT_TOL = 1e-4   # x max|ref|: the first prefill's logits, 2 ranks
#                         against one (fp32 reassociation of the
#                         row-parallel sums, and of K1's split-K at half K)
MESH_RANK_TIMEOUT = 600     # seconds a rank may take for all its runs
MESH_VLM_RANKS = 4      # phase O's InternVL2-1B run: --mesh 1,4
MESH_VLM_LAYERS = 4     # its depth, cut from the published 24 for time


class _Rank:
    """A stand-in for rank `rank` of a (data 1, model `tp`) mesh: what
    `backends.sharded.local_shard` reads (axis names and sizes, this
    rank's place)."""

    def __init__(self, rank: int, tp: int = 2):
        self.rank, self.tp = rank, tp
        self.axis_names = ("data", "model")
        self.shape = {"data": 1, "model": tp}

    def size(self, axis):
        return self.tp if axis == "model" else 1

    def coord(self, axis):
        return self.rank if axis == "model" else 0


def _tree_bytes(tree):
    """(bytes of quantized leaves, bytes of raw tensors) of a param tree."""
    from repro_torch.core.ovp import QuantizedTensor
    q = raw = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, QuantizedTensor):
            q += node.nbytes()
        elif hasattr(node, "groups"):            # MixedExpertQuant
            stack.extend(node.groups)
        else:
            raw += node.numel() * node.element_size()
    return q, raw


def _kv_bytes(eng) -> int:
    """Bytes of every KV leaf of the engine's caches (slab or pool; the
    block table aside)."""
    return sum(leaf.numel() * leaf.element_size()
               for layer in eng.caches["layers"]
               for key, leaf in layer["kv"].items() if key != "block_table")


def _mesh_runs(world: int = 2):
    """(label, argv, (arch, depth)) of phase O over `world` ranks: on
    two, Qwen1.5-0.5B at full width and depth, slab and paged, and
    Qwen3-30B-A3B cut to `MESH_E_LAYERS` layers, slab and paged; on
    four, InternVL2-1B cut to `MESH_VLM_LAYERS` layers, slab; the
    launcher's workload."""
    paged = ["--paged", "16", "--prefill-chunk", "16"]
    base = ["--quant", "olive_serve"] + SERVE_ARGS
    if world == MESH_VLM_RANKS:
        return [("vlm slab", base, (VLM_ARCH, MESH_VLM_LAYERS))]
    return [("qwen slab", base, (ARCH, 24)),
            ("qwen paged", base + paged, (ARCH, 24)),
            ("moe slab", base, (MOE_ARCH, MESH_E_LAYERS)),
            ("moe paged", base + paged, (MOE_ARCH, MESH_E_LAYERS))]


def _serve_record(res, dev, steps: int = MESH_STEPS):
    """What phase O compares of one served run (either side): tokens,
    launches and dispatch, engine stats, pool and weight bytes, the first
    prompt's prefill logits (slab), and `steps` decode steps run alone:
    their launches and collectives a step and wall ms a step."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    eng = res["engine"]
    rec = {"outputs": res["outputs"],
           "counts": read_counts(), "stats": eng.stats(),
           "pool": eng.device_pool_stats(), "kv_bytes": _kv_bytes(eng),
           "weights": _tree_bytes(res["params"]),
           "seconds": res["seconds"], "tok_per_s": res["tok_per_s"],
           "collectives": mesh_lib.collective_stats()}
    if not eng.paged:
        prompt = launcher_prompts(res["model"].cfg.vocab)[0]
        logits, _ = eng._prefill(prompt)
        rec["logits"] = logits.float().cpu().numpy()
    tokens = np.zeros((eng.cfg.batch_slots, 1), np.int64)
    eng._decode.run(tokens=tokens, pos=eng.pos)        # warm
    torch.cuda.synchronize(dev)
    if dist.is_initialized():
        dist.barrier()
    reset_counts()
    mesh_lib.reset_collective_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng._decode.run(tokens=tokens, pos=eng.pos)
    torch.cuda.synchronize(dev)
    rec["step_ms"] = (time.perf_counter() - t0) * 1e3 / steps
    step = read_counts()
    rec["step_counts"] = {k: v / steps for k, v in step.items()
                          if isinstance(v, int) and v}
    rec["step_counts"].update({k: v / steps for k, v in
                               step["shard"].items()})
    rec["step_collectives"] = {k: v / steps for k, v in
                               mesh_lib.collective_stats().items()}
    rec["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return rec


def _mesh_facts(res) -> dict:
    """The table's bytes and each KV site's slot part (None: whole
    slots) of a served run."""
    from repro_torch.backends import sharded
    table = res["params"]["embed"]["table"]
    return {"table_bytes": table.numel() * table.element_size(),
            "slots": [sharded.seq_part(layer["kv"])
                      for layer in res["engine"].caches["layers"]]}


def _mesh_rank(rank: int, init: str, out_dir: str, world: int = 2) -> None:
    """One rank of phase O: join the gloo group of `world` ranks through
    the file `init` (all on card 0), serve every run of `_mesh_runs`
    through the launcher's `run()` with `--backend cuda_sharded --mesh
    1,<world>`, and write the records to `out_dir/rank<rank>.pkl`. Any
    error exits non-zero."""
    import pickle
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh_lib.init_distributed(
        "cuda", rank=rank, world_size=world, local_rank=rank,
        local_world_size=world, init_method=f"file://{init}",
        verbose=rank == 0)
    recs = {}
    for label, argv, (arch, depth) in _mesh_runs(world):
        free_device_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        mesh_lib.reset_collective_stats()
        with cut_arch(arch, depth) as name:
            res = serve.run(["--arch", name] + argv + [
                "--backend", "cuda_sharded", "--mesh", f"1,{world}"],
                device="cuda")
        recs[label] = _serve_record(res, dev)
        recs[label]["audit"] = res["engine"].trace_audit()
        recs[label].update(_mesh_facts(res))
        del res
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(recs, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn_mesh_ranks(world: int = 2):
    """Run `_mesh_rank` in `world` processes; their records by rank. A
    rank that fails, exits non-zero or outlives `MESH_RANK_TIMEOUT`
    fails the phase."""
    import pickle
    import shutil
    import torch.multiprocessing as mp
    out_dir = os.path.join(ROOT, "build", f"mesh_o{world}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    init = os.path.join(out_dir, "rendezvous")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(r, init, out_dir, world))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_RANK_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        fail(f"phase O: ranks exited {codes} (0 expected; negative: killed "
             f"after {MESH_RANK_TIMEOUT}s or by a signal)")
    recs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            recs.append(pickle.load(f))
    return recs


def _single_cut_runs(dev, world: int = 2):
    """The single-rank (`cuda`, captured) runs of phase O's Qwen3-30B-A3B
    cut, slab and paged (`world` 4: its InternVL2-1B cut), as
    `_serve_record`s."""
    import torch
    from repro_torch.launch import serve
    out = {}
    for label, argv, (arch, depth) in _mesh_runs(world):
        if arch == ARCH:
            continue
        free_device_memory()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        with cut_arch(arch, depth) as name:
            res = serve.run(["--arch", name] + argv, device=dev)
        out[label] = _serve_record(res, dev)
        out[label].update(_mesh_facts(res))
        del res
    return out


def mesh_reference(res_a, res_c):
    """Phase A's and C's single-rank facts phase O compares against: the
    launcher's tokens (its `outputs`, taken when the run returned; the
    engines serve more requests in later checks), the first prompt's
    prefill logits, the quantized weight and KV bytes."""
    eng = res_a["engine"]
    prompt = launcher_prompts(res_a["model"].cfg.vocab)[0]
    logits, _ = eng._prefill(prompt)
    return {
        "qwen slab": {"outputs": res_a["outputs"],
                      "logits": logits.float().cpu().numpy(),
                      "weights": _tree_bytes(res_a["params"]),
                      "kv_bytes": _kv_bytes(eng)},
        "qwen paged": {"outputs": res_c["outputs"],
                       "weights": _tree_bytes(res_c["params"]),
                       "kv_bytes": _kv_bytes(res_c["engine"]),
                       "pool": res_c["engine"].device_pool_stats()}}


def _check_mesh_run(label, ranks, single, layers: int):
    """Phase O's gates on one run: both ranks' tokens equal each other's
    and the single rank's; no fallback and every call on cuda_sharded;
    launches per forward call and per decode step; KV bytes half the
    single rank's, quantized weight bytes about half; logits (slab)
    within `MESH_LOGIT_TOL`. Returns a summary line's facts."""
    import numpy as np
    paged = "paged" in label
    want = single["outputs"]
    for r, rec in enumerate(ranks):
        if rec["outputs"] != want:
            differ = sum(int(x != y) for uid, toks in want.items()
                         for x, y in zip(toks, rec["outputs"].get(uid, [])))
            fail(f"phase O {label}: rank {r}'s tokens differ from the "
                 f"single-rank run's ({differ} of "
                 f"{sum(map(len, want.values()))})")
        counts = rec["counts"]
        bad = [k for k in counts["dispatch"] if "->fallback" in k
               or not k.startswith("cuda_sharded")]
        if bad:
            fail(f"phase O {label}: rank {r} dispatch {counts['dispatch']}")
        st = rec["stats"]
        fwd = st["prefills_run"] + st["prefill_chunks_run"] \
            + st["decodes_run"]
        moe = label.startswith("moe")
        k1_per_layer = 4 if moe else 7
        wants = {"ovp_matmul[fp]": k1_per_layer * layers * fwd,
                 "ovp_encode": 2 * layers * (st["decodes_run"]
                                             + st["prefills_run"]),
                 "decode_attn": 0 if paged else layers * st["decodes_run"],
                 "paged_decode_attn":
                     layers * st["decodes_run"] if paged else 0,
                 "prefill_attn": layers * st["prefill_chunks_run"],
                 "grouped[fp]": 3 * layers * fwd if moe else 0}
        # K1 by layout: wq wk wv (wg wu) column-parallel, wo (wd) row
        k1_row = 1 if moe else 2
        shard = {"ovp_matmul[fp]@col": (k1_per_layer - k1_row) * layers,
                 "ovp_matmul[fp]@row": k1_row * layers}
        if moe:
            shard["grouped[fp]@expert"] = 3 * layers
        wants.update({k: v * fwd for k, v in shard.items()})
        got = {k: counts["shard"].get(k, counts.get(k)) for k in wants}
        if got != wants:
            fail(f"phase O {label}: rank {r} launches {got}, expected "
                 f"{wants} ({fwd} forward calls)")
        step = rec["step_counts"]
        want_step = {"ovp_matmul[fp]": k1_per_layer * layers,
                     "paged_decode_attn" if paged else "decode_attn": layers,
                     "ovp_encode": 2 * layers, **shard}
        if moe:
            want_step["grouped[fp]"] = 3 * layers
        if any(step.get(k) != v for k, v in want_step.items()):
            fail(f"phase O {label}: rank {r}'s decode step launched {step},"
                 f" expected {want_step}")
        if rec["kv_bytes"] * 2 != single["kv_bytes"]:
            fail(f"phase O {label}: rank {r}'s KV bytes {rec['kv_bytes']}, "
                 f"half of the single rank's {single['kv_bytes']} expected")
        q, q1 = rec["weights"][0], single["weights"][0]
        if not 0.5 < q / q1 < 0.55:
            fail(f"phase O {label}: rank {r}'s quantized weight bytes "
                 f"{q} are {q / q1:.3f} of one rank's {q1}")
        if paged:
            pool = rec["pool"]
            if pool["n_devices"] != 2 or 2 * pool["pool_bytes_per_device"] \
                    != single["pool"]["pool_bytes_total"] or \
                    pool["pool_bytes_total"] != \
                    single["pool"]["pool_bytes_total"]:
                fail(f"phase O {label}: rank {r}'s pool {pool}, the single "
                     f"rank's {single['pool']}")
        if "logits" in single:
            ref = single["logits"]
            err = float(np.abs(rec["logits"] - ref).max())
            if err > MESH_LOGIT_TOL * float(np.abs(ref).max()):
                fail(f"phase O {label}: rank {r}'s first prefill logits "
                     f"differ by {err:.3e} (tol {MESH_LOGIT_TOL} x "
                     f"max|ref| {float(np.abs(ref).max()):.3e})")
            rec["logit_err"] = err
        if "gloo" not in rec["audit"].get("eager_steps", ""):
            fail(f"phase O {label}: rank {r}'s audit {rec['audit']} does "
                 f"not say its steps ran eagerly under gloo")
    if "logits" in single and \
            ranks[0]["logits"].tobytes() != ranks[1]["logits"].tobytes():
        fail(f"phase O {label}: the two ranks' logits differ")


def _check_vlm_mesh_run(label, ranks, single, layers: int):
    """Phase O's gates on the four-rank InternVL2-1B run: every rank's
    tokens one rank's; every KV site holds a quarter of its slots (64 of
    256), its KV and `table` bytes a quarter of one rank's; K2 launched
    0 times, every decode-attention call declined as
    `shard_hkv_lt_axis` and no other fallback; K1 (5 column + 2 row a
    layer) and K7 (2 a layer) launches per forward call and per decode
    step; the first prompt's prefill logits within `MESH_LOGIT_TOL`."""
    import numpy as np
    tp = MESH_VLM_RANKS
    want_out = single["outputs"]
    declined = "cuda_sharded->fallback:shard_hkv_lt_axis[decode_attn]"
    for r, rec in enumerate(ranks):
        if rec["outputs"] != want_out:
            fail(f"phase O {label}: rank {r}'s tokens differ from the "
                 f"single-rank run's")
        st = rec["stats"]
        fwd = st["prefills_run"] + st["prefill_chunks_run"] \
            + st["decodes_run"]
        counts = rec["counts"]
        disp = counts["dispatch"]
        bad = [k for k in disp if not k.startswith("cuda_sharded")
               or ("->fallback" in k and k != declined)]
        if bad or disp.get(declined) != layers * st["decodes_run"]:
            fail(f"phase O {label}: rank {r} dispatch {disp}, expected "
                 f"{layers * st['decodes_run']} {declined}")
        shard = {"ovp_matmul[fp]@col": 5 * layers,
                 "ovp_matmul[fp]@row": 2 * layers}
        wants = {"ovp_matmul[fp]": 7 * layers * fwd,
                 "ovp_encode": 2 * layers * (st["decodes_run"]
                                             + st["prefills_run"]),
                 "decode_attn": 0, "paged_decode_attn": 0,
                 "prefill_attn": 0}
        wants.update({k: v * fwd for k, v in shard.items()})
        got = {k: counts["shard"].get(k, counts.get(k)) for k in wants}
        if got != wants:
            fail(f"phase O {label}: rank {r} launches {got}, expected "
                 f"{wants} ({fwd} forward calls)")
        want_step = {"ovp_matmul[fp]": 7 * layers, "ovp_encode": 2 * layers,
                     **shard}
        step = rec["step_counts"]
        if any(step.get(k) != v for k, v in want_step.items()) or \
                step.get("decode_attn"):
            fail(f"phase O {label}: rank {r}'s decode step launched {step},"
                 f" expected {want_step} and no K2")
        if rec["kv_bytes"] * tp != single["kv_bytes"] or \
                rec["table_bytes"] * tp != single["table_bytes"]:
            fail(f"phase O {label}: rank {r}'s KV bytes {rec['kv_bytes']} "
                 f"and table bytes {rec['table_bytes']}, a quarter of the "
                 f"single rank's {single['kv_bytes']} and "
                 f"{single['table_bytes']} expected")
        for part in rec["slots"]:
            if part is None or part[:3] != (r * 64, 64, 256):
                fail(f"phase O {label}: rank {r}'s KV sites hold slots "
                     f"{rec['slots']}, ({r * 64}, 64, 256) expected")
        ref = single["logits"]
        err = float(np.abs(rec["logits"] - ref).max())
        rec["logit_err"] = err
        if err > MESH_LOGIT_TOL * float(np.abs(ref).max()):
            fail(f"phase O {label}: rank {r}'s first prefill logits differ "
                 f"by {err:.3e} (tol {MESH_LOGIT_TOL} x max|ref| "
                 f"{float(np.abs(ref).max()):.3e})")


def mesh_kernel_phase(dev):
    """Each new shard shape of phase O once on the card against its plain
    version, with the tolerances the kernel phases use, timed like them
    (CUDA-graph replay) beside the plain version, a library call and the
    bound: K1 over one Qwen1.5-0.5B layer's column slices (wq, wk, wv,
    wg, wu: N / 2) and row slices (wo 256 and wd 704 packed rows) of
    rank 0 and rank 1, rows 4; K6 at E 64 (each rank's experts of
    Qwen3-30B-A3B's 128) with that rank's slice of a seeded top-8
    routing's decode fill; K2, K3 and K4 at the local Hkv (Qwen1.5:
    Hkv 8, G 1, D 64; Qwen3: Hkv 2, G 8, D 128); K7 on the local heads'
    KV write (R 4 slots x 8 heads, K 64; R 4 x 2, K 128); K1 over one
    InternVL2-1B layer's column and row slices at tp 4 (every rank's,
    rows 4) and K7 at its KV write (R 4 slots x 2 heads, K 64: every
    rank encodes its rows' K and V, the owner of the slot writes
    them)."""
    import torch
    from repro_torch.backends.sharded import local_shard
    from repro_torch.core import policy
    from repro_torch.core.ovp import ovp_dequantize
    from repro_torch.core.qlinear import quantize_weight
    from repro_torch.kernels import ovp_encode as enc
    from repro_torch.kernels import ovp_matmul as mm
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(28)
    w4 = policy.OLIVE_W4.replace_all(compute_dtype="float32")
    sites = {"attn/wq": (1024, 1024), "attn/wk": (1024, 1024),
             "attn/wv": (1024, 1024), "attn/wo": (1024, 1024),
             "mlp/wg": (1024, 2816), "mlp/wu": (1024, 2816),
             "mlp/wd": (2816, 1024)}
    whole = {s: quantize_weight(torch.randn(kn, generator=gen, device=dev)
                                / kn[0] ** 0.5, w4)
             for s, kn in sites.items()}
    out = {}
    for r in range(2):
        shards = {s: local_shard(w, f"layers/0/{s}", _Rank(r))
                  for s, w in whole.items()}
        for kind in ("col", "row"):
            linears = [w for w in shards.values() if w.mode == kind]
            rec = k1_layer_record(dev, gen, linears, 4, "int4",
                                  label=f"k1 tp2 {kind} rank {r}")
            out.setdefault(f"k1 {kind}", rec)
            out[f"k1 {kind}"]["max_abs_err"] = max(
                out[f"k1 {kind}"]["max_abs_err"], rec["max_abs_err"])
    # K1 over InternVL2-1B's rank shards at tp 4 (d 896, 14 heads, 2 KV
    # heads of 64, d_ff 4864)
    vlm = {"attn/wq": (896, 896), "attn/wk": (896, 128),
           "attn/wv": (896, 128), "attn/wo": (896, 896),
           "mlp/wg": (896, 4864), "mlp/wu": (896, 4864),
           "mlp/wd": (4864, 896)}
    whole = {s: quantize_weight(torch.randn(kn, generator=gen, device=dev)
                                / kn[0] ** 0.5, w4)
             for s, kn in vlm.items()}
    for r in range(MESH_VLM_RANKS):
        shards = {s: local_shard(w, f"layers/0/{s}",
                                 _Rank(r, MESH_VLM_RANKS))
                  for s, w in whole.items()}
        for kind in ("col", "row"):
            linears = [w for w in shards.values() if w.mode == kind]
            rec = k1_layer_record(dev, gen, linears, 4, "int4",
                                  label=f"k1 tp4 {kind} rank {r}")
            key = f"k1 tp4 {kind}"
            out.setdefault(key, rec)
            out[key]["max_abs_err"] = max(out[key]["max_abs_err"],
                                          rec["max_abs_err"])
    del whole
    # K6 at E 64 with each rank's slice of the decode fill
    e, b, c = 128, 4, 4
    fill = _routed_fill(gen, dev, b, 1)
    k6 = dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms"), 0.0)
    k6.update(max_abs_err=0.0, bound_by="bytes")
    for k, n in ((2048, 768), (2048, 768), (768, 2048)):
        stack = quantize_weight(torch.randn((e, k, n), generator=gen,
                                            device=dev) / k ** 0.5, w4)
        for r in range(2):
            qt = local_shard(stack, "layers/0/moe/experts/wg", _Rank(r))
            el = qt.data.shape[0]
            fl = fill[:, r * el:(r + 1) * el].contiguous()
            sw = qt.scale.reshape(el, n).contiguous()
            a = torch.randn((b, el, c, k), generator=gen, device=dev)

            def kern():
                return mm.run_grouped(a, None, qt.data, sw, w_dtype="int4",
                                      a_mode="fp", fill=fl)

            def plain():
                return mm.grouped_ovp_matmul_plain(
                    a, None, qt.data, sw, w_dtype="int4", a_mode="fp",
                    a_dtype="int4", fill=fl)

            got, ref = kern(), plain()
            live = torch.arange(c, device=dev) < fl[..., None]
            g, rr = got[live], ref[live]
            err = float((g - rr).abs().max()) if g.numel() else 0.0
            scale = float(rr.abs().max()) if rr.numel() else 0.0
            if not within(g, rr, 1e-5, 1e-5 * scale):
                fail(f"K6 tp2 rank {r} E={el} K={k} N={n}: max abs err "
                     f"{err:.3e} on filled rows (rtol 1e-5, atol "
                     f"1e-5*{scale:.3e})")
            touched, filled = int((fl.sum(0) > 0).sum()), int(fl.sum())
            dense = ovp_dequantize(qt)
            b_ms, b_by = bound_ms(touched * (k // 2 * n + 4 * n)
                                  + filled * (k * 4 + n * 4) + b * el * 4,
                                  2.0 * filled * k * n)
            rec = dict(ms=time_ms(kern)[0], plain_ms=time_ms(plain, 10)[0],
                       bound_ms=b_ms, library_ms=time_ms(
                           lambda: torch.einsum("beck,ekn->becn", a, dense),
                           10)[0])
            del dense
            print(f"[k6 tp2] rank {r} B={b} E={el} C={c} K={k:4d} N={n:4d}"
                  f": {touched} experts touched, {filled} rows; err="
                  f"{err:.2e} on filled rows (tol rtol 1e-5, atol "
                  f"1e-5*max|ref|) kernel={rec['ms']:.4f}ms warm L2, plain="
                  f"{rec['plain_ms']:.4f}ms einsum={rec['library_ms']:.4f}ms"
                  f" bound={b_ms:.5f}ms ({b_by})")
            if r == 0:
                for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                    k6[key] += rec[key]
                k6["bound_by"] = b_by
            k6["max_abs_err"] = max(k6["max_abs_err"], err)
        del stack
    out["k6"] = k6
    # K2, K3, K4 at the local Hkv (G unchanged), the kernel phases' checks
    for tag, (hkv, g, d) in (("qwen", (8, 1, 64)), ("moe", (2, 8, 128))):
        out[f"k2 {tag}"] = k2_phase(dev, hkv, g, d, all_pos=False)
        out[f"k3 {tag}"] = k3_phase(dev, hkv, g, d, all_pos=False)
        out[f"k4 {tag}"] = k4_phase(dev, hkv, g, d, cs=(16,))
    # K7 on the local heads' KV write, 0 bytes differing
    for tag, r_rows, k in (("qwen", 4 * 8, 64), ("moe", 4 * 2, 128),
                           ("vlm", 4 * 2, 64)):
        x, scales = _k7_inputs(dev, gen, r_rows, k, "float32")
        scale = scales["row"]
        got = enc.fused_ovp_encode(x, scale=scale)
        ref = enc.ovp_encode_plain(x, scale)
        differ = int((got != ref).sum())
        if differ:
            fail(f"K7 tp2 {tag} R={r_rows} K={k}: {differ} bytes differ")
        b_ms, b_by = bound_ms(r_rows * k * 4 + r_rows * k // 2 + 4 * r_rows,
                              0.0)
        out[f"k7 {tag}"] = rec = dict(
            ms=time_ms(lambda: enc.fused_ovp_encode(x, scale=scale))[0],
            plain_ms=time_ms(lambda: enc.ovp_encode_plain(x, scale),
                             graph=False)[0],
            bound_ms=b_ms, bound_by=b_by, library_ms=None, max_abs_err=0.0)
        print(f"[k7 tp2] {tag} KV write on the local heads R={r_rows} K={k}"
              f" f32, a scale a row: 0 bytes differing; kernel="
              f"{rec['ms']:.4f}ms plain={rec['plain_ms']:.4f}ms (eager) "
              f"bound={b_ms:.3g}ms ({b_by})")
    print(f"[mesh O] shard kernels phase took "
          f"{time.perf_counter() - t_phase:.1f}s")
    return out


def serve_phase_o(dev, smi: str, ref):
    """Serving on a mesh: two ranks on card 0 over gloo (`_spawn_mesh_
    ranks`), Qwen1.5-0.5B at full width and depth, slab and paged, held to
    phases A and C (`ref`, `mesh_reference`), and Qwen3-30B-A3B at
    `MESH_E_LAYERS` layers with EP 2, slab and paged, held to one rank's
    run of the same cut here; then four ranks on card 0, InternVL2-1B at
    `MESH_VLM_LAYERS` layers with its caches split by slot, held to one
    rank's run of the same cut (`_check_vlm_mesh_run`); then the shard
    shapes' kernels (`mesh_kernel_phase`). Prints per rank: wall ms a
    decode step, collectives and bytes a step, peak memory. No speed
    claim: the ranks share one card, and gloo runs the collectives on
    the host."""
    import torch
    t_phase = time.perf_counter()
    free_device_memory()
    ranks = _spawn_mesh_ranks()
    t_ranks = time.perf_counter() - t_phase
    single = dict(ref, **_single_cut_runs(dev))
    free_device_memory()
    for label, _, (arch, depth) in _mesh_runs():
        recs = [r[label] for r in ranks]
        _check_mesh_run(label, recs, single[label], depth)
        for r, rec in enumerate(recs):
            coll = rec["step_collectives"]
            q, raw = rec["weights"]
            print(f"[mesh O] {label} rank {r} ({smi}; two ranks sharing one "
                  f"card over gloo, eager steps): tokens equal to one rank's "
                  f"({sum(map(len, rec['outputs'].values()))}), no fallback,"
                  f" a decode step {rec['step_ms']:.2f}ms wall, launches "
                  f"{rec['step_counts']}, "
                  f"collectives a step {coll.get('all_gather', 0):g} "
                  f"all-gathers + {coll.get('sum', 0):g} sums, "
                  f"{coll.get('bytes', 0) / 1e6:.3f} MB received; KV bytes "
                  f"{rec['kv_bytes']} (one rank: {single[label]['kv_bytes']})"
                  f", quantized weights {q / 1e6:.1f} MB "
                  f"({q / single[label]['weights'][0]:.3f} of one rank's), "
                  f"raw {raw / 1e6:.1f} MB; peak {rec['peak_gb']:.2f} GB; run "
                  f"{rec['seconds']:.2f}s, {rec['tok_per_s']:.1f} tok/s"
                  + (f"; first prefill logits within {rec['logit_err']:.2e}"
                     f" of one rank's" if "logit_err" in rec else ""))
    # four ranks: InternVL2-1B, its caches split by slot
    t_vlm = time.perf_counter()
    free_device_memory()
    vlm = _spawn_mesh_ranks(MESH_VLM_RANKS)
    t_vlm_ranks = time.perf_counter() - t_vlm
    single.update(_single_cut_runs(dev, MESH_VLM_RANKS))
    free_device_memory()
    for label, _, (arch, depth) in _mesh_runs(MESH_VLM_RANKS):
        recs = [r[label] for r in vlm]
        _check_vlm_mesh_run(label, recs, single[label], depth)
        for r, rec in enumerate(recs):
            coll = rec["step_collectives"]
            q, raw = rec["weights"]
            print(f"[mesh O] {label} {arch} ({depth} of 24 layers, --mesh "
                  f"1,{MESH_VLM_RANKS}) rank {r} ({smi}; four ranks sharing "
                  f"one card over gloo, eager steps): tokens equal to one "
                  f"rank's ({sum(map(len, rec['outputs'].values()))}), "
                  f"slots {rec['slots'][0][:3]} of every KV site, decode "
                  f"attention declined {rec['counts']['dispatch']}; a "
                  f"decode step {rec['step_ms']:.2f}ms wall, launches "
                  f"{rec['step_counts']}, collectives a step "
                  f"{coll.get('all_gather', 0):g} all-gathers + "
                  f"{coll.get('sum', 0):g} sums, "
                  f"{coll.get('bytes', 0) / 1e6:.3f} MB received; KV bytes "
                  f"{rec['kv_bytes']} (one rank: {single[label]['kv_bytes']})"
                  f", table bytes {rec['table_bytes']} (one rank: "
                  f"{single[label]['table_bytes']}), quantized weights "
                  f"{q / 1e6:.2f} MB ({q / single[label]['weights'][0]:.3f}"
                  f" of one rank's), raw {raw / 1e6:.1f} MB; peak "
                  f"{rec['peak_gb']:.2f} GB; first prefill logits within "
                  f"{rec['logit_err']:.2e} of one rank's")
    print(f"[mesh O] four ranks {t_vlm_ranks:.1f}s, with the single-rank "
          f"run {time.perf_counter() - t_vlm:.1f}s")
    kern = mesh_kernel_phase(dev)
    print(f"[mesh O] ranks {t_ranks:.1f}s; phase took "
          f"{time.perf_counter() - t_phase:.1f}s")
    return {"ranks": ranks, "vlm": vlm, "kernels": kern}


# --------------------------------------------------------------------------
# Phase P: training on a mesh (two ranks sharing the card over gloo) and
# the dry run of the production meshes
# --------------------------------------------------------------------------
P_STEPS = 2             # P1's steps (4 and an eval until cut for time)
P_CKPT_STEP = 1         # P1's checkpoint that P2 restores and finishes
P_ARGS = ["--quant", "olive_w4a4", "--batch", "8", "--seq", "512",
          "--steps", str(P_STEPS), "--ckpt-every", str(P_CKPT_STEP),
          "--seed", "0"]
P_CKPT = os.path.join(ROOT, "build", "ckpt_p")
# 2 ranks (4 rows each) against one rank (8 rows), bf16 compute under
# W4A4 QAT. Step 1 starts from the same weights: its loss within
# P_FIRST_RTOL, its grad norm within phase M's W4A4 card-vs-CPU
# tolerance (the two sum their bf16 gradients in another order, and a
# last-bit difference can flip a 4-bit code, which moves whole gradient
# rows). After it the states part: AdamW's first steps move each weight
# by about lr * sign(g), and a gradient near 0 whose bf16 sum takes the
# other sign moves its weight 2 * lr the other way, so later losses are
# held to phase M's W4A4 loss tolerance and later grad norms are printed
P_FIRST_RTOL = 1e-3
P_LOSS_RTOL = 1e-2
P_GNORM_RTOL = 1e-2
P_XLSTM_LAYERS = 2      # P3's depth: one whole period (mLSTM, sLSTM) of 24
P_XLSTM_ARGS = ["--batch", "2", "--seq", "128", "--steps", "3", "--seed",
                "0"]
P_XLSTM_RTOL = 1e-3     # TP ranks compute the same rows as one rank
P_RANK_TIMEOUT = 600    # seconds a rank may take for its runs
P_DRYRUN_OUT = os.path.join(ROOT, "build", "dryrun_p")
P_DRYRUN_TIMEOUT = 900  # seconds the dry run (started with the script) gets
# P5's serve cells: the two smoke cells the reference committed records
# of (EXPERIMENTS/dryrun/), and Qwen2-7B at full size
P_SMOKE = "qwen1.5-0.5b-smoke"
P_SERVE_CELLS = [(P_SMOKE, "decode_32k"), (P_SMOKE, "prefill_32k"),
                 ("qwen2-7b", "decode_32k")]
# the leaves tests/test_torch_dryrun_records.py names: port bytes less
# the reference's a rank, for (arguments, outputs). Arguments: the
# quantized attention and MLP codes and column scales the reference
# replicates and the tied head's unread w_out (640 - 44,544 together);
# outputs: the logits, every vocab column on the port (f32)
P_SMOKE_NAMED = {"decode_32k": (640 - 44544, 8 * 480 * 4),
                 "prefill_32k": (640 - 44544, 2 * 480 * 4)}


def start_dryrun():
    """Start phase P5's dry run of Qwen1.5-0.5B train_4k on both
    production meshes (256 and 512 fake ranks, "meta" tensors: CPU only),
    then of `P_SERVE_CELLS` (single, olive_kv), in a child process at
    once, so it runs beside the card's phases;
    `dryrun_phase` waits for it. The child is killed when this process
    exits."""
    import atexit
    import shutil
    shutil.rmtree(P_DRYRUN_OUT, ignore_errors=True)
    os.makedirs(P_DRYRUN_OUT)
    log = open(os.path.join(P_DRYRUN_OUT, "log.txt"), "w")
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    runs = [["--arch", TRAIN_ARCH, "--shape", "train_4k", "--mesh",
             "both"]] + [["--arch", arch, "--shape", shape, "--mesh",
                          "single", "--quant", "olive_kv"]
                         for arch, shape in P_SERVE_CELLS]
    code = ("import sys\n"
            "from repro_torch.launch import dryrun\n"
            f"runs = {runs!r}\n"
            f"sys.exit(max(dryrun.main(r + ['--out', {P_DRYRUN_OUT!r}, "
            "'--force']) for r in runs))\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code], stdout=log, stderr=subprocess.STDOUT,
        env=env, cwd=ROOT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "log": log, "t0": time.perf_counter()}


class _LastStep:
    """Wraps the launcher's train cell (`launch/specs.py::
    build_train_cell`, patched while `run()` builds it) so that each
    step runs alone (a barrier first, the card synchronized around it)
    with the collective counts reset: the last step's wall ms and
    collectives stay in `ms` and `collectives`."""

    def __init__(self, dev):
        self.dev, self.ms, self.collectives = dev, None, None

    def __enter__(self):
        from repro_torch.launch import specs
        self.specs, self.real = specs, specs.build_train_cell

        def build(*args, **kw):
            cell = self.real(*args, **kw)
            cell.fn = self.wrap(cell.fn)
            return cell

        specs.build_train_cell = build
        return self

    def __exit__(self, *exc):
        self.specs.build_train_cell = self.real

    def wrap(self, step):
        import torch
        import torch.distributed as dist
        from repro_torch.launch import mesh as mesh_lib

        def timed(state, batch):
            torch.cuda.synchronize(self.dev)
            dist.barrier()
            mesh_lib.reset_collective_stats()
            t0 = time.perf_counter()
            out = step(state, batch)
            float(out[1]["loss"])
            torch.cuda.synchronize(self.dev)
            self.ms = (time.perf_counter() - t0) * 1e3
            self.collectives = mesh_lib.collective_stats()
            return out

        timed.evaluate = step.evaluate
        timed.value_and_grad = step.value_and_grad
        return timed


def _p_rank_record(res, dev, last: _LastStep):
    """What phase P keeps of one rank's training run: the history, this
    rank's parameter and moment bytes, peak memory, and its last step's
    wall ms, collectives and bytes (`last`)."""
    import torch
    from repro_torch.roofline.step_stats import tree_bytes
    st = res["trainer"].state
    return {"history": res["history"],
            "param_bytes": tree_bytes(st.params),
            "moment_bytes": tree_bytes(st.opt.mu) + tree_bytes(st.opt.nu),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "note": res["cell"].note if res["cell"] else None,
            "step_ms": last.ms, "step_collectives": last.collectives}


def _p_rank(rank: int, init: str, out_dir: str) -> None:
    """One rank of phase P: P1 (`launch/train.py --mesh 1x2` at full
    width and depth, checkpoints every `P_CKPT_STEP` steps under
    `P_CKPT`), whose `run()` starts the gloo group through the file
    `init` (two ranks on card 0), then P3 (xLSTM-350M cut to
    `P_XLSTM_LAYERS`, `--mesh 1x2`: the TP rules) in that group; the
    records go to `out_dir/rank<rank>.pkl`. Any error exits non-zero."""
    import pickle
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch import train
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)           # both ranks share card 0
    torch.cuda.set_device(dev)
    recs = {}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    # the launcher starts the process group itself (gloo: two ranks on
    # one card) from the rank and the rendezvous file
    with _LastStep(dev) as last:
        res = train.run(["--arch", TRAIN_ARCH, *P_ARGS, "--mesh", "1x2",
                         "--ckpt-dir", P_CKPT], device="cuda",
                        log_fn=lambda *a: None, rank=rank, world_size=2,
                        init_method=f"file://{init}")
    recs["p1"] = _p_rank_record(res, dev, last)
    recs["p1"]["seconds"] = time.perf_counter() - t0
    del res
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with cut_arch(XLSTM_ARCH, P_XLSTM_LAYERS) as name, \
            _LastStep(dev) as last:
        res = train.run(["--arch", name, *P_XLSTM_ARGS, "--mesh", "1x2"],
                        device="cuda", log_fn=lambda *a: None)
    recs["p3"] = _p_rank_record(res, dev, last)
    recs["p3"]["seconds"] = time.perf_counter() - t0
    del res
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(recs, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn_p_ranks():
    """Run `_p_rank` in two processes; their records by rank. A rank that
    fails, exits non-zero or outlives `P_RANK_TIMEOUT` fails the
    phase."""
    import pickle
    import shutil
    import torch.multiprocessing as mp
    out_dir = os.path.join(ROOT, "build", "mesh_p")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.rmtree(P_CKPT, ignore_errors=True)
    os.makedirs(out_dir)
    init = os.path.join(out_dir, "rendezvous")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_p_rank, args=(r, init, out_dir))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + P_RANK_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        fail(f"phase P: ranks exited {codes} (0 expected; negative: killed "
             f"after {P_RANK_TIMEOUT}s or by a signal)")
    recs = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            recs.append(pickle.load(f))
    return recs


def _rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _p_compare(label, ranks, one, loss_rtol, gnorm_rtol, smi,
               first_rtol=None):
    """Both ranks' losses and grad norms equal each other's and, within
    the tolerances, one rank's run of the same steps: every loss within
    `loss_rtol`; with `first_rtol`, step 1's loss within it and only step
    1's grad norm within `gnorm_rtol` (later ones printed), else every
    grad norm. Printed step by step."""
    h0 = ranks[0]["history"]
    for r, rec in enumerate(ranks):
        if rec["history"]["loss"] != h0["loss"]:
            fail(f"phase P {label}: rank {r}'s losses {rec['history']} "
                 f"differ from rank 0's {h0}")
    want = one["history"]
    if h0["step"] != want["step"]:
        fail(f"phase P {label}: steps {h0['step']} vs one rank's "
             f"{want['step']}")
    loss_err = _rel(h0["loss"], want["loss"])
    gnorm_err = _rel(h0["grad_norm"], want["grad_norm"])
    first = _rel(h0["loss"][:1], want["loss"][:1])
    gated = gnorm_err if first_rtol is None else \
        _rel(h0["grad_norm"][:1], want["grad_norm"][:1])
    for i, step in enumerate(h0["step"]):
        print(f"[train P] {label} step {step}: loss {h0['loss'][i]:.6f} "
              f"(2 ranks) vs {want['loss'][i]:.6f} (one rank), grad norm "
              f"{h0['grad_norm'][i]:.5f} vs {want['grad_norm'][i]:.5f} "
              f"[{smi}]")
    if first_rtol is None:
        gates = (f"grad norm {gnorm_err:.2e} (tol {gnorm_rtol})")
    else:
        gates = (f"step 1: loss {first:.2e} (tol {first_rtol}), grad norm "
                 f"{gated:.2e} (tol {gnorm_rtol}); every grad norm "
                 f"{gnorm_err:.2e} (printed, not gated)")
    print(f"[train P] {label}: worst gap loss {loss_err:.2e} (tol "
          f"{loss_rtol}), {gates} [{smi}]")
    if loss_err > loss_rtol or gated > gnorm_rtol or \
            (first_rtol is not None and first > first_rtol):
        fail(f"phase P {label}: the 2-rank run is not one rank's within "
             f"the tolerances")
    return {"loss_rel": loss_err, "gnorm_rel": gnorm_err,
            "first_loss_rel": first}


def _p_bytes(label, ranks, one, smi):
    """Each rank's parameter and moment bytes beside one rank's, its
    peak memory, and its last step's wall, collectives and bytes."""
    from repro_torch.roofline.step_stats import tree_bytes
    st = one["state"]
    p1 = tree_bytes(st.params)
    m1 = tree_bytes(st.opt.mu) + tree_bytes(st.opt.nu)
    for r, rec in enumerate(ranks):
        coll = rec["step_collectives"]
        print(f"[train P] {label} rank {r} ({smi}; two ranks sharing one "
              f"card over gloo, eager): params {rec['param_bytes'] / 1e6:.1f}"
              f" MB, moments {rec['moment_bytes'] / 1e6:.1f} MB (one rank: "
              f"{p1 / 1e6:.1f} and {m1 / 1e6:.1f} MB, ratio "
              f"{rec['param_bytes'] / p1:.3f}); its last step "
              f"{rec['step_ms']:.0f} ms wall, "
              f"{coll.get('all_gather', 0)} all-gathers "
              f"{coll.get('all_gather_bytes', 0) / 1e6:.1f} MB + "
              f"{coll.get('sum', 0)} rank sums "
              f"{coll.get('sum_bytes', 0) / 1e6:.1f} MB received; peak "
              f"{rec['peak_gb']:.2f} GB; run {rec['seconds']:.1f}s")
    return p1, m1


def dryrun_phase(job, smi: str) -> dict:
    """P5: wait for the dry run `start_dryrun` started and print its
    records' per-rank bytes, collectives and bottleneck. Both cells must
    be "ok"."""
    proc = job["proc"]
    try:
        code = proc.wait(max(1.0, P_DRYRUN_TIMEOUT
                             - (time.perf_counter() - job["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"phase P5: the dry run outlived {P_DRYRUN_TIMEOUT}s")
    job["log"].close()
    if code:
        with open(job["log"].name) as f:
            tail = f.read()[-2000:]
        fail(f"phase P5: the dry run exited {code}:\n{tail}")
    out = {}
    for mk in ("single", "multi"):
        path = os.path.join(P_DRYRUN_OUT,
                            f"{TRAIN_ARCH}__train_4k__{mk}__none.json")
        with open(path) as f:
            rec = json.load(f)
        if rec["status"] != "ok":
            fail(f"phase P5: {rec['cell']} is {rec['status']}")
        mem, roof = rec["memory_analysis"], rec["roofline"]
        print(f"[dryrun P] {rec['cell']} ({rec['n_chips']} fake ranks, "
              f"rank 0 traced on meta in {rec['trace_s']}s; CPU only, no "
              f"card): {rec['note']}; per rank arguments "
              f"{mem['argument_size_per_chip'] / 1e6:.2f} MB, outputs "
              f"{mem['output_size_per_chip'] / 1e6:.2f} MB; collectives "
              f"{rec['collective_ops']}, "
              f"{rec['collective_bytes']['total'] / 1e9:.2f} GB received a "
              f"step; roofline on the H100 SXM data sheet: compute "
              f"{roof['t_compute_s']:.4f}s, memory {roof['t_memory_s']:.4f}s,"
              f" collective {roof['t_collective_s']:.4f}s -> "
              f"{roof['bottleneck']} [{smi}]")
        out[mk] = rec
    for arch, shape in P_SERVE_CELLS:
        cell = f"{arch}__{shape}__single__olive_kv"
        with open(os.path.join(P_DRYRUN_OUT, cell + ".json")) as f:
            rec = json.load(f)
        if rec["status"] != "ok":
            fail(f"phase P5: {cell} is {rec['status']}: "
                 f"{rec.get('error')}")
        mem = rec["memory_analysis"]
        line = (f"[dryrun P] {cell} ({rec['n_chips']} fake ranks, traced in "
                f"{rec['trace_s']}s; CPU only): per rank arguments "
                f"{mem['argument_size_per_chip']} bytes, outputs "
                f"{mem['output_size_per_chip']}, caches "
                f"{mem['alias_size_per_chip']}; collectives "
                f"{rec['collective_ops']}")
        if arch == P_SMOKE:
            with open(os.path.join(ROOT, "EXPERIMENTS", "dryrun",
                                   cell + ".json")) as f:
                want = json.load(f)["memory_analysis"]
            d_arg, d_out = P_SMOKE_NAMED[shape]
            for key, d in (("argument_size_per_chip", d_arg),
                           ("output_size_per_chip", d_out)):
                adjusted = mem[key] - d
                if abs(adjusted - want[key]) > 0.01 * want[key]:
                    fail(f"phase P5: {cell} {key} {mem[key]} ({adjusted} "
                         f"with the named leaves at the reference's "
                         f"counts), the reference's committed record "
                         f"{want[key]} (1 %)")
                line += (f"; {key} with the named leaves at the "
                         f"reference's counts {adjusted}, the reference's "
                         f"{want[key]}")
        print(line)
        out[cell] = rec
    print(f"[dryrun P] the cells took "
          f"{sum(r['build_s'] + r['trace_s'] for r in out.values()):.1f}s "
          f"to build and trace, in a child started after the build (CPU "
          f"only, beside the card's phases); waited "
          f"{time.perf_counter() - job['t0']:.1f}s after its start")
    return out


def train_phase_p(dev, smi: str, job) -> dict:
    """Phase P: training on a mesh (see the module docstring, item 22)."""
    import shutil

    import torch
    from repro_torch.launch import train
    t_phase = time.perf_counter()
    free_device_memory()
    ranks = _spawn_p_ranks()
    t_ranks = time.perf_counter() - t_phase
    # P1: one rank, the same steps
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(dev)
    one = train.run(["--arch", TRAIN_ARCH, *P_ARGS], device=dev,
                    log_fn=lambda *a: None)
    one_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    p1 = [r["p1"] for r in ranks]
    cmp1 = _p_compare("P1 qwen1.5-0.5b QAT olive_w4a4 8 x 512, --mesh 1x2 "
                      "(dp_only: FSDP)", p1, one, P_LOSS_RTOL, P_GNORM_RTOL,
                      smi, first_rtol=P_FIRST_RTOL)
    print(f"[train P] P1 one rank's peak {one_peak:.2f} GB [{smi}]")
    p_bytes = _p_bytes("P1", p1, one, smi)
    one_losses = one["history"]["loss"]
    del one
    free_device_memory()
    # P2: the mesh's mid-run checkpoint, restored by one rank that
    # finishes the run
    resume_dir = os.path.join(ROOT, "build", "ckpt_p2")
    mid = f"step_{P_CKPT_STEP:08d}"
    shutil.rmtree(resume_dir, ignore_errors=True)
    shutil.copytree(os.path.join(P_CKPT, mid),
                    os.path.join(resume_dir, mid))
    res2 = train.run(["--arch", TRAIN_ARCH, *P_ARGS, "--ckpt-dir",
                      resume_dir], device=dev, log_fn=lambda *a: None)
    h2, mesh_h = res2["history"], p1[0]["history"]
    if h2["step"] != list(range(P_CKPT_STEP + 1, P_STEPS + 1)):
        fail(f"phase P2: the resumed run ran steps {h2['step']}")
    p2_err = _rel(h2["loss"], mesh_h["loss"][P_CKPT_STEP:])
    print(f"[train P] P2 the 2-rank run's step-{P_CKPT_STEP} checkpoint "
          f"restored on one rank (restore "
          f"{res2['trainer'].ckpt_seconds['restore']:.2f}s): steps "
          f"{h2['step']} losses {[round(x, 6) for x in h2['loss']]} vs the "
          f"mesh's {[round(x, 6) for x in mesh_h['loss'][P_CKPT_STEP:]]}: "
          f"worst {p2_err:.2e} (tol {P_LOSS_RTOL}) [{smi}]")
    if p2_err > P_LOSS_RTOL:
        fail("phase P2: the resumed losses are not the mesh's")
    del res2
    shutil.rmtree(resume_dir, ignore_errors=True)
    free_device_memory()
    # P3: xLSTM-350M's TP branch against one rank
    with cut_arch(XLSTM_ARCH, P_XLSTM_LAYERS) as name:
        one3 = train.run(["--arch", name, *P_XLSTM_ARGS], device=dev,
                         log_fn=lambda *a: None)
    p3 = [r["p3"] for r in ranks]
    if "dp_only" in (p3[0]["note"] or ""):
        fail(f"phase P3: xLSTM ran dp_only ({p3[0]['note']})")
    cmp3 = _p_compare(f"P3 xlstm-350m {P_XLSTM_LAYERS} of 24 layers, 2 x "
                      f"128, --mesh 1x2 (TP)", p3, one3, P_XLSTM_RTOL,
                      P_XLSTM_RTOL, smi)
    _p_bytes("P3", p3, one3, smi)
    del one3
    free_device_memory()
    # P4: the mesh's trained weights (the params of rank 0's last
    # checkpoint, in the one-device layout, restored on the card) served
    # through K1, K2, K7
    from repro_torch import convert
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.train_step import init_state
    if ckpt.latest_step(P_CKPT) != P_STEPS:
        fail(f"phase P4: no checkpoint of step {P_STEPS} in {P_CKPT}")
    meta = init_state(build_model(get_config(TRAIN_ARCH)),
                      AdamW(moment_dtype=torch.bfloat16), None,
                      device="meta")
    ref = convert.state_to_reference(meta, get_config(TRAIN_ARCH))
    # the params alone ("state/.params/..." in the checkpoint's paths)
    got = ckpt.restore(P_CKPT, P_STEPS, {"state": {".params": ref.params}},
                       device=dev)
    params = convert.params_from_numpy(got["state"][".params"], dev)
    del got
    counts = train_serve_check(dev, params, smi, label="phase P serve")
    del params
    shutil.rmtree(P_CKPT, ignore_errors=True)
    free_device_memory()
    dry = dryrun_phase(job, smi)
    took = time.perf_counter() - t_phase
    print(f"[train P] ranks {t_ranks:.1f}s; phase took {took:.1f}s "
          f"(P1's one-rank losses {[round(x, 4) for x in one_losses]})")
    return {"counts": counts, "p1": cmp1, "p3": cmp3, "bytes": p_bytes,
            "dryrun": dry, "took": took}


# --------------------------------------------------------------------------
# Phase X: the four examples (examples_torch/) on the card
# --------------------------------------------------------------------------
X_MODES = {"w4": {}, "kv4": {"kv4": True}, "w8": {"w8": True},
           "mixed": {"mixed": True}}   # serve_quantized's flag sets
X_REQUESTS, X_NEW = 12, 24      # serve_quantized's workload, uncut
X_ROW_RTOL = 1e-3               # ptq_calibrate's rows, card vs CPU
X_SMALL_STEPS = 120             # train_e2e's default run, uncut
X_BIG_STEPS = 40                # --model-100m's steps, cut from 200 for time
X_POS = [20, 35, 46, 11]        # K2's positions: served rows of 12-47 tokens
X_CKPT = os.path.join(ROOT, "build", "ckpt_x")


def _x_import():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import examples_torch.fixture as fixture
    import examples_torch.ptq_calibrate as ptq
    import examples_torch.quickstart as quickstart
    import examples_torch.serve_quantized as sq
    import examples_torch.train_e2e as e2e
    return fixture, quickstart, ptq, sq, e2e


def _x_attn_want(*engines):
    """K2 launches by cache dtype the drained engines' decode steps make:
    one a layer a step, over the layer's packed (int4) or fp32 cache."""
    want = {"decode_attn<int4>": 0, "decode_attn<float32>": 0}
    for eng in engines:
        steps = eng.stats()["decodes_run"]
        for layer in eng.caches["layers"]:
            kind = "int4" if "k_data" in layer["kv"] else "float32"
            want[f"decode_attn<{kind}>"] += steps
    return want


def k7_x_record(dev, r: int, k: int):
    """K7 at the bench-lm KV write (R = slots x KV heads, K = head_dim,
    f32, a scale a row) against its plain version (0 bytes differing),
    timed beside it and the byte bound."""
    import torch
    from repro_torch.kernels import ovp_encode as enc
    gen = torch.Generator(device=dev).manual_seed(31)
    x, scales = _k7_inputs(dev, gen, r, k, "float32")
    for kind, scale in scales.items():
        got = enc.fused_ovp_encode(x, scale=scale)
        differ = int((got != enc.ovp_encode_plain(x, scale)).sum())
        if differ:
            fail(f"K7 R={r} K={k} scale {kind}: {differ} bytes differ from "
                 f"the plain version")
    scale = scales["row"]
    b_ms, b_by = bound_ms(r * k * 4 + r * k // 2 + 4 * r, 0.0)
    rec = dict(max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
               library_ms=None,
               ms=time_ms(lambda: enc.fused_ovp_encode(x, scale=scale))[0],
               plain_ms=time_ms(lambda: enc.ovp_encode_plain(x, scale),
                                graph=False)[0])
    print(f"[k7 x] R={r} K={k} f32, a scale a row: 0 bytes differing at "
          f"scales none/scalar/row; kernel={rec['ms']:.4f}ms plain="
          f"{rec['plain_ms']:.4f}ms (eager) bound={b_ms:.3g}ms ({b_by})")
    return rec


def k2_x_records(dev, cfg, slots: int, max_len: int):
    """K2 at the bench-lm serving shape (B slots, S max_len, Hkv, G, D of
    `cfg`), packed and fp32 caches, `X_POS`, through `k2_record`."""
    import torch
    from repro_torch.models.layers import _quant_kv_token
    gen = torch.Generator(device=dev).manual_seed(32)
    hkv, d = cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((slots, 1, cfg.n_heads, d), generator=gen, device=dev)
    k, v = (torch.randn((slots, max_len, hkv, d), generator=gen, device=dev)
            for _ in range(2))
    (kd, ks), (vd, vs) = _quant_kv_token(k), _quant_kv_token(v)
    pos = torch.tensor(X_POS, dtype=torch.int32, device=dev)
    return {"int4": k2_record(q, {"k_data": kd, "v_data": vd, "k_scl": ks,
                                  "v_scl": vs}, pos, 0, 0, "x packed"),
            "float32": k2_record(q, {"k": k, "v": v}, pos, 0, 0, "x fp32")}


def _x_train(dev, e2e, cfg, steps: int, label: str) -> dict:
    """train_e2e's two-phase run on the card: its verdict, resume step,
    tokens / s over the steps, peak memory and checkpoint seconds."""
    import shutil

    import torch
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = e2e.train(cfg, steps, X_CKPT, dev, log=lambda _line: None)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    shutil.rmtree(X_CKPT, ignore_errors=True)
    times = r["h1"]["step_time"] + r["h2"]["step_time"]
    losses = r["h1"]["loss"] + r["h2"]["loss"]
    if r["resumed"] != steps // 2:
        fail(f"{label}: resumed at step {r['resumed']}, not {steps // 2}")
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
        fail(f"{label}: {len(losses)} losses of {steps}, finite: "
             f"{all(math.isfinite(x) for x in losses)}")
    if not r["last"] < r["first"]:
        fail(f"{label}: the loss did not fall ({r['first']:.4f} -> "
             f"{r['last']:.4f})")
    save = r["ckpt_seconds"][0]["save"]
    restore = r["ckpt_seconds"][1]["restore"]
    tps = 16 * 256 * steps / sum(times)
    print(f"[examples X] train_e2e {label} ({cfg.name}, "
          f"{cfg.param_count() / 1e6:.1f}M params, {steps} steps, 2 "
          f"microbatches, bf16 moments): loss {r['first']:.3f} -> "
          f"{r['last']:.3f}, held-out ppl {r['ppl']:.2f}, resumed at "
          f"{r['resumed']}, verdict {'OK' if r['ok'] else 'WARN'}; "
          f"{tps:,.0f} tokens/s over the steps (median step "
          f"{1e3 * sorted(times)[len(times) // 2]:.1f} ms), wall "
          f"{wall:.1f}s, peak {peak:.2f} GB, save {save:.3f}s, restore "
          f"{restore:.3f}s")
    return dict(r, tokens_s=tps, peak_gb=peak, wall=wall)


def examples_phase_x(dev, smi: str) -> dict:
    """Phase X: each example of `examples_torch/` through the function
    its `main` calls, on the card, counters reset just before each and
    read just after; the card's results held to the same function on
    the CPU; and K1, K2 and K7 at the examples' shapes against their
    plain versions. Returns the counts and kernel records."""
    import torch
    from repro_torch.core.qlinear import quantize_params
    t_phase = time.perf_counter()
    fixture, quickstart, ptq, sq, e2e = _x_import()
    out = {"counts": {}, "k": {}}
    lap = [t_phase]               # each example's seconds, records in

    def took_since() -> float:
        lap.append(time.perf_counter())
        return lap[-1] - lap[-2]
    print(f"[examples X] {smi.splitlines()[0]}")

    # quickstart: K1 fp, 64 x 256 @ 256 x 512
    x, a = quickstart.inputs()
    reset_counts()
    qs = quickstart.report(x, a, device=dev)
    counts = read_counts()
    qs_cpu = quickstart.report(x, a, device="cpu")
    if counts["ovp_matmul[fp]"] != 1 or qs["kernel_err"] >= 1e-4:
        fail(f"quickstart: K1 launches {counts['ovp_matmul[fp]']} (want "
             f"1), kernel vs oracle {qs['kernel_err']:.2e} (tol 1e-4)")
    if (qs["packed_bytes"], qs["victim"]) != (qs_cpu["packed_bytes"],
                                             qs_cpu["victim"]):
        fail("quickstart: the card's packed bytes or victim pair differ "
             "from the CPU's")
    out["counts"]["quickstart"] = counts
    print(f"[examples X] quickstart: {qs['kernel']}, kernel vs oracle "
          f"{qs['kernel_err']:.2e} (CPU plain {qs_cpu['kernel_err']:.2e}; "
          f"tol 1e-4), SQNR {qs['sqnr_db']:.3f} dB (CPU "
          f"{qs_cpu['sqnr_db']:.3f}), 1 K1 launch")
    from repro_torch.core.ovp import ovp_quantize
    from repro_torch.core.quantizer import sigma_init_scale
    xt = torch.as_tensor(x, device=dev)
    wq = ovp_quantize(xt, sigma_init_scale(xt, "int4"), "int4", pair_axis=0)
    gen = torch.Generator(device=dev).manual_seed(33)
    out["k"]["quickstart"] = k1_layer_record(dev, gen, [wq], 64, "int4",
                                             label="k1 quickstart")

    t_qs = took_since()

    # ptq_calibrate: K1 fp / quantize / int8 weights at 2048 rows
    model, params, loader = fixture.trained_lm(device=dev)
    model_c, params_c, loader_c = fixture.trained_lm(device="cpu")
    reset_counts()
    pr = ptq.calibrate_and_eval(model, params, loader)
    counts = read_counts()
    pr_cpu = ptq.calibrate_and_eval(model_c, params_c, loader_c)
    check_counts(counts, "ptq_calibrate", kernels=(
        "ovp_matmul[fp]", "ovp_matmul[quantize]", "ovp_matmul<int8>"))
    for tag, want in pr_cpu["rows"].items():
        if abs(pr["rows"][tag] - want) > X_ROW_RTOL * want:
            fail(f"ptq_calibrate {tag}: card {pr['rows'][tag]:.6f} vs CPU "
                 f"{want:.6f} (rtol {X_ROW_RTOL})")
    if (pr["ok"], pr["worst"], pr["promoted"]) != \
            (pr_cpu["ok"], pr_cpu["worst"], pr_cpu["promoted"]):
        fail(f"ptq_calibrate: card verdict/sites {pr['ok']} {pr['worst']} "
             f"{pr['promoted']} vs CPU {pr_cpu['ok']} {pr_cpu['worst']} "
             f"{pr_cpu['promoted']}")
    out["counts"]["ptq"] = counts
    print(f"[examples X] ptq_calibrate: rows (card / CPU, rtol "
          f"{X_ROW_RTOL}) " + ", ".join(
              f"{k} {v:.4f} / {pr_cpu['rows'][k]:.4f}"
              for k, v in pr["rows"].items())
          + f"; scales {pr['scales']}; promoted {pr['promoted']}; verdict "
          f"{'OK' if pr['ok'] else 'DEGRADED'} on the card and the CPU "
          f"(the reference's on the committed 30-step weights: DEGRADED); "
          f"K1 launches fp {counts['ovp_matmul[fp]']}, quantize "
          f"{counts['ovp_matmul[quantize]']}, int8 weights "
          f"{counts['ovp_matmul<int8>']}")
    rows = fixture.LM_BATCH * fixture.LM_SEQ
    w4_layer = quantize_params(params, ptq.W4)["layers"][0]
    for mode in ("fp", "quantize"):
        out["k"][f"ptq {mode}"] = k1_layer_record(
            dev, gen, layer_linears(w4_layer), rows, "int4", mode,
            label=f"k1 x eval {mode}")
    prog = ptq.sensitivity(model, params)[3]
    w8_layer = quantize_params(params, prog)["layers"][0]
    w8 = [w for w in layer_linears(w8_layer) if w.normal_dtype == "int8"]
    out["k"]["ptq int8"] = k1_layer_record(dev, gen, w8, rows, "int8",
                                           label="k1 x eval int8")

    t_ptq = took_since()

    # serve_quantized in its four modes: K1 by weight dtype, K2 by cache
    # dtype, K7 on packed caches; tokens equal to the CPU engines'
    for mode, flags in X_MODES.items():
        reset_counts()
        sr = sq.serve(model, params, X_REQUESTS, X_NEW, **flags)
        counts = read_counts()
        sr_cpu = sq.serve(model_c, params_c, X_REQUESTS, X_NEW, **flags)
        label = f"serve_quantized {mode}"
        check_counts(counts, label, kernels=("decode_attn",))
        if (sr["outs_fp"], sr["outs_q"]) != (sr_cpu["outs_fp"],
                                             sr_cpu["outs_q"]):
            bad = [u for u in sr["outs_q"]
                   if sr["outs_q"][u] != sr_cpu["outs_q"].get(u)
                   or sr["outs_fp"][u] != sr_cpu["outs_fp"].get(u)]
            fail(f"{label}: the card's tokens differ from the CPU "
                 f"engines' in requests {bad}")
        eng = sr["engine_q"]
        n_w8 = check_k1_weight_counts({"engine": eng, "model": eng.model,
                                       "params": sr["qparams"]}, counts,
                                      label)
        want = _x_attn_want(sr["engine_fp"], eng)
        got = {key: counts.get(key, 0) for key in want}
        if got != want or counts["decode_attn"] != sum(want.values()):
            fail(f"{label}: K2 launches {got}, expected {want}")
        k7 = check_encode_counts(eng, counts, label)
        if (k7 > 0) != (mode in ("kv4", "mixed")) or \
                (n_w8 > 0) != (mode in ("w8", "mixed")):
            fail(f"{label}: K7 {k7} / W8 linears {n_w8} for this mode")
        out["counts"][mode] = counts
        print(f"[examples X] {label}: fp32 engine {sr['tps_fp']:.1f} "
              f"tok/s | olive engine {sr['tps_q']:.1f} tok/s (wall, "
              f"captured steps, {X_REQUESTS} requests x {X_NEW} tokens, "
              f"graph builds in); agreement {100 * sr['agree']:.1f}% "
              f"(CPU {100 * sr_cpu['agree']:.1f}%), verdict "
              f"{'OK' if sr['ok'] else 'DEGRADED'} (CPU "
              f"{'OK' if sr_cpu['ok'] else 'DEGRADED'}); tokens equal to "
              f"the CPU engines'; weights {sr['fp_bytes']:,} -> "
              f"{sr['q_bytes']:,} bytes; K1 int4 "
              f"{counts['ovp_matmul<int4>']} int8 "
              f"{counts['ovp_matmul<int8>']}, K2 {got}, K7 {k7}")
        if sr["ok"] != sr_cpu["ok"]:
            fail(f"{label}: verdict differs from the CPU's")
        if mode == "w4":
            w4_lin = layer_linears(sr["qparams"]["layers"][0])
    out["k"]["serve fp"] = k1_layer_record(dev, gen, w4_lin, 4, "int4",
                                           label="k1 x serve")
    out["k"]["k2"] = k2_x_records(dev, model.cfg, 4, 192)
    out["k"]["k7"] = k7_x_record(dev, 4 * model.cfg.n_kv_heads,
                                 model.cfg.head_dim)
    del model, params, model_c, params_c, sr, sr_cpu, eng
    t_serve = took_since()

    # train_e2e: the default e2e-20m run, then e2e-100m cut for time
    small = _x_train(dev, e2e, e2e.SMALL, X_SMALL_STEPS, "default")
    if not small["ok"]:
        fail("train_e2e default: the loss did not fall under 0.7 x the "
             "first step's")
    big = _x_train(dev, e2e, e2e.BIG, X_BIG_STEPS, "--model-100m")
    print(f"[examples X] train_e2e --model-100m cut: {X_BIG_STEPS} of its "
          f"200 steps (--steps {X_BIG_STEPS}), for time")
    out["train"] = {"small": small, "big": big}
    t_train = took_since()
    took = time.perf_counter() - t_phase
    print(f"[examples X] phase took {took:.1f}s (quickstart {t_qs:.1f}s, "
          f"ptq_calibrate {t_ptq:.1f}s, serve_quantized {t_serve:.1f}s, "
          f"train_e2e {t_train:.1f}s; each with its CPU twin and kernel "
          f"records)")
    out["took"] = took
    return out


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
    # phase P5's dry run (CPU only) runs beside the card's phases
    dry_job = start_dryrun()

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
    k7_recs, k7_main = k7_phase(dev)
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
    # what phase O holds its two ranks to, before phases A-D are freed
    mesh_ref = mesh_reference(res, res_c)
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
    k5_wide = k5_wide_phase(dev)
    free_device_memory()
    runs_f = serve_phase_f(dev, card)
    serve_phase_g(dev, card)
    # calibration at full width, streamed
    runs_h = serve_phase_h(dev, card, runs_f[(H_DENSE, False)]["peak_gb"],
                           runs_e["slab"]["peak_gb"])
    # the hybrid family, the earlier models freed
    free_device_memory()
    run_i = serve_phase_i(dev, card)
    # the xLSTM family, the earlier models freed
    free_device_memory()
    run_j = serve_phase_j(dev, card)
    # the encoder-decoder and the VLM frontend, the earlier models freed
    free_device_memory()
    run_k = serve_phase_k(dev, card)
    free_device_memory()
    run_l = serve_phase_l(dev, card)
    # the training slice, the earlier models freed
    free_device_memory()
    run_m = train_phase_m(dev, card)
    # the tooling: the analysis passes, their kernel cases on the card,
    # the sanitizer at full width and in a child process
    free_device_memory()
    run_n = tooling_phase_n(dev, card)
    # serving on a mesh: two ranks sharing the card over gloo
    free_device_memory()
    run_o = serve_phase_o(dev, card, mesh_ref)
    # training on a mesh: two ranks sharing the card over gloo, the
    # trained weights served, and the dry run of the production meshes
    free_device_memory()
    run_p = train_phase_p(dev, card, dry_job)
    # the four examples (examples_torch/), the earlier models freed
    free_device_memory()
    run_x = examples_phase_x(dev, card)

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
    # K5 at the widths phase H serves: launches from its runs, by weight
    k5_src = "src/repro/kernels/ovp_matmul.py:263"
    counts_h = {arch: run["counts"] for arch, run in runs_h.items()}
    kernels += [row(name, k5_src, "ovp_matmul.cu", launches,
                    k5_wide[key]["max_abs_err"], k5_wide[key])
                for name, key, launches in (
                    (f"ovp_matmul[static]@{H_DENSE}", "qwen2-7b int4",
                     counts_h[H_DENSE]["ovp_matmul<int4>"]),
                    (f"ovp_matmul[static]<int8>@{H_DENSE}", "qwen2-7b int8",
                     counts_h[H_DENSE]["ovp_matmul<int8>"]),
                    (f"ovp_matmul[static]@{MOE_ARCH} attn", "moe attn",
                     counts_h[MOE_ARCH]["ovp_matmul[static]"]))]
    # the hybrid family: launches from phase I's run (K1 split by layer
    # type: 8 a rglru layer, 7 a local one, per forward call)
    counts_i = run_i["counts"]
    cfg_i = get_config(HYBRID_ARCH)
    n_local = sum(b == "local_attn" for b in
                  (cfg_i.block_pattern[i % len(cfg_i.block_pattern)]
                   for i in range(cfg_i.n_layers)))
    forwards_i = counts_i["ovp_matmul[fp]"] \
        // HYBRID_STEP_LAUNCHES["ovp_matmul[fp]"]
    k7_i = next(r for r in k7_recs if r["label"] == "KV write I"
                and r["dtype"] == "float32")
    kernels += [
        row(f"ovp_matmul[fp]@{HYBRID_ARCH} rglru", k1_src, "ovp_matmul.cu",
            8 * (cfg_i.n_layers - n_local) * forwards_i,
            run_i["k1"]["rglru"]["max_abs_err"], run_i["k1"]["rglru"]),
        row(f"ovp_matmul[fp]@{HYBRID_ARCH} local_attn", k1_src,
            "ovp_matmul.cu", 7 * n_local * forwards_i,
            run_i["k1"]["local_attn"]["max_abs_err"],
            run_i["k1"]["local_attn"]),
        row(f"decode_attn@{HYBRID_ARCH}",
            "src/repro/kernels/decode_attn.py:358", "decode_attn.cu",
            counts_i["decode_attn"], run_i["k2"]["max_abs_err"],
            run_i["k2"]),
        row(f"decode_attn@{HYBRID_ARCH} ring",
            "src/repro/kernels/decode_attn.py:358", "decode_attn.cu",
            run_i["ring_launches"], run_i["k2_ring"]["max_abs_err"],
            run_i["k2_ring"]),
        row(f"ovp_encode@{HYBRID_ARCH}", "src/repro/kernels/ovp_encode.py:59",
            "ovp_encode.cu", counts_i["ovp_encode"], 0.0, k7_i)]
    # the xLSTM family: launches from phase J's run (K1 split by layer
    # type: 5 an mLSTM layer, 6 an sLSTM one, per forward call)
    counts_j = run_j["counts"]
    forwards_j = counts_j["ovp_matmul[fp]"] \
        // XLSTM_STEP_LAUNCHES["ovp_matmul[fp]"]
    n_periods = get_config(XLSTM_ARCH).n_layers // 2
    kernels += [
        row(f"ovp_matmul[fp]@{XLSTM_ARCH} {what}", k1_src, "ovp_matmul.cu",
            K1_PER_LAYER[what] * n_periods * forwards_j,
            run_j["k1"][what]["max_abs_err"], run_j["k1"][what])
        for what in ("mlstm", "slstm")]
    # the encoder-decoder (phase K's Model.forward run): the decoder's K1
    # launches of its decode steps, the frontend's and encoder's K1
    # launches of its encoder run alone, and the K2 launches of its
    # decode steps over the fp32 cross caches; the VLM (phase L's launcher
    # runs): K1, K2 from the slab run, K3 and K4 from the paged run
    rec_k, runs_l = run_k["records"], run_l["runs"]
    attn_l = run_l["attn"]
    kernels += [
        row(f"ovp_matmul[fp]@{ENCDEC_ARCH} decoder", k1_src,
            "ovp_matmul.cu", run_k["decode"]["ovp_matmul[fp]"],
            rec_k["decoder"]["max_abs_err"], rec_k["decoder"]),
        row(f"ovp_matmul[fp]@{ENCDEC_ARCH} encoder prefill", k1_src,
            "ovp_matmul.cu", run_k["encode"]["ovp_matmul[fp]"],
            rec_k["encoder"]["max_abs_err"], rec_k["encoder"]),
        row(f"decode_attn@{ENCDEC_ARCH} cross",
            "src/repro/kernels/decode_attn.py:358", "decode_attn.cu",
            run_k["decode"]["decode_attn<float32>"],
            rec_k["cross"]["max_abs_err"], rec_k["cross"]),
        row(f"ovp_matmul[fp]@{VLM_ARCH}", k1_src, "ovp_matmul.cu",
            runs_l[False]["counts"]["ovp_matmul[fp]"],
            runs_l[False]["k1"]["max_abs_err"], runs_l[False]["k1"]),
        row(f"decode_attn@{VLM_ARCH}", "src/repro/kernels/decode_attn.py:358",
            "decode_attn.cu", runs_l[False]["counts"]["decode_attn"],
            attn_l["k2"][1], attn_l["k2"][2]),
        row(f"paged_decode_attn@{VLM_ARCH}",
            "src/repro/kernels/decode_attn.py:404", "decode_attn.cu",
            runs_l[True]["counts"]["paged_decode_attn"], attn_l["k3"][1],
            attn_l["k3"][2]),
        row(f"prefill_attn@{VLM_ARCH}",
            "src/repro/kernels/prefill_attn.py:170", "prefill_attn.cu",
            runs_l[True]["counts"]["prefill_attn"], attn_l["k4"][1],
            attn_l["k4"][2])]
    # the training slice's hand-off (phase M): the trained weights served
    # at phase A's shapes, so phase A's records; launches from phase M
    counts_m = run_m["counts"]
    kernels += [
        row(f"ovp_matmul[fp]@{TRAIN_ARCH} trained", k1_src, "ovp_matmul.cu",
            counts_m["ovp_matmul[fp]"], k1_err, k1_main["fp"], k1_by),
        row(f"decode_attn@{TRAIN_ARCH} trained",
            "src/repro/kernels/decode_attn.py:358", "decode_attn.cu",
            counts_m["decode_attn"], k2_err, k2_main),
        row(f"ovp_encode@{TRAIN_ARCH} trained",
            "src/repro/kernels/ovp_encode.py:59", "ovp_encode.cu",
            counts_m["ovp_encode"], 0.0, k7_main)]
    # the tooling (phase N): each analysis case's one call on the card
    kernels += [row(f"{rec['counter']}@analysis {name}", rec["replaces"],
                    rec["source"], rec["launches"], rec["max_abs_err"], rec)
                for name, rec in run_n["cases"].items()]
    # serving on a mesh (phase O): each shard shape's one check on the
    # card; launches from rank 0's runs, K1 and K6 by shard layout
    o_rank, o_k = run_o["ranks"][0], run_o["kernels"]
    o_qs, o_qp = o_rank["qwen slab"]["counts"], o_rank["qwen paged"]["counts"]
    o_ms, o_mp = o_rank["moe slab"]["counts"], o_rank["moe paged"]["counts"]
    k2_src = "src/repro/kernels/decode_attn.py:358"
    k3_src = "src/repro/kernels/decode_attn.py:404"
    k4_src = "src/repro/kernels/prefill_attn.py:170"
    k7_src = "src/repro/kernels/ovp_encode.py:59"
    kernels += [
        row("ovp_matmul[fp]@tp2 col", k1_src, "ovp_matmul.cu",
            o_qs["shard"]["ovp_matmul[fp]@col"],
            o_k["k1 col"]["max_abs_err"],
            o_k["k1 col"]),
        row("ovp_matmul[fp]@tp2 row", k1_src, "ovp_matmul.cu",
            o_qs["shard"]["ovp_matmul[fp]@row"],
            o_k["k1 row"]["max_abs_err"],
            o_k["k1 row"]),
        row("grouped[fp]@tp2 E64", "src/repro/kernels/ovp_matmul.py:436",
            "ovp_matmul.cu", o_ms["shard"]["grouped[fp]@expert"],
            o_k["k6"]["max_abs_err"],
            o_k["k6"])]
    # the four-rank InternVL2-1B run (its KV sites split by slot: K2
    # declined, 0 launches); rank 0's launches
    o_v = run_o["vlm"][0]["vlm slab"]["counts"]
    kernels += [
        row(f"ovp_matmul[fp]@tp4 {kind}", k1_src, "ovp_matmul.cu",
            o_v["shard"][f"ovp_matmul[fp]@{kind}"],
            o_k[f"k1 tp4 {kind}"]["max_abs_err"], o_k[f"k1 tp4 {kind}"])
        for kind in ("col", "row")] + [
        row("ovp_encode@tp4 slots", "src/repro/kernels/ovp_encode.py:59",
            "ovp_encode.cu", o_v["ovp_encode"], 0.0, o_k["k7 vlm"])]
    for tag, slab, paged in (("Hkv8", o_qs, o_qp), ("Hkv2", o_ms, o_mp)):
        key = "qwen" if tag == "Hkv8" else "moe"
        kernels += [
            row(f"decode_attn@tp2 {tag}", k2_src, "decode_attn.cu",
                slab["decode_attn"], o_k[f"k2 {key}"][1],
                o_k[f"k2 {key}"][2]),
            row(f"paged_decode_attn@tp2 {tag}", k3_src, "decode_attn.cu",
                paged["paged_decode_attn"], o_k[f"k3 {key}"][1],
                o_k[f"k3 {key}"][2]),
            row(f"prefill_attn@tp2 {tag}", k4_src, "prefill_attn.cu",
                paged["prefill_attn"], o_k[f"k4 {key}"][1],
                o_k[f"k4 {key}"][2]),
            row(f"ovp_encode@tp2 {tag}", k7_src, "ovp_encode.cu",
                slab["ovp_encode"], 0.0, o_k[f"k7 {key}"])]
    # training on a mesh (phase P): the mesh-trained weights served at
    # phase A's shapes, so phase A's records; launches from phase P4
    counts_p = run_p["counts"]
    kernels += [
        row(f"ovp_matmul[fp]@{TRAIN_ARCH} mesh-trained", k1_src,
            "ovp_matmul.cu", counts_p["ovp_matmul[fp]"], k1_err,
            k1_main["fp"], k1_by),
        row(f"decode_attn@{TRAIN_ARCH} mesh-trained", k2_src,
            "decode_attn.cu", counts_p["decode_attn"], k2_err, k2_main),
        row(f"ovp_encode@{TRAIN_ARCH} mesh-trained", k7_src,
            "ovp_encode.cu", counts_p["ovp_encode"], 0.0, k7_main)]
    # the examples (phase X): launches from each example's run
    cx, kx = run_x["counts"], run_x["k"]
    kernels += [
        row("ovp_matmul[fp]@quickstart", k1_src, "ovp_matmul.cu",
            cx["quickstart"]["ovp_matmul[fp]"],
            kx["quickstart"]["max_abs_err"], kx["quickstart"]),
        row("ovp_matmul[fp]@bench-lm eval", k1_src, "ovp_matmul.cu",
            cx["ptq"]["ovp_matmul[fp]"] - cx["ptq"]["ovp_matmul<int8>"],
            kx["ptq fp"]["max_abs_err"], kx["ptq fp"]),
        row("ovp_matmul[quantize]@bench-lm eval", k1_src, "ovp_matmul.cu",
            cx["ptq"]["ovp_matmul[quantize]"],
            kx["ptq quantize"]["max_abs_err"], kx["ptq quantize"]),
        row("ovp_matmul[fp]<int8>@bench-lm eval", k1_src, "ovp_matmul.cu",
            cx["ptq"]["ovp_matmul<int8>"], kx["ptq int8"]["max_abs_err"],
            kx["ptq int8"]),
        row("ovp_matmul[fp]@bench-lm serve", k1_src, "ovp_matmul.cu",
            cx["w4"]["ovp_matmul[fp]"], kx["serve fp"]["max_abs_err"],
            kx["serve fp"]),
        row("decode_attn@bench-lm D32", k2_src, "decode_attn.cu",
            cx["kv4"]["decode_attn<int4>"], kx["k2"]["int4"]["max_abs_err"],
            kx["k2"]["int4"]),
        row("decode_attn[fp32 cache]@bench-lm D32", k2_src, "decode_attn.cu",
            cx["w4"]["decode_attn<float32>"],
            kx["k2"]["float32"]["max_abs_err"], kx["k2"]["float32"]),
        row("ovp_encode@bench-lm K32", k7_src, "ovp_encode.cu",
            cx["kv4"]["ovp_encode"], 0.0, kx["k7"])]
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
          "engine's completed requests by bucket). Calibrated at full "
          "width: ovp_matmul[static]@qwen2-7b and [static]<int8>@qwen2-7b "
          "are the 7 launches of one Qwen2-7B layer's decode step at rows "
          "4 (K5: activations at one scale) with int4 / int8 weights, "
          "launches: phase H's auto_mixed run by weight dtype; "
          "ovp_matmul[static]@qwen3-moe-30b-a3b attn the 4 launches of "
          "one attention block, launches from phase H's Qwen3-30B-A3B "
          "run. The hybrid family (phase I, RecurrentGemma-9B): "
          "ovp_matmul[fp]@recurrentgemma-9b rglru / local_attn are the 8 "
          "/ 7 launches of one served layer's decode step at rows 4, "
          "launches: that layer type's share of phase I's K1 launches; "
          "decode_attn@recurrentgemma-9b one launch at the served shape "
          "(B 4, S 256, Hkv 1, G 16, D 256, packed, window 2048, pos 0, "
          "17, 255, 17), launches from phase I; decode_attn@"
          "recurrentgemma-9b ring one launch on the ring check's final "
          "2048-slot packed ring (B 1, window 2048, ring 2048; library: "
          "SDPA under the same mask), launches: that check's KV4 decode "
          "steps; ovp_encode@recurrentgemma-9b one launch of the KV write "
          "(R 4 x K 256, f32, a scale a row), launches from phase I. The "
          "xLSTM family (phase J, xLSTM-350M): ovp_matmul[fp]@xlstm-350m "
          "mlstm / slstm are the 5 / 6 launches of one served layer's "
          "decode step at rows 4 (the sLSTM MLP's N 1364 padded to 1376 "
          "and K 1364), launches: that layer type's share of phase J's "
          "K1 launches. The encoder-decoder (phase K, SeamlessM4T-large-v2 "
          "through Model.forward): ovp_matmul[fp]@seamless-m4t-large-v2 "
          "decoder is the 8 launches of one decoder layer's decode step "
          "at rows 4 (self q, k, v, o; cross q, o; wi, wd), launches: "
          "phase K's 32 decode steps; ... encoder prefill the frontend "
          "projection (K 160) and one encoder layer's 6 launches at the "
          "prefill's 1600 rows (4 x 400 frames), launches: phase K's "
          "encoder run alone (Model.encode, 1 + 6 x 24 expected); "
          "decode_attn@seamless-m4t-large-v2 cross "
          "one launch over a served fp32 cross cache (B 4, S 512, Hkv 16, "
          "D 64, pos = src_len - 1 = 399), launches: phase K's K2 "
          "launches over fp32 caches (the decode_attn<float32> counter). "
          "The VLM (phase L, InternVL2-1B): "
          "ovp_matmul[fp]@internvl2-1b the 7 launches of one served "
          "layer's decode step at rows 4, launches from the slab run; "
          "decode_attn / paged_decode_attn / prefill_attn@internvl2-1b "
          "one launch at Hkv 2, G 7, D 64 (K2 and K3: B 4, S 256, packed, "
          "pos mixed; K4: C 16 at offset 240, packed), launches from the "
          "slab run (K2) and the paged run (K3, K4). Training (phase M, "
          "Qwen1.5-0.5B QAT, then the trained fp32 tree quantized under "
          "olive_serve and served): <kernel>@qwen1.5-0.5b trained carry "
          "phase A's records (the same shapes), launches from phase M's "
          "served run of 4 requests. The tooling (phase N): <kernel>"
          "@analysis <case> is one call of a kernel case of "
          "repro_torch.analysis.kernels at the reference's shape, against "
          "its plain version on the card (plain ms eager), launches from "
          "that call; kv_write_packed is layers.cache_write's two K7 "
          "launches (K and V) of a 4-row decode write. Serving on a mesh "
          "(phase O, two ranks sharing the card over gloo): <kernel>@tp2 "
          "is one rank's shard shape checked once in this process: K1 col "
          "the 5 column slices of a Qwen1.5-0.5B layer (N / 2) and row the "
          "2 row slices (wo 256, wd 704 packed rows), rows 4, rank 0's; "
          "grouped[fp]@tp2 E64 the 3 launches of one Qwen3-30B-A3B layer's "
          "decode step over rank 0's 64 experts with its slice of a top-8 "
          "fill, warm L2; K2/K3/K4@tp2 Hkv8 at Hkv 8, G 1, D 64, Hkv2 at "
          "Hkv 2, G 8, D 128 (K4: C 16); ovp_encode@tp2 the KV write on "
          "the local heads (R 32 x K 64; R 8 x K 128); launches from rank "
          "0's phase O runs (K1 col / row: 5 / 2 sevenths of its K1 "
          "launches). Training on a mesh (phase P: Qwen1.5-0.5B QAT on "
          "two ranks, its last checkpoint (step 2) restored and served "
          "under olive_serve): <kernel>@qwen1.5-0.5b mesh-trained carry "
          "phase A's records (the same shapes), launches from phase P4's "
          "served "
          "run of 4 requests; the mesh's training step itself reaches no "
          "TPU kernel's counterpart. The examples (phase X, the bench-lm "
          "fixture: d 128, Hkv 2, G 2, D 32, d_ff 384): ovp_matmul[fp]"
          "@quickstart one launch at 64 x 256 @ 256 x 512 (a tensor scale), "
          "launches from quickstart's run; ...@bench-lm eval is one "
          "layer's 7 launches at the eval's 2048 rows (16 x 128 tokens) "
          "with int4 weights in fp / quantize mode, [fp]<int8> the "
          "auto_mixed program's W8 linear of a layer (wk, K 128 -> N 64) "
          "at 2048 rows, launches from ptq_calibrate's run (fp: its int4 "
          "fp-mode launches); ovp_matmul[fp]@bench-lm serve one layer's 7 "
          "launches at rows 4, launches from serve_quantized's default run "
          "(both engines; the fp32 engine launches none); decode_attn"
          "@bench-lm D32 one launch at B 4, S 192, Hkv 2, G 2, D 32, pos "
          "(20, 35, 46, 11), packed (launches: the --kv4 run's over packed "
          "caches) and fp32 (the default run's, both engines); ovp_encode"
          "@bench-lm K32 one launch of the KV write (R 8 = 4 slots x 2 "
          "heads, K 32, f32, a scale a row), launches from the --kv4 run; "
          "train_e2e reaches no TPU kernel's counterpart")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
