"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: `ovp_matmul` (the fused OVP matmul: K1 in its fp, quantize,
codes4 and codes8 modes, K5 in its static mode; and K6, its grouped
per-expert twin over stacked MoE weights), `ovp_encode` (K7, the
OVP encoder), `decode_attn` (K2 slab and K3 paged decode attention) and
`prefill_attn` (K4, fused cache-write prefill over a paged cache);
`ops` is the kernel API the reference's `kernels/ops.py` offers. Sources
live in `repro_torch/csrc/`; `_build` compiles them with nvcc on first
use."""
