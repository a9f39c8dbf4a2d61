"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: `ovp_matmul` (K1, the fused OVP matmul), `decode_attn` (K2 slab
and K3 paged decode attention) and `prefill_attn` (K4, fused cache-write
prefill over a paged cache). Sources live in `repro_torch/csrc/`;
`_build` compiles them with nvcc on first use."""
