"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: `ovp_matmul` (K1, the fused OVP matmul) and `decode_attn` (K2,
slab decode attention). Sources live in `repro_torch/csrc/`; `_build`
compiles them with nvcc on first use."""
