"""PyTorch/CUDA port of the OliVe reproduction (`src/repro/` is the JAX
reference it is tested against).

Subpackages mirror `repro` one for one: `core` (OVP codecs, quantizer,
policies, quantized linear, calibration), `configs`, `backends` (the
`eager` and `cuda` execution backends), `kernels` (hand-written CUDA
kernels for Hopper beside their plain PyTorch versions, sources in
`csrc/`), `models` (the dense decoder), `serve` (the slab and paged
serving engine) and `launch` (the serving CLI). This package imports
torch and numpy only.
"""
