"""Minitron-8B: width/depth-pruned Nemotron-4 [arXiv:2407.14679; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256000,
    head_dim=128,
    mlp_kind="swiglu",
    block_pattern=("attn",),
    source="arXiv:2407.14679; hf",
)
