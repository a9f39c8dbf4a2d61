"""Qwen2-7B: GQA with QKV bias [arXiv:2407.10671; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    mlp_kind="swiglu",
    block_pattern=("attn",),
    rope_theta=1e6,
    source="arXiv:2407.10671; hf",
)
