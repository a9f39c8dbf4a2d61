"""Yi-6B: llama-architecture GQA [arXiv:2403.04652; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    head_dim=128,
    mlp_kind="swiglu",
    block_pattern=("attn",),
    rope_theta=5e6,
    source="arXiv:2403.04652; hf",
)
