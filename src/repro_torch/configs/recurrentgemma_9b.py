"""RecurrentGemma-9B (Griffin): RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427; unverified].

38 layers = 12 × (rglru, rglru, local_attn) + 2 rglru tail. MQA (kv=1),
head_dim 256, window 2048.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    mlp_kind="swiglu",
    block_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    d_rnn=4096,
    source="arXiv:2402.19427; unverified",
)
