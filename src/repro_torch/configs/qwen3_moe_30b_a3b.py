"""Qwen3-30B-A3B: 128-expert top-8 MoE, GQA kv=4, head_dim 128
[hf:Qwen/Qwen3-30B-A3B]. d_ff=768 is the per-expert intermediate size."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab=151936,
    head_dim=128,
    n_experts=128,
    top_k=8,
    norm_topk=True,
    mlp_kind="swiglu",
    block_pattern=("moe",),
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)
