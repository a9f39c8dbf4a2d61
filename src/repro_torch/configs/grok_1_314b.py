"""Grok-1 (314B): 8-expert top-2 MoE [hf:xai-org/grok-1; unverified]. At
W4 it needs about 155 GB, more than one card: the port runs it at smoke
size."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    n_experts=8,
    top_k=2,
    norm_topk=False,
    mlp_kind="swiglu",
    block_pattern=("moe",),
    source="hf:xai-org/grok-1; unverified",
)
