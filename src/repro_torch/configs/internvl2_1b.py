"""InternVL2-1B: InternViT frontend (stub) + Qwen2-0.5B-style backbone
[arXiv:2404.16821; hf]. The caller supplies precomputed 1024-d patch
embeddings (256 tokens); the in-model projector maps them to d_model."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    head_dim=64,
    qkv_bias=True,
    mlp_kind="swiglu",
    block_pattern=("attn",),
    frontend="vit",
    frontend_dim=1024,
    n_frontend_tokens=256,
    rope_theta=1e6,
    source="arXiv:2404.16821; hf",
)
