"""SeamlessM4T-large-v2: encoder-decoder, multimodal [arXiv:2308.11596; hf].

Backbone only, as in the reference: 24 encoder + 24 decoder layers over
stub audio frame embeddings (160-d fbank features -> in-model input
projection). RoPE replaces the original learned positions; GELU MLPs as
in the original.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    head_dim=64,
    qkv_bias=True,
    mlp_kind="gelu",
    block_pattern=("encdec_attn",),
    enc_dec=True,
    n_enc_layers=24,
    frontend="audio",
    frontend_dim=160,
    n_frontend_tokens=0,
    source="arXiv:2308.11596; hf",
)
