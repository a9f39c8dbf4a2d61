"""Architecture configuration schema. Port of `repro/configs/base.py`
(the fields the dense and MoE decoders read, and the parameter count of
those two families; other families come with their layers)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe (the families ported)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_kind: str = "swiglu"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    norm_topk: bool = False
    capacity_factor: float = 1.25
    block_pattern: Tuple[str, ...] = ("attn",)
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256; pad columns are masked
        in the logits."""
        return -(-self.vocab // 256) * 256

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks): the
        reference's per-block table, its rows for the ported blocks."""
        d, hd = self.d_model, self.head_dim
        n_attn_p = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        mlp = (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
        per = {"attn": n_attn_p + mlp,
               "moe": n_attn_p + self.n_experts * 3 * d * self.d_ff
               + d * self.n_experts}
        pattern = self.block_pattern
        return sum(per[pattern[i % len(pattern)]]
                   for i in range(self.n_layers)) \
            + 2 * self.vocab * d                        # embed + head

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/pattern, tiny dimensions (the
        reference's `reduced()` for the dense and MoE families: at most 8
        experts, top-k at most 2)."""
        period = len(self.block_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2 * period, period + self.n_layers % period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
        )
