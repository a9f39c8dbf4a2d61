"""Architecture and shape configuration schema. Port of
`repro/configs/base.py`: the fields the dense, MoE, hybrid, xLSTM,
encoder-decoder and VLM models read, the accounting the roofline and
the analysis passes read (parameter counts, MoE blocks, which decode
shapes apply), and the four canonical input shapes (`ShapeCfg`)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | hybrid | ssm | moe | vlm | audio
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
    # block pattern (repeating period); tail = n_layers % len(pattern)
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                  # sliding window for local_attn blocks
    d_rnn: int = 0                   # RG-LRU width (0 -> d_model)
    # encoder-decoder
    enc_dec: bool = False
    n_enc_layers: int = 0
    # modality frontend stubs
    frontend: str = ""               # "" | vit | audio
    frontend_dim: int = 0
    n_frontend_tokens: int = 0
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # mLSTM prefill: chunkwise-parallel chunk length (0 or 1: the
    # per-token recurrence)
    mlstm_chunk: int = 64
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

    @property
    def sub_quadratic(self) -> bool:
        """True if decode memory and compute do not grow with a full
        attention cache: every block is recurrent or windowed."""
        return all(bt in ("rglru", "mlstm", "slstm", "local_attn")
                   for bt in self.block_pattern)

    @property
    def has_decoder(self) -> bool:
        return True     # every config decodes (an encoder-decoder too)

    def moe_block_count(self) -> int:
        """Number of MoE blocks in the layer stack."""
        return sum(1 for i in range(self.n_layers)
                   if self.block_pattern[i % len(self.block_pattern)]
                   == "moe")

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks): the
        reference's per-block table, its rows for the ported blocks (an
        RG-LRU block's count leaves out its conv kernel and gate decay,
        as the reference's does; its mLSTM row counts `w_up` at 8d², the
        reference's formula, though the weight is d x 4d; an
        encoder-decoder adds its encoder's attention blocks, and neither
        biases nor the frontend projection are counted, as in the
        reference)."""
        d, hd = self.d_model, self.head_dim
        dr = self.d_rnn or d
        n_attn_p = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        mlp = (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
        per = {"attn": n_attn_p + mlp,
               "local_attn": n_attn_p + mlp,
               "moe": n_attn_p + self.n_experts * 3 * d * self.d_ff
               + d * self.n_experts,
               "rglru": dr * (2 * d + d) + 2 * dr ** 2 + mlp,
               "mlstm": 2 * d * (4 * d) + 3 * (2 * d) ** 2 + 2 * d * d,
               "slstm": 4 * d * d + 3 * d * (d // max(self.n_heads, 1))
               + 2 * d * int(4 * d / 3),
               "encdec_attn": 2 * n_attn_p + mlp}
        pattern = self.block_pattern
        total = sum(per[pattern[i % len(pattern)]]
                    for i in range(self.n_layers))
        if self.enc_dec:
            total += self.n_enc_layers * (n_attn_p + mlp)
        return total + 2 * self.vocab * d               # embed + head

    def active_param_count(self) -> int:
        """Params touched per token (MoE: the top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        inactive = self.moe_block_count() * (self.n_experts - self.top_k) \
            * 3 * self.d_model * self.d_ff
        return self.param_count() - inactive

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/pattern, tiny dimensions (the
        reference's `reduced()`: at most 8 experts, top-k at most 2, a
        window of at most 8, d_rnn 64, 2 encoder layers, a 32-wide
        frontend of 4 tokens)."""
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
            window=min(self.window, 8) if self.window else 0,
            d_rnn=64 if self.d_rnn else 0,
            n_enc_layers=2 if self.enc_dec else 0,
            frontend_dim=32 if self.frontend else 0,
            n_frontend_tokens=4 if self.frontend else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[bool, str]:
    """(runs?, reason if skipped): a 524k-token decode needs a
    sub-quadratic architecture."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention architecture: 524k-token decode is "
                       "O(T) cache / O(T^2) prefill — skipped")
    return True, ""
