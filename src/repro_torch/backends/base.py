"""Backend interface + the canonical activation-quantization rule. Port
of `repro/backends/base.py`.

The activation scale rule lives here, not per backend, so every backend
quantizes activations identically: a static calibrated scale (the
policy's `static_act_scale`, or the caller's) in `act_scale_mode=
"static"`, else the dynamic 3σ rule, ONE scalar per tensor over every
row (`sigma_init_scale` with no axis). `act_scale_stats()` counts how
each quantized matmul resolved its scale ("static" / "dynamic").

`DECLINE_CODES` copies the reference registry, so dispatch counts
compare across the two packages.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import torch

from repro_torch.analysis import sanitize
from repro_torch.core.calibration import MissingStaticScaleError
from repro_torch.core.ovp import QuantizedTensor, ovp_quantize
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantizer import sigma_init_scale

DECLINE_CODES: Dict[str, Dict[str, str]] = {
    "matmul": {
        "pair_axis_not_reduction": "weight pairs not packed along K",
        "lhs_rank_lt_2": "2-D weight needs an (…, M, K) lhs",
        "grouped_lhs_rank_lt_3": "stacked weight needs an (…, E, C, K) lhs",
        "grouped_lhs_expert_mismatch": "lhs expert dim != weight stack dim",
        "stacked_rank_gt_3": ">3-D weight stacks are not kernelized",
    },
    "sharded": {
        "shard_no_mesh": "no mesh configured (configure_mesh)",
        "shard_n_indivisible":
            'column-parallel N not divisible by the "model" axis',
        "shard_k_indivisible":
            "row-parallel K does not split into whole outlier-victim "
            "pairs per shard",
        "shard_expert_indivisible":
            'grouped stack\'s E not divisible by the "model" axis',
        "shard_mixed_expert_group":
            "ragged MixedExpertQuant groups cannot split E evenly",
        "shard_hkv_lt_axis": 'fewer KV heads than "model" shards',
        "shard_hkv_indivisible": 'Hkv not divisible by the "model" axis',
    },
    "decode_attn": {
        "decode_q_tokens_gt_1": "decode kernel serves one query token only",
        "decode_no_kv_cache": "cache dict carries no k / k_data leaf",
        "decode_empty_cache": "zero-length cache (nothing to attend)",
        "decode_head_dim_odd":
            "even/odd plane split needs an even head dim",
        "paged_no_pool": "block_table present but no pool k/k_data",
        "paged_table_rank": "block table is not a 2-D integer array",
        "paged_page_misaligned": "page size not an even int >= 2",
    },
    "prefill_attn": {
        "prefill_not_paged": "cache carries no block_table (slab layout)",
        "prefill_no_stage": "no stage_k/stage_v raw-K/V staging leaves",
        "prefill_batch_gt_1": "kernel serves one request row at a time",
        "prefill_stage_misaligned":
            "stage length not a whole number of pages, or the table "
            "backs fewer pages than tiles",
    },
}

ALL_DECLINE_CODES = frozenset(
    code for family in DECLINE_CODES.values() for code in family)

DISPATCH_MARKERS: Tuple[str, ...] = ("[stacked]", "[decode_attn]",
                                     "[prefill_attn]")
# act_scale_stats() keys: A-side scale resolution per quantized matmul
ACT_SCALE_KEYS: Tuple[str, ...] = ("static", "dynamic")


def decline(code: Optional[str]) -> Optional[str]:
    """Validate-and-return for decline codes (None = served)."""
    if code is not None and code not in ALL_DECLINE_CODES:
        raise KeyError(f"unregistered decline code {code!r}; add it to "
                       f"backends.base.DECLINE_CODES")
    return code


def dispatch_key(backend_name: str, reason: Optional[str] = None,
                 marker: str = "") -> str:
    """One `dispatch_stats()` counter key from the registered vocabulary."""
    if marker and marker not in DISPATCH_MARKERS:
        raise KeyError(f"unregistered dispatch marker {marker!r}")
    key = backend_name if reason is None \
        else f"{backend_name}->fallback:{decline(reason)}"
    return key + marker


def act_normal_dtype(policy: QuantPolicy) -> str:
    """4-bit activations use the policy's normal dtype, 8-bit int8."""
    return policy.a_normal_dtype if policy.abits == 4 else "int8"


_ACT_SCALE_STATS: collections.Counter = collections.Counter()


def reset_act_scale_stats() -> None:
    _ACT_SCALE_STATS.clear()


def act_scale_stats() -> Dict[str, int]:
    """Counter keyed "static" / "dynamic": how each quantized matmul
    resolved its activation scale. A run served on a calibration
    artifact shows `dynamic == 0`."""
    return dict(_ACT_SCALE_STATS)


def record_act_scale(kind: str) -> None:
    if kind not in ACT_SCALE_KEYS:
        raise KeyError(f"unregistered act-scale key {kind!r}; "
                       f"options: {ACT_SCALE_KEYS}")
    _ACT_SCALE_STATS[kind] += 1


def resolve_act_scale(x: torch.Tensor, policy: QuantPolicy,
                      static_scale: Optional[torch.Tensor] = None):
    """(scale, normal_dtype) for the A side of one matmul.

    static mode: the caller's `static_scale` (per-tensor or per-row)
    wins, else the policy's calibrated `static_act_scale`; a miss raises
    rather than paying the dynamic std every step. A scalar static scale
    comes back as a Python float (the one word a kernel takes by value),
    a tensor one as an fp32 tensor on `x`'s device. Dynamic mode: the 3σ
    rule, one population-std scalar over the whole tensor."""
    nd = act_normal_dtype(policy)
    if policy.act_scale_mode == "static":
        if static_scale is None:
            static_scale = policy.static_act_scale
        if static_scale is None:
            raise MissingStaticScaleError(["<unresolved site>"])
        record_act_scale("static")
        if isinstance(static_scale, (int, float)):
            return float(static_scale), nd
        return torch.as_tensor(static_scale, dtype=torch.float32,
                               device=x.device), nd
    record_act_scale("dynamic")
    return sigma_init_scale(x.to(torch.float32), nd), nd


def quantize_activation(x: torch.Tensor, policy: QuantPolicy,
                        static_scale: Optional[torch.Tensor] = None
                        ) -> QuantizedTensor:
    """Materialized OVP activation tensor (the eager path)."""
    s, nd = resolve_act_scale(x, policy, static_scale)
    return ovp_quantize(x, s, nd, pair_axis=-1)


def torch_dtype(name: str) -> torch.dtype:
    """torch dtype for a policy `compute_dtype` string."""
    return getattr(torch, name)


def encode_rows(encode, x: torch.Tensor, scale: torch.Tensor
                ) -> torch.Tensor:
    """Apply an (R, K) encoder `encode(x, scale=)` to x (…, D) with one
    scale per row (…): the leading dims fold into rows. Under
    REPRO_SANITIZE=1 the scales and the rows are checked first (on the
    card as device asserts in front of K7)."""
    if sanitize.enabled():
        sanitize.check((scale > 0) & torch.isfinite(scale),
                       "encode_kv: the KV scale must be positive and finite")
        sanitize.check(torch.isfinite(x), "encode_kv: non-finite K/V rows")
    d = x.shape[-1]
    out = encode(x.reshape(-1, d), scale=scale.reshape(-1))
    return out.reshape(*x.shape[:-1], d // 2)


class QuantizedMatmulBackend:
    """One way to execute x @ dequant(w) under a policy, plus decode
    attention and paged cache-write prefill. `decline_reason` returning
    a code makes the registry fall back to `fallback` (one hop)."""

    name: str = "?"
    fallback: str = "eager"

    def decline_reason(self, x, w: QuantizedTensor,
                       policy: QuantPolicy) -> Optional[str]:
        return None

    def mixed_expert_decline_reason(self, x, w,
                                    policy: QuantPolicy) -> Optional[str]:
        """None when this backend serves each homogeneous group of a
        per-expert `MixedExpertQuant`; a code routes the whole stack to
        `fallback`."""
        return None

    def matmul(self, x: torch.Tensor, w: QuantizedTensor,
               policy: QuantPolicy,
               act_scale: Optional[torch.Tensor] = None,
               fill: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x @ dequant(w). `fill` (…, E), stacked weights only: the
        filled capacity rows of each (…, expert); rows past it may be
        left unwritten, or computed."""
        raise NotImplementedError

    def decode_attn_decline_reason(self, q, cache) -> Optional[str]:
        return None

    def decode_attention(self, q: torch.Tensor, cache, pos: torch.Tensor,
                         *, window: int = 0, ring: int = 0) -> torch.Tensor:
        """Base = the dense path (whole-cache dequantize, then einsum;
        paged caches gather through the block table first)."""
        from repro_torch.kernels import decode_attn
        return decode_attn.xla_decode_attention(q, cache, pos,
                                                window=window, ring=ring)

    def encode_kv(self, x: torch.Tensor, scale: torch.Tensor
                  ) -> torch.Tensor:
        """One cache write's new K or V rows x (…, D) at their per-row
        scale (…) -> (…, D/2) packed int4 OVP bytes of x / scale. Base =
        the plain torch ops (`layers._quant_kv_token`'s encode)."""
        from repro_torch.kernels import ovp_encode
        return encode_rows(ovp_encode.ovp_encode_plain, x, scale)

    # True when `prefill_attention` runs the fused cache-write prefill
    # kernel (K4); the base implementation is the dense twin.
    fuses_prefill_attention: bool = False

    def prefill_attn_decline_reason(self, q, cache) -> Optional[str]:
        """None when this backend serves paged cache-write prefill over
        this (q, cache) layout; the dense base path needs only the paged
        layout itself (block_table + stage leaves)."""
        if cache is None or "block_table" not in cache:
            return decline("prefill_not_paged")
        if "stage_k" not in cache or "stage_v" not in cache:
            return decline("prefill_no_stage")
        return None

    def prefill_attention(self, q: torch.Tensor, cache,
                          positions: torch.Tensor):
        """Prefill one chunk of one request over a PAGED cache: causal
        attention of q (1, C, H, D) against the raw stage, plus
        quantize-and-write of the whole stage onto its block-table pages
        (in place). Returns (out, cache). Base = the dense twin."""
        from repro_torch.kernels import prefill_attn
        return prefill_attn.xla_prefill_attention(q, cache, positions)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"
