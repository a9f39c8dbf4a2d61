"""The work one step needs, counted from shapes and from the served tree's
and caches' own tensors: the port's counterpart of the reference's
`roofline/hlo_stats.py`, which counted a compiled XLA program. The count
is of what the step must do whatever implements it, never of what the
port's kernels happen to execute (a padded column tile, a re-read
weight slice, a zero-fill are not in it), so a kernel that does less
moves its time and not this count.

Bytes: each tensor the step reads is counted once and each it writes
once.
- Weights: every leaf of every layer the step reaches, with its codes,
  scales and biases (`tree_bytes`); of an MoE's expert stacks only the
  routed experts (`experts_touched`, by default min(E, routed tokens),
  each routed token on its own expert); an encoder-decoder's cross K/V
  projections (`xattn/wk`, `wv`, `bk`, `bv`) are read by the prefill
  only, and the encoder and frontend run in the prefill only.
- The embedding rows the tokens read, the final norm and the head (a
  tied head reads the whole table), and the logits written.
- KV caches: each row's live slots read (packed codes and scales, or
  fp), bounded by the cache's slots (a ring) and the window, plus the
  slots written (one a decode row; a prefill writes its tokens and
  reads what earlier chunks wrote). A paged cache's block table is read
  once. A cross cache's first `src_len` slots are read by a decode
  step and written by the prefill.
- Recurrent state (RG-LRU, mLSTM, sLSTM): every leaf read and written.

FLOPs: 2 x rows x K x N for every linear reached (an expert stack's
routed rows, rows x top_k; an sLSTM's block-diagonal recurrent matrices
H x dh x dh), plus attention's QK and PV, 4 x H x D a query for each
live key (causal in a prefill; the encoder's self-attention is causal,
as the model computes it). Norms, activations, rotary embeddings, the
recurrences' elementwise state updates and the softmax are not counted.
`model_flops` is 2 x `active_param_count` x tokens for a decode or
prefill step and 6 x N x D for a training step, the reference's
`model_flops_global`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.ovp import MixedExpertQuant, QuantizedTensor
from repro_torch.core.qlinear import ENCODER, tree_paths

_KV_KEYS = ("k", "v", "k_data", "v_data", "k_scl", "v_scl")
_CROSS_PROJ = ("wk", "wv", "bk", "bv")     # xattn leaves a decode skips
_RECURRENT = ("rec", "mlstm", "slstm")      # state sites of a cache layer


@dataclasses.dataclass
class StepStats:
    """One step's work: `bytes` and `flops` summed over `parts` (bytes)
    and `flop_parts`; `tokens` the tokens it processes; `model_flops`
    the model FLOPs it stands for; `arg_bytes` the resident state it
    reaches (weights and caches as served)."""
    kind: str                   # decode | prefill | train
    tokens: int
    parts: Dict[str, float]
    flop_parts: Dict[str, float]
    model_flops: float
    arg_bytes: float = 0.0

    @property
    def bytes(self) -> float:
        return float(sum(self.parts.values()))

    @property
    def flops(self) -> float:
        return float(sum(self.flop_parts.values()))

    def scaled(self, factor: float) -> "StepStats":
        """This count times `factor` (a mean over steps)."""
        return dataclasses.replace(
            self, tokens=self.tokens * factor,
            parts={k: v * factor for k, v in self.parts.items()},
            flop_parts={k: v * factor for k, v in self.flop_parts.items()},
            model_flops=self.model_flops * factor,
            arg_bytes=self.arg_bytes)


def mean(stats: Sequence[StepStats]) -> StepStats:
    """The mean of several steps' counts (a profiled window)."""
    out = stats[0].scaled(1.0)
    for s in stats[1:]:
        for d, src in ((out.parts, s.parts), (out.flop_parts, s.flop_parts)):
            for k, v in src.items():
                d[k] = d.get(k, 0.0) + v
        out.tokens += s.tokens
        out.model_flops += s.model_flops
    return out.scaled(1.0 / len(stats))


def leaf_bytes(leaf) -> int:
    """Stored bytes of one params or cache leaf: a quantized leaf's codes
    and scales, a mixed expert stack's groups, a tensor's elements."""
    if isinstance(leaf, (QuantizedTensor, MixedExpertQuant)):
        return leaf.nbytes()
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return 0


def tree_bytes(tree) -> int:
    """Bytes of every leaf of a params or cache tree."""
    return sum(leaf_bytes(leaf) for _, leaf in tree_paths(tree))


def _is_linear(path: str, leaf) -> bool:
    """A matmul weight: named as the model names its linears (w*, and an
    sLSTM's recurrent r_* blocks), not a conv kernel."""
    name = path.split("/")[-1]
    if name == "conv_kernel" or not isinstance(
            leaf, (QuantizedTensor, MixedExpertQuant, torch.Tensor)):
        return False
    return len(leaf.shape) >= 2 and (name.startswith(("w", "r_"))
                                     or name == "kernel")


def _is_expert(path: str) -> bool:
    return "/experts/" in f"/{path}"


def _layer_work(layer, rows: float, cfg, decode: bool,
                experts_touched: Optional[int]):
    """(weight bytes, linear FLOPs) of one layer's params over `rows`
    tokens."""
    n_bytes = flops = 0.0
    for path, leaf in tree_paths(layer):
        if decode and path.startswith("xattn/") \
                and path.split("/")[-1] in _CROSS_PROJ:
            continue
        b = leaf_bytes(leaf)
        if _is_expert(path):
            e = leaf.shape[0]
            touched = experts_touched if experts_touched is not None \
                else min(e, int(rows * cfg.top_k))
            n_bytes += b * min(touched, e) / e
            if _is_linear(path, leaf):
                flops += 2.0 * rows * cfg.top_k * leaf.shape[-2] \
                    * leaf.shape[-1]
            continue
        n_bytes += b
        if _is_linear(path, leaf):
            k_n = 1
            for dim in leaf.shape:
                k_n *= dim
            flops += 2.0 * rows * k_n
    return n_bytes, flops


def _slot_bytes(site) -> int:
    """Bytes of one token slot of a KV site (every K/V leaf: packed codes
    and scales, or fp rows; a slab (B, S, ...) or a pool (P, ps, ...))."""
    total = 0
    for key in _KV_KEYS:
        if key in site:
            leaf = site[key]
            per = 1
            for dim in leaf.shape[2:]:
                per *= dim
            total += per * leaf.element_size()
    return total


def _kv_slots(site) -> int:
    leaf = site["k"] if "k" in site else site["k_data"]
    if "block_table" in site:
        return site["block_table"].shape[1] * leaf.shape[1]
    return leaf.shape[1]


def _head(model, params, rows: float):
    """(bytes, FLOPs) of the final norm and the head over `rows` tokens,
    the logits they write included."""
    cfg = model.cfg
    head = params["embed"]["table"] if cfg.tie_embeddings \
        else params["lm_head"]["w_out"]
    n_bytes = leaf_bytes(head) + tree_bytes(params["final_norm"]) \
        + rows * cfg.padded_vocab * 4
    return n_bytes, 2.0 * rows * cfg.d_model * cfg.padded_vocab


def _embed_rows(params, rows: float) -> float:
    table = params["embed"]["table"]
    return rows * table.shape[1] * table.element_size()


def _new(kind, tokens, parts, flop_parts, model_flops, arg_bytes):
    return StepStats(kind, tokens, {k: float(v) for k, v in parts.items()},
                     {k: float(v) for k, v in flop_parts.items()},
                     float(model_flops), float(arg_bytes))


def decode_step_stats(model, params, caches, pos: Sequence[int], *,
                      src_len: Optional[int] = None,
                      experts_touched: Optional[int] = None) -> StepStats:
    """One decode step of B = len(pos) rows, row b's new token at
    position pos[b] (it attends slots 0..pos[b] and writes slot pos[b]).
    `src_len`: the cross caches' filled slots (default: all);
    `experts_touched`: the experts the step routes to, per MoE layer
    (default min(E, B x top_k))."""
    cfg = model.cfg
    rows = len(pos)
    parts = {"weights": 0.0, "kv_read": 0.0, "kv_write": 0.0,
             "cross_read": 0.0, "state": 0.0}
    flop_parts = {"linears": 0.0, "attention": 0.0}
    for i, layer in enumerate(params["layers"]):
        b, f = _layer_work(layer, rows, cfg, True, experts_touched)
        parts["weights"] += b
        flop_parts["linears"] += f
        site = caches["layers"][i]
        for name, sub in site.items():
            if name in _RECURRENT:
                parts["state"] += 2 * tree_bytes(sub)
                continue
            slots, per = _kv_slots(sub), _slot_bytes(sub)
            if name == "xkv":
                live = [src_len if src_len is not None else slots] * rows
                parts["cross_read"] += sum(live) * per
            else:
                window = cfg.window if model.block_type(i) == "local_attn" \
                    else 0
                live = [min(int(p) + 1, slots, window or slots) for p in pos]
                parts["kv_read"] += sum(live) * per
                parts["kv_write"] += rows * per
                if "block_table" in sub:
                    parts["kv_read"] += leaf_bytes(sub["block_table"][:rows])
            flop_parts["attention"] += 4.0 * cfg.n_heads * cfg.head_dim \
                * sum(live)
    hb, hf = _head(model, params, rows)
    parts["head"] = hb
    parts["embed"] = _embed_rows(params, rows)
    flop_parts["linears"] += hf
    arg = tree_bytes(params) + tree_bytes(caches)
    return _new("decode", rows, parts, flop_parts,
                2.0 * cfg.active_param_count() * rows, arg)


def _causal_keys(t: int, offset: int, window: int = 0) -> int:
    """Keys the T queries at offset..offset+T-1 attend under a causal
    mask (and a window): the sum of min(p, window) over p = offset + 1 ..
    offset + T."""
    lo, hi = offset + 1, offset + t
    if not window or hi <= window:
        return (lo + hi) * t // 2
    if lo >= window:
        return t * window
    return (lo + window) * (window - lo + 1) // 2 + (hi - window) * window


ATTENTION_TYPES = ("attn", "moe", "local_attn", "encdec_attn")


def prefill_step_stats(model, params, caches, tokens: int, *,
                       rows: int = 1, offset: int = 0, frames: int = 0,
                       patches: int = 0,
                       experts_touched: Optional[int] = None) -> StepStats:
    """One prefill of `rows` rows of `tokens` tokens at positions
    offset..offset+tokens-1 (a paged chunk: `offset` the slots earlier
    chunks wrote, which it reads); an encoder-decoder's encoder over
    `frames` frames a row, a ViT frontend's `patches` patch embeddings
    in front of the prompt. The logits of every position are written."""
    cfg = model.cfg
    t = tokens + patches
    n = rows * t
    parts = {"weights": 0.0, "kv_read": 0.0, "kv_write": 0.0,
             "cross_write": 0.0, "state": 0.0, "encoder": 0.0}
    flop_parts = {"linears": 0.0, "attention": 0.0, "encoder": 0.0}
    if cfg.frontend:
        fp = params["frontend_proj"]
        parts["encoder"] += tree_bytes(fp)
        fr = rows * (frames if cfg.enc_dec else patches)
        flop_parts["encoder"] += 2.0 * fr * cfg.frontend_dim * cfg.d_model
    if cfg.enc_dec:
        s = frames
        for layer in params[ENCODER]:
            b, f = _layer_work(layer, rows * s, cfg, False, experts_touched)
            parts["encoder"] += b
            flop_parts["encoder"] += f + 4.0 * rows * cfg.n_heads \
                * cfg.head_dim * _causal_keys(s, 0)
        parts["encoder"] += tree_bytes(params["enc_norm"])
    for i, layer in enumerate(params["layers"]):
        b, f = _layer_work(layer, n, cfg, False, experts_touched)
        parts["weights"] += b
        flop_parts["linears"] += f
        btype = model.block_type(i)
        window = cfg.window if btype == "local_attn" else 0
        per_query = 4.0 * rows * cfg.n_heads * cfg.head_dim
        if btype in ATTENTION_TYPES:
            flop_parts["attention"] += per_query \
                * _causal_keys(t, offset, window)
        if btype == "encdec_attn":
            flop_parts["attention"] += per_query * t * frames
        site = caches["layers"][i] if caches is not None else {}
        for name, sub in site.items():
            if name in _RECURRENT:
                parts["state"] += 2 * tree_bytes(sub)
                continue
            per = _slot_bytes(sub)
            if name == "xkv":
                parts["cross_write"] += rows * frames * per
                continue
            slots = _kv_slots(sub)
            parts["kv_read"] += rows * min(offset, slots) * per
            parts["kv_write"] += rows * min(t, slots) * per
    hb, hf = _head(model, params, n)
    parts["head"] = hb
    parts["embed"] = _embed_rows(params, rows * tokens)
    flop_parts["linears"] += hf
    arg = tree_bytes(params) + (tree_bytes(caches) if caches else 0)
    return _new("prefill", n, parts, flop_parts,
                2.0 * cfg.active_param_count() * n, arg)


def train_step_stats(model, params, batch: int, seq: int, *,
                     opt_state=None, remat: bool = True) -> StepStats:
    """One training step of `batch` x `seq` tokens: the forward (and,
    under `remat`, its recompute) and the backward (twice the forward's
    linear and attention FLOPs) over every weight, the gradients written
    once and read by the optimizer, the optimizer state (`opt_state`, a
    tree of its tensors) read and written and the params written.
    Activations kept between the passes are not counted. `model_flops`
    is 6 x active_param_count x tokens."""
    cfg = model.cfg
    fwd = prefill_step_stats(model, params, None, seq, rows=batch,
                             frames=seq if cfg.enc_dec else 0)
    passes = 4.0 if remat else 3.0          # forward, recompute, 2 x bwd
    w = tree_bytes(params)
    parts = {"weights": w * (passes - 1.0),  # the backward reads them once
             "grads": 2.0 * w, "params_write": w,
             "optimizer": 2.0 * (tree_bytes(opt_state) if opt_state else 0),
             "embed": fwd.parts["embed"]}
    flop_parts = {k: v * passes for k, v in fwd.flop_parts.items()}
    n = batch * seq
    return _new("train", n, parts, flop_parts,
                6.0 * cfg.active_param_count() * n, w)
