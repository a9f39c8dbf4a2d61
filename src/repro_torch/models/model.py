"""Model assembly for every family of the reference: block builders,
caches and forwards by block type over `attn`, `moe`, `local_attn`,
`rglru`, `mlstm`, `slstm` and `encdec_attn` (layer i has type
`block_pattern[i % period]`), the encoder of an encoder-decoder and the
frontend stubs. Port of `repro/models/model.py`.

The reference scans a stacked layer group; the port keeps layers
unrolled (`params["layers"][i]`, site addresses `layers/<i>/...`) and
runs a Python loop over them. The encoder's layers are a list too
(`params["enc_blocks"][i]`), but every one of them resolves its policy
at the reference's one address `enc_blocks/<leaf>` (the reference
vmaps its encoder stack and never unrolls it).
`convert.params_from_numpy` unstacks a reference tree into this layout.
`Model.init(..., quantize=...)` draws and quantizes one layer at a time,
so a model whose fp32 weights do not fit on the card can still be built
there.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.analysis import sanitize
from repro_torch.backends import sharded
from repro_torch.configs.base import ArchConfig
from repro_torch.core import calibration, qlinear
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.qlinear import ENCODER
from repro_torch.sharding import axes
from repro_torch.sharding.rules import Spec

from . import layers as L

Params = Dict[str, Any]

BLOCK_TYPES = ("attn", "moe", "local_attn", "rglru", "mlstm", "slstm",
               "encdec_attn")
RECURRENT_TYPES = ("rglru", "mlstm", "slstm")           # no KV cache


def check_block_types(cfg: ArchConfig) -> None:
    """Raise a ValueError on a block type the port does not know, and on
    `encdec_attn` blocks without the encoder that feeds their cross
    attention (`enc_dec`)."""
    for btype in cfg.block_pattern:
        if btype not in BLOCK_TYPES:
            raise ValueError(f"{cfg.name}: unknown block type {btype!r}")
        if btype == "encdec_attn" and not (cfg.enc_dec
                                           and cfg.n_enc_layers):
            raise ValueError(
                f"{cfg.name}: block type 'encdec_attn' cross-attends an "
                f"encoder's output, and the config has no encoder "
                f"(enc_dec={cfg.enc_dec}, n_enc_layers={cfg.n_enc_layers})")


def _normal(gen: torch.Generator, shape, scale: float, device):
    return torch.randn(shape, generator=gen, device=device) * scale


def block_params(gen: torch.Generator, cfg: ArchConfig, btype: str,
                 device) -> Params:
    """One block of type `btype`, drawn as the reference draws it:
    normal weights scaled by 1/sqrt(fan_in), zero biases, unit norms.
    attn / local_attn: attention + the config's MLP (SwiGLU, or the GELU
    MLP with its biases); moe: attention + MoE; rglru: the recurrent
    block + SwiGLU; mlstm / slstm: the xLSTM block alone (it carries its
    own projections); encdec_attn: self-attention, cross attention
    (`lnx`, `xattn`) + the config's MLP."""
    d, hd = cfg.d_model, cfg.head_dim

    def w(k, n):
        return _normal(gen, (k, n), 1.0 / math.sqrt(k), device)

    def norm():
        return {"gamma_scale": torch.ones(d, device=device)}

    def mlp():
        if cfg.mlp_kind == "gelu":
            return {"wi": w(d, cfg.d_ff), "wd": w(cfg.d_ff, d),
                    "bi": torch.zeros(cfg.d_ff, device=device),
                    "bd": torch.zeros(d, device=device)}
        return {"wg": w(d, cfg.d_ff), "wu": w(d, cfg.d_ff),
                "wd": w(cfg.d_ff, d)}

    def attention():
        attn = {"wq": w(d, cfg.n_heads * hd),
                "wk": w(d, cfg.n_kv_heads * hd),
                "wv": w(d, cfg.n_kv_heads * hd),
                "wo": w(cfg.n_heads * hd, d)}
        if cfg.qkv_bias:
            attn["bq"] = torch.zeros(cfg.n_heads * hd, device=device)
            attn["bk"] = torch.zeros(cfg.n_kv_heads * hd, device=device)
            attn["bv"] = torch.zeros(cfg.n_kv_heads * hd, device=device)
        return attn

    if btype == "rglru":
        return {"ln1": norm(),
                "rec": L.rglru_params(gen, d, cfg.d_rnn or d, device),
                "ln2": norm(), "mlp": mlp()}
    if btype == "mlstm":
        return {"ln1": norm(),
                "mlstm": L.mlstm_params(gen, d, cfg.n_heads, device)}
    if btype == "slstm":
        return {"ln1": norm(),
                "slstm": L.slstm_params(gen, d, cfg.n_heads, device)}
    if btype == "encdec_attn":
        return {"ln1": norm(), "attn": attention(), "lnx": norm(),
                "xattn": attention(), "ln2": norm(), "mlp": mlp()}
    block = {"ln1": norm(), "attn": attention(), "ln2": norm()}
    if btype == "moe":
        block["moe"] = L.moe_params(gen, d, cfg.d_ff, cfg.n_experts, device)
    else:
        block["mlp"] = mlp()
    return block


def block_cache(cfg: ArchConfig, btype: str, batch: int, max_len: int,
                kv_bits: int, device, dtype=torch.float32,
                enc_len: int = 0, backend: str = ""):
    """A slab cache site: a KV cache of `max_len` slots (attn, moe) or of
    min(window, max_len) slots (local_attn: a ring once max_len reaches
    the window), or the recurrent state (rglru, mlstm, slstm; `kv_bits`
    unread); encdec_attn: the self-attention's KV cache ("kv") and an fp
    cross-attention cache of `enc_len` slots that records the rows its
    encoder output filled ("xkv", with "src_len"). Under a mesh, a KV
    cache served by `backend` "cuda_sharded" holds only this rank's KV
    heads, or where those do not split, its slots
    (`backends.sharded.make_kv_site`)."""
    if btype == "rglru":
        return {"rec": L.rglru_init_state(batch, cfg.d_rnn or cfg.d_model,
                                          device=device)}
    if btype == "mlstm":
        return {"mlstm": L.mlstm_init_state(batch, cfg.d_model, cfg.n_heads,
                                            device=device)}
    if btype == "slstm":
        return {"slstm": L.slstm_init_state(batch, cfg.d_model,
                                            device=device)}
    length = min(cfg.window, max_len) if btype == "local_attn" else max_len
    site = {"kv": sharded.make_kv_site(
        lambda heads, slots=length: L.make_kv_cache(
            batch, slots, heads, cfg.head_dim, kv_bits=kv_bits, dtype=dtype,
            device=device),
        cfg.n_kv_heads, backend, length=length)}
    if btype == "encdec_attn":
        site["xkv"] = sharded.make_kv_site(
            lambda heads, slots=enc_len: L.make_kv_cache(
                batch, slots, heads, cfg.head_dim, dtype=dtype,
                device=device, track_len=True),
            cfg.n_kv_heads, backend, length=enc_len)
    return site


def block_forward(p, x, positions, cfg: ArchConfig, policy: QuantPolicy,
                  cache=None, mode: str = "prefill", site: str = "",
                  btype: Optional[str] = None,
                  enc_out: Optional[torch.Tensor] = None,
                  aux: Optional[list] = None):
    """Pre-norm block of type `btype` with residuals: attention (local
    attention over the config's window) + the config's MLP or MoE, the
    recurrent block + SwiGLU, an xLSTM block (x + block(ln1 x)), or an
    encoder-decoder block (self-attention, cross attention over the
    encoder output `enc_out` or, in decode, over the "xkv" cache, then
    the MLP). Without `btype` the type is layer i's, read from the site
    address `layers/<i>`. Returns (x, cache); a MoE block appends its
    load-balance loss to the list `aux` when one is given."""
    if btype is None:
        head, _, layer = site.partition("/")
        if head != "layers" or not layer.isdigit():
            raise ValueError(f"block_forward: no btype and site {site!r} "
                             f"is not a layer address layers/<i>")
        btype = cfg.block_pattern[int(layer) % len(cfg.block_pattern)]
    eps = cfg.norm_eps
    if btype == "rglru":
        h, st = L.rglru_forward(p["rec"], L.rms_norm(x, p["ln1"], eps),
                                policy, state=None if cache is None
                                else cache["rec"], site=f"{site}/rec")
        x = x + h
        x = x + L.swiglu(p["mlp"], L.rms_norm(x, p["ln2"], eps), policy,
                         site=f"{site}/mlp")
        return x, (None if cache is None else {"rec": st})
    if btype in ("mlstm", "slstm"):
        fwd = L.mlstm_forward if btype == "mlstm" else L.slstm_forward
        h, st = fwd(p[btype], L.rms_norm(x, p["ln1"], eps), cfg, policy,
                    state=None if cache is None else cache[btype],
                    site=f"{site}/{btype}")
        return x + h, (None if cache is None else {btype: st})
    h, kv = L.attention_forward(
        p["attn"], L.rms_norm(x, p["ln1"], eps), positions, cfg, policy,
        window=cfg.window if btype == "local_attn" else 0,
        cache=None if cache is None else cache["kv"], mode=mode,
        site=f"{site}/attn")
    x = x + h
    new = None if cache is None else {"kv": kv}
    if btype == "encdec_attn":
        hx, xkv = L.cross_attention(
            p["xattn"], L.rms_norm(x, p["lnx"], eps), enc_out, cfg, policy,
            cache=None if cache is None else cache["xkv"], mode=mode,
            site=f"{site}/xattn")
        x = x + hx
        if cache is not None:
            new["xkv"] = xkv
    xm = L.rms_norm(x, p["ln2"], eps)
    if btype == "moe":
        h2, moe_aux = L.moe_layer(p["moe"], xm, cfg, policy,
                                  site=f"{site}/moe")
        if aux is not None:
            aux.append(moe_aux)
    else:
        mlp = L.gelu_mlp if cfg.mlp_kind == "gelu" else L.swiglu
        h2 = mlp(p["mlp"], xm, policy, site=f"{site}/mlp")
    return x + h2, new


class Model:
    """The LM of one ArchConfig under a QuantPolicy: a decoder, with the
    encoder of an encoder-decoder (`enc_dec`) and the projection of a
    frontend stub (`frontend`: audio frames into the encoder, or ViT
    patch embeddings in front of the prompt)."""

    def __init__(self, cfg: ArchConfig, policy: QuantPolicy = QuantPolicy(),
                 remat: bool = True):
        check_block_types(cfg)
        self.cfg = cfg
        self.policy = policy
        self.remat = remat

    def _remat(self, fn, p, x):
        """fn(p, x) for a layer's params p and hidden states x, under
        activation checkpointing when `remat` is on and autograd records
        through them (the reference's `jax.checkpoint` around a layer,
        which only training differentiates): the layer's activations are
        recomputed in the backward pass instead of kept. Serving, where
        nothing requires grad, runs fn as it is."""
        if self.remat and torch.is_grad_enabled() and (
                x.requires_grad or any(
                    isinstance(w, torch.Tensor) and w.requires_grad
                    for _, w in qlinear.tree_paths(p))):
            return torch.utils.checkpoint.checkpoint(fn, p, x,
                                                     use_reentrant=False)
        return fn(p, x)

    def block_type(self, layer: int) -> str:
        return self.cfg.block_pattern[layer % len(self.cfg.block_pattern)]

    def init_stream(self, generator: Optional[torch.Generator],
                    device="cuda") -> Iterator[Tuple[str, Params]]:
        """The random weights in their draw order, one piece at a time:
        ("", {embed, final_norm, lm_head}, with a frontend's
        `frontend_proj` {w_in, b_in} and an encoder's `enc_norm`) first,
        then an encoder-decoder's ("enc_blocks", [its n_enc_layers attn
        blocks]) in one piece (the reference quantizes the encoder as
        one stack), then ("layers/<i>", block i) for each layer, each
        piece drawn when it is asked for (the reference's distributions:
        embed N(0, 0.02²), head N(0, 1/d), frontend N(0, 1/frontend_dim)
        with a zero bias, blocks by type as `block_params`). torch and
        JAX draw different numbers from one seed: tests carry the
        reference's weights over with `convert.params_from_numpy`.
        `device="meta"` (and no generator) gives the shapes alone."""
        cfg = self.cfg
        vp = cfg.padded_vocab
        top = {
            "embed": {"table": _normal(generator, (vp, cfg.d_model), 0.02,
                                       device)},
            "final_norm": {"gamma_scale": torch.ones(cfg.d_model,
                                                     device=device)},
            "lm_head": {"w_out": _normal(generator, (cfg.d_model, vp),
                                         1.0 / math.sqrt(cfg.d_model),
                                         device)},
        }
        if cfg.frontend:
            top["frontend_proj"] = {
                "w_in": _normal(generator, (cfg.frontend_dim, cfg.d_model),
                                1.0 / math.sqrt(cfg.frontend_dim), device),
                "b_in": torch.zeros(cfg.d_model, device=device)}
        if cfg.enc_dec:
            top["enc_norm"] = {"gamma_scale": torch.ones(cfg.d_model,
                                                         device=device)}
        yield "", top
        if cfg.enc_dec:
            yield ENCODER, [block_params(generator, cfg, "attn", device)
                            for _ in range(cfg.n_enc_layers)]
        for i in range(cfg.n_layers):
            yield f"layers/{i}", block_params(generator, cfg,
                                              self.block_type(i), device)

    def init(self, generator: Optional[torch.Generator], device="cuda",
             quantize: Optional[Callable[[Params, str], Params]] = None
             ) -> Params:
        """The whole tree `init_stream` draws. `quantize(tree, prefix)`
        (e.g. `qlinear.quantize_params` under a policy, with `prefix` the
        tree's site address) is applied to each layer (the encoder: to
        its stack) as soon as it is drawn, and to the embedding, head
        and frontend last. The draws keep their order, so the result
        equals init-then-quantize, but only one layer's fp32 weights (or
        the encoder's) exist at a time."""
        pieces = self.init_stream(generator, device)
        _, params = next(pieces)
        layers = []
        for prefix, block in pieces:
            block = block if quantize is None else quantize(block, prefix)
            if prefix == ENCODER:
                params[ENCODER] = block
            else:
                layers.append(block)
            del block       # before the next layer is drawn
        params["layers"] = layers
        if quantize is not None:
            params.update(quantize({key: val for key, val in params.items()
                                    if key not in ("layers", ENCODER)}, ""))
        return params

    def init_caches(self, batch: int, max_len: int, enc_len: int = 0,
                    device="cuda", dtype=torch.float32):
        """Slab caches by block type (`block_cache`); kv_bits resolves
        per KV cache site (`layers/<i>/attn/kv`), and only where the
        block has one. An encdec_attn layer's cross cache has `enc_len`
        slots (fp, whatever the policy)."""
        layers = []
        for i in range(self.cfg.n_layers):
            kv = self.policy.resolve(f"layers/{i}/attn/kv")
            recurrent = self.block_type(i) in RECURRENT_TYPES
            layers.append(block_cache(
                self.cfg, self.block_type(i), batch, max_len,
                0 if recurrent else kv.kv_bits, device, dtype, enc_len,
                kv.backend))
        return {"layers": layers}

    def init_paged_caches(self, n_pages: int, page_size: int,
                          batch_slots: int, pages_per_row: int,
                          device="cuda", dtype=torch.float32):
        """PAGED KV caches: every cache site holds a pool of `n_pages`
        pages (plus its sink page) and a `(batch_slots, pages_per_row)`
        block table (`layers.make_paged_kv_cache`). Page ids are shared
        across sites: one allocator row backs the same token rows in
        every layer. kv_bits resolves per site (`layers/<i>/attn/kv`).
        Only pure attn/moe patterns page (a ring or a recurrent state
        keeps the slab layout), as in the reference."""
        cfg = self.cfg
        bad = sorted({bt for bt in cfg.block_pattern
                      if bt not in ("attn", "moe")})
        if bad:
            raise ValueError(
                f"paged KV caches support pure attn/moe block patterns; "
                f"pattern {cfg.block_pattern} has {bad}")
        layers = []
        for i in range(cfg.n_layers):
            kv = self.policy.resolve(f"layers/{i}/attn/kv")
            layers.append({"kv": sharded.make_kv_site(
                lambda heads, kv=kv: L.make_paged_kv_cache(
                    n_pages, page_size, batch_slots, pages_per_row, heads,
                    cfg.head_dim, kv_bits=kv.kv_bits, dtype=dtype,
                    device=device),
                cfg.n_kv_heads, kv.backend)})
        return {"layers": layers}

    def forward(self, params, batch: Dict[str, torch.Tensor], *,
                mode: str = "prefill", caches=None, positions=None,
                view: Optional[Callable[[Params, str], Params]] = None):
        """Returns (logits, caches); "train" returns (logits, None, aux),
        the reference's triple.

        train:   a prefill's batch and positions with no cache, the MoE
                 load-balance losses summed over the blocks into `aux`
                 (f32 scalar), each layer under `remat` (other keys of
                 the batch, "labels" and "loss_mask", are not read).
                 `view(tree, prefix)`, when given, maps the params a
                 piece reads before it reads them: the top-level
                 entries once, each layer's inside its `remat`
                 boundary (the sharded step's weight gather, which the
                 backward pass then recomputes instead of keeping).
                 An `axes.axis_rules` context around the call is
                 re-entered inside each layer, so a recomputed layer
                 sees it too
        prefill: batch["tokens"] (B, T), positions 0..T-1 unless
                 `positions` (B, T) gives absolute ones (a prefill chunk);
                 an encoder-decoder also takes batch["frames"] (B, S,
                 frontend_dim), which the encoder runs on (`encode`) and
                 the cross caches take; a ViT frontend takes
                 batch["patch_embeds"] (B, P, frontend_dim), projected
                 and put in front of the prompt's embeddings (positions
                 then run 0..P+T-1)
        decode:  batch["tokens"] (B, 1), batch["pos"] (B,)
        """
        cfg = self.cfg
        if view is not None:
            if mode != "train":
                raise ValueError("Model.forward: `view` is a train-mode "
                                 "hook")
            params = {k: v if k in ("layers", ENCODER) else view(v, k)
                      for k, v in params.items()}
        x, positions, enc_out = self._inputs(params, batch, mode, positions,
                                             view)
        if mode == "train":
            return self._train_layers(params, x, positions, enc_out, view)
        new = []
        for i, p in enumerate(params["layers"]):
            x, nc = block_forward(p, x, positions, cfg, self.policy,
                                  cache=None if caches is None
                                  else caches["layers"][i], mode=mode,
                                  site=f"layers/{i}",
                                  btype=self.block_type(i), enc_out=enc_out)
            new.append(nc)
        return self.head(params, x), (None if caches is None
                                      else {"layers": new})

    def _inputs(self, params, batch: Dict[str, torch.Tensor], mode: str,
                positions, view=None):
        """The first hidden states, their positions and (an
        encoder-decoder's, but in decode) the encoder output."""
        cfg = self.cfg
        enc_out = None
        if cfg.enc_dec and mode != "decode":
            enc_out = self.encode(params, batch["frames"], view)
        tok = batch["tokens"]
        x = self.embed(params, tok)
        if cfg.frontend == "vit" and "patch_embeds" in batch:
            # projected patches, not scaled by sqrt(d) as the tokens are
            x = torch.cat([self.frontend(params, batch["patch_embeds"]), x],
                          dim=1)
        b, t = x.shape[:2]
        if positions is None and mode == "decode":
            positions = batch["pos"][:, None]
        elif positions is None:
            positions = torch.arange(t, device=tok.device)[None].expand(b, t)
        return x, positions, enc_out

    def _train_layers(self, params, x, positions, enc_out, view=None):
        """The train forward's layers, each under `remat`, and the head;
        returns (logits, None, aux)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        rules = axes.current()
        for i, p in enumerate(params["layers"]):

            def layer(p, h, i=i):
                got = []
                with axes.reentered(rules):
                    if view is not None:
                        p = view(p, f"layers/{i}")
                    h, _ = block_forward(p, h, positions, self.cfg,
                                         self.policy, site=f"layers/{i}",
                                         btype=self.block_type(i),
                                         enc_out=enc_out, aux=got)
                return h, sum(got, torch.zeros_like(aux))

            x, a = self._remat(layer, p, x)
            aux = aux + a
        return self.head(params, x), None, aux

    def frontend(self, params, feats: torch.Tensor) -> torch.Tensor:
        """The frontend stub's projection (B, S, frontend_dim) -> (B, S,
        d): `frontend_proj` w_in + b_in at the site
        `frontend_proj/w_in`."""
        cdt = getattr(torch, self.policy.compute_dtype)
        proj = params["frontend_proj"]
        return qlinear.linear(feats.to(cdt), proj["w_in"], proj["b_in"],
                              self.policy.resolve("frontend_proj/w_in"),
                              site="frontend_proj/w_in")

    def encode(self, params, frames: torch.Tensor,
               view=None) -> torch.Tensor:
        """The encoder over stub frame embeddings (B, S, frontend_dim):
        the frontend projection, the n_enc_layers `attn` blocks (their
        self-attention causal, as the reference's encoder calls it,
        RoPE at 0..S-1, the config's MLP), each at the site prefix
        `enc_blocks`, then `enc_norm`. Returns (B, S, d). The blocks run
        with the calibration tape suspended: the reference scans them
        (`jax.lax.scan` traces its body), so no `enc_blocks/` site
        reaches its tape, while the frontend projection does. With
        `remat` under autograd, each block is recomputed in the
        backward pass (`view` as `forward`'s, at `enc_blocks/<j>`)."""
        cfg = self.cfg
        x = self.frontend(params, frames)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        rules = axes.current()

        def block(p, h, j=0):
            with axes.reentered(rules):
                if view is not None:
                    p = view(p, f"{ENCODER}/{j}")
                return block_forward(p, h, positions, cfg, self.policy,
                                     site=ENCODER, btype="attn")[0]

        with calibration.tape_suspended():
            for j, p in enumerate(params[ENCODER]):
                x = self._remat(functools.partial(block, j=j), p, x)
        return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids (B, T) -> the first hidden states (B, T, d): rows of
        the table (`F.embedding`, whose backward on the card sums each
        row's gradients in a fixed order, so a training step is
        reproducible; an index's backward adds them atomically). A
        table placed on a mesh is looked up vocab-parallel
        (`backends.sharded.embed_lookup`)."""
        cdt = getattr(torch, self.policy.compute_dtype)
        return sharded.embed_lookup(tokens, params["embed"]["table"]).to(
            cdt) * math.sqrt(self.cfg.d_model)

    def head(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm and LM head: hidden states -> f32 logits, the
        padded vocab columns masked (and, under `sanitize.configure()`,
        checked finite)."""
        cfg = self.cfg
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            table = params["embed"]["table"]
            head = table.T
            if getattr(table, "placed", None) is not None:
                head.placed = Spec(*reversed(table.placed))  # (d, V)
        else:
            head = params["lm_head"]["w_out"]
        logits = qlinear.qmatmul(x, head, self.policy.resolve("lm_head/w_out"),
                                 site="lm_head/w_out").to(torch.float32)
        if cfg.padded_vocab != cfg.vocab:
            col = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(col >= cfg.vocab, -1e9, logits)
        sanitize.check_logits(logits)
        return logits


def build_model(cfg: ArchConfig, policy: QuantPolicy = QuantPolicy(),
                remat: bool = True) -> Model:
    return Model(cfg, policy, remat)
