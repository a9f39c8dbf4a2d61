"""Quantized linear ops — the integration point between OliVe and the
models. Port of `repro/core/qlinear.py`: PTQ serving, QAT, the
baselines and the calibration tape.

  raw weight                 -> plain matmul in the compute dtype (a
                                baseline with `abits` set fake-quantizes
                                the activation first)
  raw weight, policy on with -> QAT: STE fake-quant of the weight (and of
  `qat` (method "olive")        the activation when `abits` is set),
                                then `torch.matmul`
  QuantizedTensor,           -> `repro_torch.backends.dispatch` on the
  MixedExpertQuant              backend `policy.backend` names
  raw weight placed on a     -> `backends.sharded.raw_matmul`: its FSDP
  mesh (`.placed`)              parts gathered, its "model" part column-,
                                row- or expert-parallel

The baselines (`method` "int" and "ant") are fake-quant, as in the
reference: PTQ leaves a dense fp32 weight holding the quantized values,
which runs through `torch.matmul` (the reference's `jnp.matmul`, outside
any kernel). Their one scale a tensor spans what the reference's layout
hands them: in its scanned layout (a flat policy, or a program that does
not address layers) the stack of one site over the layers at one
position of the block pattern's period (its `blocks/<j>`; a layer past
the last full period, its `tail`, alone), so `quantize_params` on a
whole tree fake-quantizes those stacks (`stacks_layers`); a program that addresses layers quantizes each layer
alone, as the reference's unrolled layout does.

Weights pair along the reduction dim K with per-output-channel scales, so
a scale never splits a pair. Stacked per-expert weights (E, K, N) get one
scale per (expert, channel); a policy program that tells experts apart
(sites `<path>/<e>`) quantizes the stack group-wise into a
`MixedExpertQuant`.
"""
from __future__ import annotations

from typing import Optional, Union

import dataclasses
import weakref

import torch

from repro_torch import backends
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import axes

from . import baselines, calibration
from .ovp import MixedExpertQuant, QuantizedTensor, ovp_quantize
from .policy import PolicyLike, PolicyProgram, QuantPolicy, resolve
from .quantizer import (QuantSpec, fake_quant_ste, ovp_search_scale,
                        ovp_search_scale_per_channel, quantize,
                        sigma_init_scale, sigma_scale)

Weight = Union[torch.Tensor, QuantizedTensor, MixedExpertQuant]

BASELINE_METHODS = ("int", "ant")

# weights per chunk of a stacked PTQ: bounds the search's temporaries
# (a few fp32 copies of one chunk) at full width
STACK_CHUNK = 1 << 25

# an encoder-decoder's encoder layers (`params["enc_blocks"]`, a list):
# the reference vmaps them as one stack and never unrolls it, so every
# encoder layer's leaf resolves at the one site `enc_blocks/<leaf>`
ENCODER = "enc_blocks"


def quantize_weight(w: torch.Tensor, policy: QuantPolicy) -> Weight:
    """PTQ one weight matrix (K, N) or expert stack (E, K, N): pair along
    K, scale per output channel (per expert and channel for a stack).
    The baselines fake-quantize the whole tensor at one scale."""
    if not policy.enabled:
        return w
    if policy.method == "int":
        return baselines.uniform_int_fake_quant(w, policy.wbits)
    if policy.method == "ant":
        return baselines.ant_fake_quant(w)
    if policy.method != "olive" or w.ndim not in (2, 3):
        raise ValueError(f"the port quantizes 2-D weights and 3-D expert "
                         f"stacks with 'olive'; got {policy.method!r} on "
                         f"{tuple(w.shape)}")
    spec = QuantSpec(normal_dtype=policy.normal_dtype_for_bits(policy.wbits),
                     granularity=policy.w_granularity, channel_axis=-1,
                     pair_axis=-2)
    if w.ndim == 2:
        return quantize(w, spec)
    return _quantize_stack(w, spec)


def _quantize_stack(w: torch.Tensor, spec: QuantSpec) -> QuantizedTensor:
    """The reference vmaps `quantize` over the experts; here the expert
    dim is written out. Channel granularity: one vectorised per-channel
    search over the E·N channels (each channel's K values, paired along
    K), in chunks of experts; scales (E, 1, N). Tensor granularity: one
    search per expert; scales (E, 1, 1)."""
    e, k, n = w.shape
    chunk = max(1, STACK_CHUNK // (k * n))
    parts = []
    for i in range(0, e, chunk):
        sub = w[i:i + chunk].to(torch.float32)
        if spec.granularity == "tensor":
            s = torch.stack([ovp_search_scale(x, spec.normal_dtype,
                                              spec.abfloat, spec.n_grid)
                             for x in sub]).reshape(-1, 1, 1)
        else:
            flat = sub.transpose(1, 2).reshape(-1, k)       # (Ec·N, K)
            s = ovp_search_scale_per_channel(
                flat, 0, spec.normal_dtype, spec.abfloat,
                max(8, spec.n_grid // 2)).reshape(-1, 1, n)
        parts.append(ovp_quantize(sub, s, spec.normal_dtype, spec.abfloat,
                                  pair_axis=-2))
    q0 = parts[0]
    return QuantizedTensor(data=torch.cat([q.data for q in parts]),
                           scale=torch.cat([q.scale for q in parts]),
                           normal_dtype=q0.normal_dtype,
                           pair_axis=q0.pair_axis, orig_dim=q0.orig_dim)


# QAT: the last fake-quantized activation (a weak reference to its
# input, the input's version, the normal dtype, the result), so linears
# called one after another on one tensor (attention's wq, wk, wv;
# SwiGLU's wg, wu) fake-quantize it once, as XLA's common-subexpression
# elimination does for the reference
_QAT_LAST_ACT: list = [None]


def _act_scale(x: torch.Tensor, normal_dtype: str) -> torch.Tensor:
    """The activation's per-tensor 3σ scale. When a mesh
    (`sharding.axes.axis_rules`) splits the batch over ranks of equal
    row counts, σ is the whole batch's, computed as one device computes
    it in the tensor's dtype (`quantizer._pop_std`: the mean, rounded;
    the squared deviations, each rounded; their mean, rounded; its
    root), with each fp32 sum taken over the ranks in rank order."""
    cur = axes.current()
    split = () if cur is None else axes.batch_split(cur[1], cur[0])
    if not split:
        return sigma_init_scale(x, normal_dtype)
    mesh = cur[0]

    def over(t):
        for a in split:
            t = mesh_lib.rank_sum(t, mesh, a)
        return t

    n = x.numel()
    for a in split:
        n *= mesh.size(a)
    mu = (over(x.sum(dtype=torch.float32)) / n).to(x.dtype)
    var = over(((x - mu) ** 2).sum(dtype=torch.float32)) / n
    return sigma_scale(torch.sqrt(var.to(x.dtype)), normal_dtype)


def _qat_activation(x: torch.Tensor, normal_dtype: str) -> torch.Tensor:
    last = _QAT_LAST_ACT[0]
    if last is not None and last[0]() is x and \
            last[1:3] == (x._version, normal_dtype):
        return last[3]
    xq = fake_quant_ste(x, _act_scale(x.detach(), normal_dtype),
                        normal_dtype, pair_axis=-1)
    _QAT_LAST_ACT[0] = (weakref.ref(x), x._version, normal_dtype, xq)
    return xq


def qmatmul(x: torch.Tensor, w: Weight, policy: QuantPolicy, site: str = "",
            act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) @ w (K, N) with the policy's quantization applied.
    `site` is the weight's "/"-joined param-tree address: it feeds the
    calibration tape when one is active (raw and quantized weights
    alike), and names the site when a static-scale policy arrives
    without a calibrated scale."""
    calibration.tap(site, x)
    if isinstance(w, (QuantizedTensor, MixedExpertQuant)):
        if (policy.abits and policy.act_scale_mode == "static"
                and act_scale is None and policy.static_act_scale is None):
            raise calibration.MissingStaticScaleError([site or "<unknown>"])
        return backends.dispatch(x, w, policy, act_scale=act_scale)
    cdt = backends.base.torch_dtype(policy.compute_dtype)
    if policy.enabled and policy.qat and policy.method == "olive":
        # QAT: STE fake-quant of W at its per-tensor 3σ scale, pairs
        # along K, and of the activation (pairs along its last dim)
        nd = policy.normal_dtype_for_bits(policy.wbits)
        w = fake_quant_ste(w, sigma_init_scale(w.detach(), nd), nd,
                           pair_axis=-2)
        if policy.abits:
            x = _qat_activation(x, policy.a_normal_dtype)
        return torch.matmul(x.to(cdt), w.to(cdt))
    if policy.enabled and policy.abits and \
            policy.method in BASELINE_METHODS:
        # baseline PTQ serving: the weight was fake-quantized offline; the
        # activation runs dynamic max-scaled int fake-quant (the int8 /
        # int4 runtime path the paper compares against)
        x = baselines.uniform_int_dynamic_act(x.to(torch.float32),
                                              policy.abits)
    if getattr(w, "placed", None) is not None:
        # a raw weight placed on a mesh (`backends.sharded.local_shard`)
        return backends.sharded.raw_matmul(x, w, cdt)
    return torch.matmul(x.to(cdt), w.to(cdt))


def linear(x: torch.Tensor, w: Weight, b: Optional[torch.Tensor],
           policy: QuantPolicy, site: str = "",
           act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = qmatmul(x, w, policy, site, act_scale)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


NEVER_QUANT = {"w_igate", "w_fgate", "w_gate", "conv_kernel"}


def is_linear_weight(path: str, w) -> bool:
    """Structural gate: is this leaf a matmul weight qlinear consumes?
    (Whether it quantizes is the policy's job.)"""
    if not isinstance(w, torch.Tensor) or w.ndim < 2:
        return False
    leaf = path.split("/")[-1]
    if leaf in NEVER_QUANT:
        return False
    return leaf.startswith("w") or leaf in ("kernel", "wi", "wo", "wq", "wk",
                                            "wv", "wu", "wg", "wd")


def tree_paths(params, prefix: str = ""):
    """(path, leaf) pairs with "/"-joined paths over nested dicts and
    lists — the site addresses the policy resolves against.
    QuantizedTensor leaves stay whole."""
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = enumerate(params)
    else:
        return [(prefix, params)]
    out = []
    for k, v in items:
        out.extend(tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _map_tree(params, fn, prefix: str = ""):
    if isinstance(params, dict):
        return {k: _map_tree(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(
            _map_tree(v, fn, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(params))
    return fn(prefix, params)


def _expert_site_policies(path: str, n_experts: int, policy: PolicyLike):
    """Resolved policies of the per-expert sub-sites `<path>/<e>` of one
    stacked weight, or None when every expert resolves alike (the common
    case: the stack stays one QuantizedTensor). A calibrated activation
    scale is an A-side property and does not split the stack."""
    pols = [dataclasses.replace(resolve(policy, f"{path}/{e}"),
                                static_act_scale=None)
            for e in range(n_experts)]
    return pols if len(set(pols)) > 1 else None


def _quantize_mixed_experts(w: torch.Tensor, pols) -> MixedExpertQuant:
    """Group experts by resolved policy, in order of first appearance;
    each group quantizes as one stack (a disabled group stays raw)."""
    by_pol = {}
    for e, pol in enumerate(pols):
        by_pol.setdefault(pol, []).append(e)
    groups, ids = [], []
    for pol, idx in by_pol.items():
        sub = w[torch.as_tensor(idx, device=w.device)]
        groups.append(quantize_weight(sub.to(torch.float32), pol)
                      if pol.enabled else sub)
        ids.append(tuple(idx))
    return MixedExpertQuant(groups=tuple(groups), expert_ids=tuple(ids),
                            n_experts=len(pols))


def stacks_layers(policy: PolicyLike, n_layers: int) -> bool:
    """Does PTQ of a whole tree fake-quantize a baseline site over its
    stack of layers? True when the reference keeps this policy's layer
    stack scanned (a flat policy, or a program that does not address
    layers) and some rule or the default is a baseline. The reference's
    stack of a site is the `blocks/<j>` group stack: the layers at one
    position j of the block pattern's period (`_quantize_layer_stacks`)."""
    if isinstance(policy, PolicyProgram):
        if policy.addresses_layers(n_layers):
            return False
        pols = [r.policy for r in policy.rules] + [policy.default]
    else:
        pols = [policy]
    return any(p.enabled and p.method in BASELINE_METHODS for p in pols)


def _quantize_leaf(path: str, w, policy: PolicyLike, min_size: int,
                   stack: int = 1):
    """PTQ of one leaf at site `path`; `stack` > 1: the leaf is one
    layer of a stack of that many that the reference quantizes as one
    leaf, whose size is what `min_size` gates."""
    if not (is_linear_weight(path, w) and w.ndim in (2, 3)
            and w.numel() * stack >= min_size and w.shape[-2] % 2 == 0):
        return w
    if w.ndim == 3:
        pols = _expert_site_policies(path, w.shape[0], policy)
        if pols is not None:
            return _quantize_mixed_experts(w, pols)
    site_policy = resolve(policy, path)
    if not site_policy.enabled:
        return w
    return quantize_weight(w.to(torch.float32), site_policy)


def _leaf(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _quantize_layer_stacks(layers, policy: PolicyLike, min_size: int,
                           encoder: bool = False, period: int = 1):
    """The layers of a scanned-layout PTQ, as the reference's `blocks/<j>`
    group stacks and `tail`: layer i sits at period position i % period;
    the layers of the n_groups = len(layers) // period full periods at
    position j form one stack, and each site of such a stack that
    resolves to a baseline fake-quantizes the stack at one scale (its
    size passes `min_size`, as the reference's does), every layer taking
    its slice. The layers past the last full period (the reference's
    `tail`) and every other leaf quantize one layer at a time. The fp32
    layers and the fake-quantized stacks exist together until the caller
    drops the fp32 tree. `encoder`: the layers are the encoder's
    (`ENCODER`, one stack of period 1), whose every leaf resolves at
    `enc_blocks/<leaf>` and passes `min_size` by the stack's size."""

    def site_of(i, rel):
        return f"{ENCODER}/{rel}" if encoder else f"layers/{i}/{rel}"

    n_groups = len(layers) // period
    done = {}
    for j in range(period if n_groups else 0):
        members = range(j, n_groups * period, period)
        paths = [p for p, _ in tree_paths(layers[j])]
        if any([p for p, _ in tree_paths(layers[i])] != paths
               for i in members):
            raise ValueError(
                f"layers at period position {j} of period {period} differ "
                f"in structure: pass the block pattern's period")
        for rel, w in tree_paths(layers[j]):
            pol = resolve(policy, site_of(j, rel))
            if not (pol.enabled and pol.method in BASELINE_METHODS
                    and is_linear_weight(rel, w)
                    and w.numel() * len(members) >= min_size
                    and w.shape[-2] % 2 == 0):
                continue
            stack = torch.stack([_leaf(layers[i], rel).to(torch.float32)
                                 for i in members])
            for i, q in zip(members, quantize_weight(stack, pol).unbind(0)):
                done[(i, rel)] = q
            del stack

    def one(path, w):
        i, rel = path.split("/", 2)[1:]
        if (int(i), rel) in done:
            return done[(int(i), rel)]
        if encoder:
            return _quantize_leaf(site_of(i, rel), w, policy, min_size,
                                  stack=len(layers))
        return _quantize_leaf(path, w, policy, min_size)

    return _map_tree(layers, one, ENCODER if encoder else "layers")


def quantize_params(params, policy: PolicyLike, min_size: int = 4096,
                    prefix: str = "", period: int = 1):
    """Map PTQ over a parameter tree: every linear weight whose site
    resolves to an enabled policy quantizes; norms, biases and small
    tensors stay fp. Sizes are per layer (the port keeps layers
    unrolled), but a whole tree under `stacks_layers` fake-quantizes each
    baseline site over its stack of layers: the layers at one position
    of the block pattern's `period` (`len(cfg.block_pattern)`; 1 for a
    pattern of one block type), as `_quantize_layer_stacks` says. Stacked (E, K, N) expert
    weights also resolve their per-expert sub-sites and quantize
    group-wise when those differ. `prefix` is the site address of
    `params` itself (`layers/<i>` when a model quantizes one layer at a
    time). The encoder's layers (the list under `ENCODER`, or that list
    itself with `prefix` `ENCODER`) quantize as the reference's one
    stack: sites `enc_blocks/<leaf>`, `min_size` on the stack's size,
    a baseline over the stack at one scale."""
    if not policy.enabled:
        return params
    if prefix == ENCODER:
        return _quantize_layer_stacks(params, policy, min_size,
                                      encoder=True)
    if not prefix and ENCODER in params:
        rest = {key: val for key, val in params.items() if key != ENCODER}
        return dict(quantize_params(rest, policy, min_size),
                    **{ENCODER: quantize_params(params[ENCODER], policy,
                                                min_size, ENCODER)})
    if not prefix and params.get("layers") and \
            stacks_layers(policy, len(params["layers"])):
        rest = {key: val for key, val in params.items() if key != "layers"}
        return dict(quantize_params(rest, policy, min_size),
                    layers=_quantize_layer_stacks(params["layers"], policy,
                                                  min_size, period=period))

    def one(path, w):
        return _quantize_leaf(path, w, policy, min_size)

    return _map_tree(params, one, prefix)
