"""Quantized linear ops — the integration point between OliVe and the
models. Port of `repro/core/qlinear.py` (PTQ serving, the baselines and
the calibration tape: no QAT).

  raw weight                 -> plain matmul in the compute dtype (a
                                baseline with `abits` set fake-quantizes
                                the activation first)
  QuantizedTensor,           -> `repro_torch.backends.dispatch` on the
  MixedExpertQuant              backend `policy.backend` names

The baselines (`method` "int" and "ant") are fake-quant, as in the
reference: PTQ leaves a dense fp32 weight holding the quantized values,
which runs through `torch.matmul` (the reference's `jnp.matmul`, outside
any kernel). Their one scale a tensor spans what the reference's layout
hands them: in its scanned layout (a flat policy, or a program that does
not address layers) the stack of one site over every layer, so
`quantize_params` on a whole tree fake-quantizes that stack
(`stacks_layers`); a program that addresses layers quantizes each layer
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

import torch

from repro_torch import backends

from . import baselines, calibration
from .ovp import MixedExpertQuant, QuantizedTensor, ovp_quantize
from .policy import PolicyLike, PolicyProgram, QuantPolicy, resolve
from .quantizer import (QuantSpec, ovp_search_scale,
                        ovp_search_scale_per_channel, quantize)

Weight = Union[torch.Tensor, QuantizedTensor, MixedExpertQuant]

BASELINE_METHODS = ("int", "ant")

# weights per chunk of a stacked PTQ: bounds the search's temporaries
# (a few fp32 copies of one chunk) at full width
STACK_CHUNK = 1 << 25


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
    if policy.enabled and policy.abits and \
            policy.method in BASELINE_METHODS:
        # baseline PTQ serving: the weight was fake-quantized offline; the
        # activation runs dynamic max-scaled int fake-quant (the int8 /
        # int4 runtime path the paper compares against)
        x = baselines.uniform_int_dynamic_act(x.to(torch.float32),
                                              policy.abits)
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
    layers) and some rule or the default is a baseline. The port's
    families repeat one block, so the reference's stack of a site holds
    every layer's weight there."""
    if isinstance(policy, PolicyProgram):
        if policy.addresses_layers(n_layers):
            return False
        pols = [r.policy for r in policy.rules] + [policy.default]
    else:
        pols = [policy]
    return any(p.enabled and p.method in BASELINE_METHODS for p in pols)


def _quantize_leaf(path: str, w, policy: PolicyLike, min_size: int):
    if not (is_linear_weight(path, w) and w.ndim in (2, 3)
            and w.numel() >= min_size and w.shape[-2] % 2 == 0):
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


def _quantize_layer_stacks(layers, policy: PolicyLike, min_size: int):
    """The layers of a scanned-layout PTQ: each site that resolves to a
    baseline fake-quantizes the stack of its weight over all layers at
    one scale (the stack's size passes `min_size`, as the reference's
    does), and every layer takes its slice; the other leaves quantize
    one layer at a time. The fp32 layers and the fake-quantized stacks
    exist together until the caller drops the fp32 tree."""
    done = {}
    for rel, w in tree_paths(layers[0]):
        site = f"layers/0/{rel}"
        pol = resolve(policy, site)
        if not (pol.enabled and pol.method in BASELINE_METHODS
                and is_linear_weight(rel, w)
                and w.numel() * len(layers) >= min_size
                and w.shape[-2] % 2 == 0):
            continue
        stack = torch.stack([_leaf(layer, rel).to(torch.float32)
                             for layer in layers])
        done[rel] = quantize_weight(stack, pol).unbind(0)
        del stack

    def one(path, w):
        i, rel = path.split("/", 2)[1:]
        if rel in done:
            return done[rel][int(i)]
        return _quantize_leaf(path, w, policy, min_size)

    return _map_tree(layers, one, "layers")


def quantize_params(params, policy: PolicyLike, min_size: int = 4096,
                    prefix: str = ""):
    """Map PTQ over a parameter tree: every linear weight whose site
    resolves to an enabled policy quantizes; norms, biases and small
    tensors stay fp. Sizes are per layer (the port keeps layers
    unrolled), but a whole tree under `stacks_layers` fake-quantizes each
    baseline site over its stack of layers. Stacked (E, K, N) expert
    weights also resolve their per-expert sub-sites and quantize
    group-wise when those differ. `prefix` is the site address of
    `params` itself (`layers/<i>` when a model quantizes one layer at a
    time)."""
    if not policy.enabled:
        return params
    if not prefix and params.get("layers") and \
            stacks_layers(policy, len(params["layers"])):
        rest = {key: val for key, val in params.items() if key != "layers"}
        return dict(quantize_params(rest, policy, min_size),
                    layers=_quantize_layer_stacks(params["layers"], policy,
                                                  min_size))

    def one(path, w):
        return _quantize_leaf(path, w, policy, min_size)

    return _map_tree(params, one, prefix)
