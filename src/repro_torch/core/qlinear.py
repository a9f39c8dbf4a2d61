"""Quantized linear ops — the integration point between OliVe and the
models. Port of `repro/core/qlinear.py` (PTQ serving and the
calibration tape: no QAT, no baselines).

  raw weight                 -> plain matmul in the compute dtype
  QuantizedTensor            -> `repro_torch.backends.dispatch` on the
                                backend `policy.backend` names

Weights pair along the reduction dim K with per-output-channel scales, so
a scale never splits a pair.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import backends

from . import calibration
from .ovp import QuantizedTensor
from .policy import QuantPolicy, resolve
from .quantizer import QuantSpec, quantize

Weight = Union[torch.Tensor, QuantizedTensor]


def quantize_weight(w: torch.Tensor, policy: QuantPolicy) -> Weight:
    """PTQ one weight matrix (K, N): pair along K, scale per N. (Stacked
    expert weights come with the MoE slice.)"""
    if not policy.enabled:
        return w
    if policy.method != "olive" or w.ndim != 2:
        raise ValueError(f"the port quantizes 2-D weights with 'olive'; "
                         f"got {policy.method!r} on {tuple(w.shape)}")
    spec = QuantSpec(normal_dtype=policy.normal_dtype_for_bits(policy.wbits),
                     granularity=policy.w_granularity, channel_axis=-1,
                     pair_axis=-2)
    return quantize(w, spec)


def qmatmul(x: torch.Tensor, w: Weight, policy: QuantPolicy, site: str = "",
            act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) @ w (K, N) with the policy's quantization applied.
    `site` is the weight's "/"-joined param-tree address: it feeds the
    calibration tape when one is active (raw and quantized weights
    alike), and names the site when a static-scale policy arrives
    without a calibrated scale."""
    calibration.tap(site, x)
    if isinstance(w, QuantizedTensor):
        if (policy.abits and policy.act_scale_mode == "static"
                and act_scale is None and policy.static_act_scale is None):
            raise calibration.MissingStaticScaleError([site or "<unknown>"])
        return backends.dispatch(x, w, policy, act_scale=act_scale)
    cdt = backends.base.torch_dtype(policy.compute_dtype)
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


def quantize_params(params, policy: QuantPolicy, min_size: int = 4096):
    """Map PTQ over a parameter tree: every linear weight whose site
    resolves to an enabled policy quantizes; norms, biases and small
    tensors stay fp. Sizes are per layer (the port keeps layers
    unrolled)."""
    if not policy.enabled:
        return params

    def one(path, w):
        if not (is_linear_weight(path, w) and w.ndim == 2
                and w.numel() >= min_size and w.shape[-2] % 2 == 0):
            return w
        site_policy = resolve(policy, path)
        if not site_policy.enabled:
            return w
        return quantize_weight(w.to(torch.float32), site_policy)

    return _map_tree(params, one)
