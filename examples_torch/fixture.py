"""The bench-lm fixture the port's examples share: the part of
`benchmarks/common.py` that `examples/ptq_calibrate.py` and
`examples/serve_quantized.py` use, over the port.

`trained_lm()` is the small dense GQA transformer (4 layers, d_model
128, head_dim 32) whose trained weights the repo commits under
`EXPERIMENTS/bench_cache/bench_lm_<steps>.npz`. Unlike the reference it
never trains and never writes: a missing file raises, naming the file.
Its default step count comes from `BENCH_LM_STEPS`, as the reference's
does, but falls back to 30, the committed file (the reference's 400
would train).

Imports torch, numpy and `repro_torch` only.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_numpy, params_to_reference
from repro_torch.core.calibration import _sorted_paths
from repro_torch.core.ovp import MixedExpertQuant, QuantizedTensor
from repro_torch.core.policy import QuantPolicy
from repro_torch.data.loader import LoaderCfg, SyntheticLoader
from repro_torch.data.synthetic import CorpusCfg
from repro_torch.models.model import build_model
from repro_torch.train.train_step import lm_loss

CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "EXPERIMENTS", "bench_cache")

LM_STEPS = int(os.environ.get("BENCH_LM_STEPS", "30"))
LM_SEQ = 128
LM_BATCH = 16


def _lm_cfg() -> ArchConfig:
    return ArchConfig(
        name="bench-lm", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=384, vocab=512, head_dim=32,
        block_pattern=("attn",), source="in-repo benchmark fixture")


def _corpus() -> CorpusCfg:
    return CorpusCfg(vocab=512, seed=1234)


def check_device(device, what: str) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises,
    as the port's launchers do."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device")
    return device


def _fill(tree, leaves):
    """`tree` with its leaves replaced, in JAX's flatten order (dict keys
    sorted, lists in order: `calibration._sorted_paths`), by `leaves`."""
    if isinstance(tree, dict):
        return {k: _fill(v, leaves) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [_fill(v, leaves) for v in tree]
    return next(leaves)


def trained_lm(steps: int = LM_STEPS, device="cuda"):
    """Returns (model_fp, params_fp32, loader): the fp32 model, the
    committed weights of `bench_lm_<steps>.npz` on `device`, and the
    port's synthetic loader (16 x 128 tokens a batch).

    The file's arrays `a0..aN` are the reference's scanned tree in JAX's
    flatten order; the skeleton of that tree comes from the port's own
    model on "meta" (`convert.params_to_reference`), so no JAX runs."""
    device = check_device(device, "trained_lm")
    cfg = _lm_cfg()
    model = build_model(cfg, QuantPolicy(compute_dtype="float32"),
                        remat=False)
    loader = SyntheticLoader(LoaderCfg(global_batch=LM_BATCH,
                                       seq_len=LM_SEQ, corpus=_corpus()))
    path = os.path.normpath(os.path.join(CACHE, f"bench_lm_{steps}.npz"))
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path}: no committed bench-lm weights for {steps} steps (the "
            f"port never trains the fixture; BENCH_LM_STEPS=30 loads the "
            f"committed file)")
    skeleton = params_to_reference(model.init(None, device="meta"), cfg)
    order = _sorted_paths(skeleton)
    with np.load(path) as raw:
        if len(raw.files) != len(order):
            raise ValueError(f"{path}: {len(raw.files)} arrays, the "
                             f"bench-lm tree has {len(order)} leaves")
        flat = [raw[f"a{i}"] for i in range(len(order))]
    for (where, leaf), arr in zip(order, flat):
        if tuple(leaf.shape) != arr.shape:
            raise ValueError(f"{path}: {where} has shape {arr.shape}, the "
                             f"model's is {tuple(leaf.shape)}")
    params = params_from_numpy(_fill(skeleton, iter(flat)), device=device)
    return model, params, loader


def device_of(params) -> torch.device:
    """The device a bench-lm parameter tree lives on."""
    return params["final_norm"]["gamma_scale"].device


@torch.no_grad()
def eval_ppl(model, params, loader, n_batches: int = 4) -> float:
    """Held-out perplexity of a (possibly quantized) parameter set: exp
    of the mean CE (`train_step.lm_loss`, train mode) over the first
    `n_batches` batches of the loader's eval split, on the params'
    device."""
    device = device_of(params)
    tot = 0.0
    for s in range(n_batches):
        batch = {k: v.to(device) for k, v in
                 loader.batch_at(s, eval_split=True).items()}
        _, parts = lm_loss(model, params, batch)
        tot += float(parts["ce"])
    return float(np.exp(tot / n_batches))


def footprint(params) -> int:
    """Total parameter bytes, counting packed QuantizedTensor storage
    (`QuantizedTensor.nbytes()`: codes plus fp32 scales)."""
    if isinstance(params, QuantizedTensor):
        return params.nbytes()
    if isinstance(params, MixedExpertQuant):
        return sum(footprint(g) for g in params.groups)
    if isinstance(params, dict):
        return sum(footprint(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(footprint(v) for v in params)
    return params.numel() * params.element_size()
