"""What the tests of `examples_torch/` share: the reference's bench-lm
fixture, the port's, and a loader that feeds the port the reference's
batches (the two packages' corpora draw different tokens)."""
from __future__ import annotations

import numpy as np
import torch


class RefBatches:
    """A loader that hands the port the reference loader's batches."""

    def __init__(self, loader):
        self.loader = loader

    def batch_at(self, step, rank=0, eval_split=False):
        b = self.loader.batch_at(step, eval_split=eval_split)
        return {k: torch.from_numpy(np.array(v)).to(torch.int64)
                for k, v in b.items()}


def fixtures():
    """((model, params, loader) of the reference's `trained_lm(30)`, the
    same of the port's on the CPU)."""
    from benchmarks import common
    from examples_torch import fixture
    return common.trained_lm(steps=30), fixture.trained_lm(steps=30,
                                                           device="cpu")


SERVE_REQUESTS, SERVE_NEW = 6, 8    # the serving tests' cut of 12 x 24


def ref_serve(mode: str, with_fp: bool = True):
    """The reference example's serving run in `mode` ("w4", "kv4", "w8",
    "mixed") at `SERVE_REQUESTS` x `SERVE_NEW` on its bench-lm fixture:
    ({uid: tokens} of the fp32 engine (None unless `with_fp`), the same
    of the quantized one); and the port's `serve()` result on its own
    fixture on the CPU."""
    import jax
    from examples_torch import serve_quantized
    from repro.core.policy import PolicyProgram, QuantPolicy
    from repro.core.qlinear import quantize_params
    from repro.models.model import build_model
    from repro.serve.engine import EngineCfg, ServingEngine

    (jmodel, jparams, _), (model, params, _) = fixtures()
    cfg = jmodel.cfg
    kv = 4 if mode == "kv4" else 0
    w4 = QuantPolicy(method="olive", wbits=4, abits=0,
                     compute_dtype="float32", kv_bits=kv)
    w8 = QuantPolicy(method="olive", wbits=8, abits=0,
                     w_normal_dtype="int8", compute_dtype="float32",
                     kv_bits=kv)
    pol = w8 if mode == "w8" else w4
    if mode == "mixed":
        w8kv = QuantPolicy(method="olive", wbits=8, abits=0,
                           w_normal_dtype="int8", compute_dtype="float32",
                           kv_bits=4)
        pol = PolicyProgram.from_policy(w4, name="mixed_w48").with_rules([
            ("layers/0/*", w8kv), (f"layers/{cfg.n_layers - 1}/*", w8kv)])
    prompts = serve_quantized.prompts(cfg.vocab, SERVE_REQUESTS)

    def run(m, p):
        eng = ServingEngine(m, p, EngineCfg(batch_slots=4, max_len=192))
        for q in prompts:
            eng.submit(q, max_new_tokens=SERVE_NEW)
        return {r.uid: list(r.out_tokens) for r in eng.run_until_drained()}

    model_q = build_model(cfg, pol, remat=False)
    qparams = jax.jit(quantize_params, static_argnums=1)(
        model_q.adapt_params(jparams), pol)
    want = (run(jmodel, jparams) if with_fp else None, run(model_q, qparams))
    got = serve_quantized.serve(model, params, SERVE_REQUESTS, SERVE_NEW,
                                kv4=mode == "kv4", w8=mode == "w8",
                                mixed=mode == "mixed")
    return want, got


def agreement(outs_fp, outs_q) -> float:
    """The example's greedy-token agreement of two runs' tokens."""
    agree = []
    for uid, a in outs_fp.items():
        b = outs_q.get(uid, [])
        n = min(len(a), len(b))
        agree.append(np.mean([a[i] == b[i] for i in range(n)]) if n else 0)
    return float(np.mean(agree))
