"""End-to-end serving example on the port (the paper's deployment story).
Port of `examples/serve_quantized.py`.

Load the trained bench-lm fixture, OliVe-PTQ it to W4 (+ optional OVP
4-bit KV cache), and serve a batch of requests through the
continuous-batching engine. Reports: greedy-output agreement vs the
fp32 engine, weight footprint, and tokens/s.

`--mixed` serves a site-addressed policy *program* instead of a flat
policy: first/last layer W8 (+ OVP KV cache there), middle layers W4.

Run:  PYTHONPATH=src python examples_torch/serve_quantized.py \
          [--kv4] [--w8 | --mixed]

On the card the engine captures its steps as CUDA graphs, and every
quantized linear launches the fused OVP matmul (K1), every decode step
the decode-attention kernel (K2) over each layer's cache, and every
write of a packed cache the OVP encoder (K7). `serve()` runs on the
params' device; on the CPU the kernels' plain versions run.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples_torch import fixture  # noqa: E402

from repro_torch.core.policy import PolicyProgram, QuantPolicy  # noqa: E402
from repro_torch.core.qlinear import quantize_params  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import EngineCfg, ServingEngine  # noqa: E402

footprint = fixture.footprint


def policy(cfg, kv4: bool = False, w8: bool = False, mixed: bool = False):
    """The served policy of the flags: W4, W8, or the mixed program
    (first/last layer W8 + KV4, middle layers W4), KV4 everywhere with
    `kv4`."""
    w4 = QuantPolicy(method="olive", wbits=4, abits=0,
                     compute_dtype="float32", kv_bits=4 if kv4 else 0)
    w8p = QuantPolicy(method="olive", wbits=8, abits=0,
                      w_normal_dtype="int8", compute_dtype="float32",
                      kv_bits=4 if kv4 else 0)
    if not mixed:
        return w8p if w8 else w4
    w8kv = QuantPolicy(method="olive", wbits=8, abits=0,
                       w_normal_dtype="int8", compute_dtype="float32",
                       kv_bits=4)
    return PolicyProgram.from_policy(w4, name="mixed_w48").with_rules([
        ("layers/0/*", w8kv),
        (f"layers/{cfg.n_layers - 1}/*", w8kv),
    ])


def prompts(vocab: int, n: int):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=rng.integers(4, 24))
            .astype(np.int32) for _ in range(n)]


def run_engine(model, params, prompts, max_new: int = 24):
    """Serve `prompts` greedily on the params' device; returns ({uid:
    tokens}, tok/s, the engine)."""
    eng = ServingEngine(model, params, EngineCfg(batch_slots=4, max_len=192),
                        device=fixture.device_of(params))
    t0 = time.time()
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    done = eng.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    return {r.uid: list(r.out_tokens) for r in done}, toks / dt, eng


def serve(model_fp, params, n_requests: int = 12, max_new: int = 24,
          kv4: bool = False, w8: bool = False, mixed: bool = False
          ) -> dict:
    """The example on `params`' device: {"fp_bytes", "q_bytes": the
    footprints, "outs_fp", "outs_q": tokens by uid, "tps_fp", "tps_q",
    "agree": greedy-token agreement, "ok": the verdict, "qparams",
    "engine_fp", "engine_q": the drained engines}."""
    cfg = model_fp.cfg
    pol = policy(cfg, kv4, w8, mixed)
    model_q = build_model(cfg, pol, remat=False)
    qparams = quantize_params(params, pol)
    reqs = prompts(cfg.vocab, n_requests)
    outs_fp, tps_fp, eng_fp = run_engine(model_fp, params, reqs, max_new)
    outs_q, tps_q, eng_q = run_engine(model_q, qparams, reqs, max_new)
    agree = []
    for uid in outs_fp:
        a, b = outs_fp[uid], outs_q.get(uid, [])
        n = min(len(a), len(b))
        agree.append(np.mean([a[i] == b[i] for i in range(n)]) if n else 0)
    agree = float(np.mean(agree))
    return {"fp_bytes": footprint(params), "q_bytes": footprint(qparams),
            "outs_fp": outs_fp, "outs_q": outs_q, "tps_fp": tps_fp,
            "tps_q": tps_q, "agree": agree, "ok": agree > 0.85,
            "qparams": qparams, "engine_fp": eng_fp, "engine_q": eng_q}


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kv4", action="store_true",
                    help="also OVP-quantize the KV cache (beyond-paper)")
    ap.add_argument("--w8", action="store_true", help="W8A8 instead of W4")
    ap.add_argument("--mixed", action="store_true",
                    help="per-layer mixed program: first/last W8+KV4, "
                         "middle W4")
    ap.add_argument("--n-requests", type=int, default=12)
    args = ap.parse_args(argv)

    model_fp, params, _ = fixture.trained_lm(device=device)
    r = serve(model_fp, params, args.n_requests, kv4=args.kv4, w8=args.w8,
              mixed=args.mixed)
    print(f"weights: fp32 {r['fp_bytes']/1e6:.2f} MB -> olive "
          f"{r['q_bytes']/1e6:.2f} MB "
          f"({r['fp_bytes']/r['q_bytes']:.2f}x)")
    print(f"served {len(r['outs_fp'])} requests, continuous batching over 4 "
          f"slots")
    print(f"fp32 engine: {r['tps_fp']:.1f} tok/s | olive engine: "
          f"{r['tps_q']:.1f} tok/s")
    print(f"greedy-token agreement fp32 vs olive: {100*r['agree']:.1f}%")
    print("OK" if r["ok"] else "DEGRADED (check quantization)")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
