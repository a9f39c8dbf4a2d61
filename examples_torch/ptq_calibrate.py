"""The paper's §3.4 quantization framework end to end, on the port.
Port of `examples/ptq_calibrate.py`:

  1. take the trained bench-lm fixture (`fixture.trained_lm`),
  2. run one batch of *training-set* data through it collecting
     activation tapes (the paper's calibration setting),
  3. MSE-search static activation scales seeded at 3σ,
  4. PTQ weights with OVP, evaluate W4A4 (dynamic scales), W4 and int4,
  5. rank the sites by their W4 SQNR and evaluate the `auto_mixed`
     program, then report perplexity against fp32.

Run:  PYTHONPATH=src python examples_torch/ptq_calibrate.py

On the card every quantized linear runs the fused OVP matmul (K1: `fp`
mode for W4 and W8 weights, `quantize` mode for W4A4).

The reference ranks the sites of its scanned tree (`blocks/<j>/<leaf>`,
the stack of the layers at period position j) and serves the program on
that tree. The port's layers are always unrolled, so it ranks the same
stacks (`convert.params_to_reference`) and gives each promoted stack's
rule to every layer in it (`unrolled_program`); the reference's
`adapt_params` has no counterpart.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples_torch import fixture  # noqa: E402

from repro_torch.convert import params_to_reference  # noqa: E402
from repro_torch.core.calibration import (ActTape, auto_mixed,  # noqa: E402
                                          calibrate_activation_scales,
                                          record_weights, site_sensitivity)
from repro_torch.core.policy import (PolicyProgram, QuantPolicy,  # noqa: E402
                                     Rule)
from repro_torch.core.qlinear import quantize_params  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

W4 = QuantPolicy(method="olive", wbits=4, abits=0, compute_dtype="float32")
W8 = QuantPolicy(method="olive", wbits=8, abits=0, w_normal_dtype="int8",
                 compute_dtype="float32")
POLICIES = (
    ("olive_w4a4_dyn", QuantPolicy(method="olive", wbits=4, abits=4,
                                   compute_dtype="float32")),
    ("olive_w4", W4),
    ("int4_w4", QuantPolicy(method="int", wbits=4, abits=0,
                            compute_dtype="float32")),
)


def unrolled_program(prog: PolicyProgram, cfg) -> PolicyProgram:
    """`prog` with each rule on a scanned-tree site (`blocks/<j>/<leaf>`,
    `tail/<t>/<leaf>`) replaced by the same rule on every layer that
    site stacks (`layers/<i>/<leaf>`), in place."""
    period = len(cfg.block_pattern)
    n_full = cfg.n_layers // period * period
    rules = []
    for r in prog.rules:
        parts = r.pattern.split("/", 2)
        if len(parts) == 3 and parts[0] == "blocks":
            layers = range(int(parts[1]), n_full, period)
        elif len(parts) == 3 and parts[0] == "tail":
            layers = (n_full + int(parts[1]),)
        else:
            rules.append(r)
            continue
        rules += [Rule(f"layers/{i}/{parts[2]}", r.policy, r.origin)
                  for i in layers]
    return PolicyProgram(rules=tuple(rules), default=prog.default,
                         name=prog.name)


@torch.no_grad()
def calibrate(model_fp, params, loader) -> dict:
    """Static activation scales (3σ-seeded MSE search) of the embedding
    output and the logits' first 64 columns, taped on training batch 0
    on the params' device."""
    device = fixture.device_of(params)
    tape = ActTape(max_per_site=32768)
    batch = {k: v.to(device) for k, v in loader.batch_at(0).items()}
    logits, _, _ = model_fp.forward(params, batch, mode="train")
    # tape the embedding output and logits input as representative sites
    tape.record("embed_out", params["embed"]["table"][batch["tokens"]])
    tape.record("head_in", logits[..., :64])  # subsample
    return {k: float(v) for k, v in calibrate_activation_scales(
        tape, "int4", device=device).items()}


def quantized_rows(model_fp, params, loader) -> dict:
    """Held-out perplexity in fp32 and under each of `POLICIES`."""
    rows = {"fp32": fixture.eval_ppl(model_fp, params, loader)}
    for tag, pol in POLICIES:
        rows[tag] = fixture.eval_ppl(build_model(model_fp.cfg, pol,
                                                 remat=False),
                                     quantize_params(params, pol), loader)
    return rows


def sensitivity(model_fp, params):
    """(W4 SQNR in dB by site, the three most sensitive sites, the sites
    `auto_mixed` promotes to W8 within a 5-bit budget, its program
    unrolled onto the port's layers)."""
    cfg = model_fp.cfg
    # per-site SQNR at 4 bits on the weight tape ranks the sites; the
    # emitted program keeps the most sensitive ones at W8 within a
    # 5-bit average budget (see docs/policies.md)
    sens = site_sensitivity(record_weights(params_to_reference(params, cfg)),
                            "int4", n_grid=8,
                            device=fixture.device_of(params))
    worst = sorted(sens, key=lambda k: sens[k])[:3]
    prog = auto_mixed(sens, budget_bits=5.0, low=W4, high=W8)
    promoted = [r.pattern for r in prog.rules if r.origin != "compat"]
    return sens, worst, promoted, unrolled_program(prog, cfg)


def verdict(rows) -> bool:
    return rows["olive_w4a4_dyn"] < rows["int4_w4"] * 1.02 \
        and rows["olive_w4"] / rows["fp32"] < 1.05


def calibrate_and_eval(model_fp, params, loader) -> dict:
    """The example on `params`' device: {"scales", "rows": held-out
    perplexity by policy, "sens", "worst", "promoted", "ok": the
    verdict}."""
    scales = calibrate(model_fp, params, loader)
    rows = quantized_rows(model_fp, params, loader)
    sens, worst, promoted, prog = sensitivity(model_fp, params)
    rows["olive_auto_w48"] = fixture.eval_ppl(
        build_model(model_fp.cfg, prog, remat=False),
        quantize_params(params, prog), loader)
    return {"scales": scales, "rows": rows, "sens": sens, "worst": worst,
            "promoted": promoted, "ok": verdict(rows)}


def main(argv=None, device="cuda") -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]) \
        .parse_args(argv)
    model_fp, params, loader = fixture.trained_lm(device=device)
    r = calibrate_and_eval(model_fp, params, loader)
    print("calibrated static activation scales (3σ-seeded MSE search):")
    for k, v in r["scales"].items():
        print(f"  {k}: {v:.5f}")
    print("\nmost sensitive sites (lowest W4 SQNR):")
    for k in r["worst"]:
        print(f"  {k}: {r['sens'][k]:.1f} dB")
    rows = r["rows"]
    print("\nheld-out perplexity:")
    for k, v in rows.items():
        print(f"  {k:16s} {v:8.3f}  (+{100*(v/rows['fp32']-1):6.2f}%)")
    print("OK" if r["ok"] else "DEGRADED")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
