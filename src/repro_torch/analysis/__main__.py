"""CLI: ``python -m repro_torch.analysis``; exit 1 on any finding.

Runs the four static passes by default. `--sanitize-smoke` instead
serves under REPRO_SANITIZE=1 and audits the engine's compiled steps:
on the card by default, at the full published width of Qwen1.5-0.5B
(`olive_serve`: W4 weights and the 4-bit KV cache, slab, captured
steps, 4 prompts of 8 new tokens through K1 `fp`, K2 and K7 with the
checks in); `--device cpu` runs it at smoke size on the plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import PASS_NAMES, run_all

SMOKE_ARCH = "qwen1.5-0.5b"
SMOKE_KERNELS = ("ovp_matmul[fp]", "decode_attn", "ovp_encode")


def sanitize_smoke(device: str = "cuda") -> dict:
    """Serve `SMOKE_ARCH` (its `-smoke` variant on the CPU) through the
    launcher under REPRO_SANITIZE=1 with the logits check configured,
    then audit the engine's trace ledger (`sanitize.audit_traces`).
    Returns the audit, the kernels' launch counts, the checks placed and
    the tokens served; raises on a failed check or an unexpected
    rebuild, and on the card when K1 `fp`, K2 or K7 did not launch."""
    os.environ["REPRO_SANITIZE"] = "1"
    from repro_torch.analysis import sanitize
    from repro_torch.launch import serve
    sanitize.configure()
    arch = SMOKE_ARCH if device != "cpu" else SMOKE_ARCH + "-smoke"
    serve.reset_kernel_launches()
    res = serve.run(["--arch", arch, "--quant", "olive_serve",
                     "--requests", "4", "--max-new", "8", "--slots", "4",
                     "--max-len", "256", "--seed", "0"], device=device)
    launches = serve.kernel_launches()
    audit = sanitize.audit_traces(res["engine"])
    out = {"arch": arch, "device": str(res["engine"].device),
           "audit": audit, "tokens": res["tokens"],
           "checks": sanitize.check_counts(),
           "launches": {k: launches[k] for k in SMOKE_KERNELS}}
    if res["engine"].device.type == "cuda" and \
            not all(out["launches"].values()):
        raise AssertionError(f"sanitize smoke: a kernel of the path did not "
                             f"launch: {out['launches']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static contract checker of the port: vocabulary, "
                    "kernel launch contracts, policy resolution, "
                    "exception hygiene.")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASS_NAMES, default=None,
                    help="run only this pass (repeatable; default: all)")
    ap.add_argument("--fixture", action="append", default=[],
                    help="extra .py module folded into the scan/case set "
                         "(seeded-violation fixtures)")
    ap.add_argument("--smem-budget", type=int, default=None,
                    help="shared memory a block may use, in bytes "
                         "(default 232448, the H100's opt-in maximum)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as a JSON array")
    ap.add_argument("--sanitize-smoke", action="store_true",
                    help="instead of the static passes, serve under "
                         "REPRO_SANITIZE=1 and audit the compiled steps")
    ap.add_argument("--device", default="cuda",
                    help="the sanitize smoke's device: cuda (full width, "
                         "the default) or cpu (smoke size)")
    args = ap.parse_args(argv)

    if args.sanitize_smoke:
        print(f"sanitize smoke OK: {json.dumps(sanitize_smoke(args.device))}")
        return 0

    findings = run_all(passes=tuple(args.passes or PASS_NAMES),
                       fixtures=tuple(args.fixture),
                       smem_budget=args.smem_budget)
    if args.json:
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        for f in findings:
            print(f)
        print(f"repro_torch.analysis: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
