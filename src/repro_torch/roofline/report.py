"""Roofline report: the dry run's records -> markdown tables, with the
reference's columns, order and hillclimb picks. Port of
`repro/roofline/report.py` (its records under `build/dryrun`, where the
port's dry run writes them).

  PYTHONPATH=src python -m repro_torch.roofline.report [--mesh single] [--quant none]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

ARCH_ORDER = ["minitron-8b", "qwen2-7b", "qwen1.5-0.5b", "yi-6b",
              "recurrentgemma-9b", "xlstm-350m", "qwen3-moe-30b-a3b",
              "grok-1-314b", "internvl2-1b", "seamless-m4t-large-v2"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(out_dir: str, mesh: str, quant: str) -> List[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        parts = os.path.basename(p)[:-5].split("__")
        if len(parts) != 4:
            continue
        arch, shape, m, q = parts
        if m == mesh and q == quant:
            r.update(arch=arch, shape=shape)
            recs.append(r)
    recs.sort(key=lambda r: (ARCH_ORDER.index(r["arch"])
                             if r["arch"] in ARCH_ORDER else 99,
                             SHAPE_ORDER.index(r["shape"])
                             if r["shape"] in SHAPE_ORDER else 99))
    return recs


def fmt(x, nd=3):
    if x == 0:
        return "0"
    if x >= 100 or x < 0.01:
        return f"{x:.2e}"
    return f"{x:.{nd}g}"


def table(recs: List[dict]) -> str:
    hdr = ("| arch | shape | t_comp (s) | t_mem (s) | t_coll (s) | "
           "bottleneck | MODEL_FL/HLO_FL | MFU@bound | note |")
    sep = "|" + "---|" * 9
    rows = [hdr, sep]
    for r in recs:
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"skipped | — | — | {r['reason'][:40]}… |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"ERROR | — | — | {r['error'][:40]} |")
            continue
        f = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt(f['t_compute_s'])} | "
            f"{fmt(f['t_memory_s'])} | {fmt(f['t_collective_s'])} | "
            f"**{f['bottleneck']}** | {fmt(f['useful_flops_ratio'])} | "
            f"{100*f['mfu_bound']:.1f}% | {r.get('note','')[:46]} |")
    return "\n".join(rows)


def pick_hillclimb(recs: List[dict]) -> Dict[str, dict]:
    ok = [r for r in recs if r["status"] == "ok"]
    worst_mfu = min((r for r in ok if r["shape"] == "train_4k"),
                    key=lambda r: r["roofline"]["mfu_bound"], default=None)
    coll = max(ok, key=lambda r: (r["roofline"]["t_collective_s"]
                                  / max(r["roofline"]["t_bound_s"], 1e-12)),
               default=None)
    return {"worst_mfu_train": worst_mfu, "most_collective": coll}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--quant", default="none")
    args = ap.parse_args(argv)
    recs = load(args.out, args.mesh, args.quant)
    print(f"## Roofline — mesh={args.mesh}, quant={args.quant}, "
          f"{len(recs)} cells\n")
    print(table(recs))
    picks = pick_hillclimb(recs)
    print("\nhillclimb candidates:")
    for k, r in picks.items():
        if r:
            print(f"  {k}: {r['arch']} x {r['shape']} "
                  f"(mfu={100*r['roofline']['mfu_bound']:.1f}%, "
                  f"bottleneck={r['roofline']['bottleneck']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
