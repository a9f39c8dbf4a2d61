"""Re-derive the roofline terms of the dry run's saved records from the
counts they hold, with no new trace: port of
`repro/roofline/reanalyze.py`. Used when the hardware constants or the
roofline model change (`hw`, `analysis.Roofline`).

The reference re-parsed each cell's saved HLO; a port record keeps what
its `Roofline` was built from (the step's FLOPs and bytes a chip from
`step_stats`, the collective bytes a rank received from the traced
step's `collective_stats`), so the terms are recomputed from those.

  PYTHONPATH=src python -m repro_torch.roofline.reanalyze [--out build/dryrun]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .analysis import Roofline


def reanalyze_cell(json_path: str) -> bool:
    """Rewrite one record's "roofline" from its counts; False for a
    record that is not "ok"."""
    with open(json_path) as f:
        rec = json.load(f)
    if rec.get("status") != "ok":
        return False
    old = rec["roofline"]
    r = Roofline(
        flops_per_chip=float(old["flops_per_chip"]),
        bytes_per_chip=float(old["bytes_per_chip"]),
        coll_bytes_per_chip=float(
            rec.get("collective_bytes", {}).get("total",
                                                old["coll_bytes_per_chip"])),
        n_chips=old["n_chips"],
        model_flops_global=old["model_flops_global"],
        arg_bytes_per_chip=old.get("arg_bytes_per_chip", 0.0),
        raw_cost_analysis=old.get("raw_cost_analysis"),
        collective_counts=rec.get("collective_ops"),
        flags=old.get("flags"))
    rec["roofline"] = r.as_dict()
    with open(json_path, "w") as f:
        json.dump(rec, f, indent=1)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    n = 0
    for p in sorted(glob.glob(os.path.join(args.out, "*.json"))):
        if reanalyze_cell(p):
            n += 1
            with open(p) as f:
                r = json.load(f)["roofline"]
            print(f"{os.path.basename(p)[:-5]}: "
                  f"mem={r['t_memory_s']:.3g}s coll={r['t_collective_s']:.3g}s "
                  f"comp={r['t_compute_s']:.3g}s -> {r['bottleneck']}")
    print(f"reanalyzed {n} cells")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
