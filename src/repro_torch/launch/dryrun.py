"""Multi-rank dry run: port of `repro/launch/dryrun.py`.

For every (architecture x input shape x mesh) cell it builds the cell
(`launch/specs.py`) with its arguments on "meta", runs its step once as
rank 0 of a fake process group of the production size
(`torch.testing`'s `FakeStore` with backend "fake": 256 ranks for
`single`, 512 for `multi`, `mesh.production_plan`), and writes a JSON
record in the reference's format under `--out`:

- `memory_analysis`: this rank's argument and output bytes, counted
  from its parts of every tensor (temp bytes are not measured on
  "meta": null);
- `collective_ops` and `collective_bytes`, from the step's
  `collective_stats` (`roofline.count_collectives`, `collective_bytes`);
- `roofline`: `roofline.step_stats`' count of this rank's work (the
  port gathers a layer's weights and computes it whole on every rank of
  a "model" group, so a rank computes its rows over whole weights) and
  the collective term;
- `trace_s` in place of the reference's `lower_s` and `compile_s`.

Nothing is computed and the card is not used: "meta" tensors carry
shapes only, the kernels' wrappers return their plain versions' shapes
on "meta", and the fake group's collectives move nothing. A loop of
equal iterations (attention's blocks, the xLSTM's chunks and tokens,
microbatches) is traced once and its collectives counted once an
iteration (`launch/mesh.py::loop`). A serve cell holds what the
reference's holds: every parameter as its `param_spec` part and every
cache as its `cache_pspecs` part (`launch/specs.py::build_serve_cell`). A cell that
fails is recorded as "error" with its traceback, and the CLI exits 1.
Records are incremental: a cell already written is kept unless
--force.

  python -m repro_torch.launch.dryrun                 # everything
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback


def fake_group(world_size: int) -> None:
    """Make this process rank 0 of a fake group of `world_size` ranks
    (replacing a fake group already running)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _roofline(cell, traced):
    """The roofline of this rank's step: its work counted by
    `step_stats` (on the cell's "meta" tensors) and the collective
    bytes it received."""
    from repro_torch.configs import get_shape
    from repro_torch.roofline import analysis, step_stats
    coll = traced["collectives"]
    cbytes = analysis.collective_bytes(coll)
    model = cell.model
    if cell.kind == "train":
        whole, batch = cell.args
        local = traced["held"][0]
        rows, seq = traced["held"][1]["labels"].shape
        stats = step_stats.train_step_stats(
            model, whole.params, rows, seq,
            opt_state=(local.opt.mu, local.opt.nu))
    else:
        params, caches, batch = traced["held"]
        rows = batch["tokens"].shape[0]
        if cell.kind == "decode":
            s = get_shape(cell.shape).seq_len
            stats = step_stats.decode_step_stats(model, params, caches,
                                                 [s - 1] * rows)
        else:
            stats = step_stats.prefill_step_stats(
                model, params, caches, batch["tokens"].shape[1], rows=rows,
                frames=batch["frames"].shape[1] if "frames" in batch else 0)
    return analysis.analyze(
        stats, cell.n_chips, cell.model_flops, per_chip=True,
        coll_bytes_per_chip=cbytes["total"],
        arg_bytes_per_chip=traced["arg_bytes"],
        collective_counts=analysis.count_collectives(coll)), cbytes


def run_cell(arch: str, shape_name: str, mesh_kind: str, quant: str,
             out_dir: str, force: bool = False, mesh_override=None,
             calibration=None, n_microbatches=None) -> dict:
    """Build, trace and record one cell (under a fake group already
    running, of the mesh's size; a train cell at `n_microbatches` when
    given)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.configs.base import shape_applicable
    from repro_torch.launch import mesh as meshmod
    from repro_torch.launch.specs import build_cell, trace_cell
    from repro_torch.roofline.analysis import count_collectives

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    tag = f"{arch}__{shape_name}__{mesh_kind}__{quant}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec = {"cell": tag, "status": "skipped", "reason": reason}
        _dump(path, rec)
        return rec
    if quant != "none" and shape.kind == "train":
        rec = {"cell": tag, "status": "skipped",
               "reason": "quantized variants are serving-only (PTQ)"}
        _dump(path, rec)
        return rec

    t0 = time.time()
    try:
        mesh = mesh_override if mesh_override is not None else \
            meshmod.make_production_mesh(multi_pod=(mesh_kind == "multi"))
        cell = build_cell(arch, shape_name, mesh, quant=quant,
                          calibration=calibration,
                          n_microbatches=n_microbatches)
        build_s = time.time() - t0
        traced = trace_cell(cell)
        roof, cbytes = _roofline(cell, traced)
        rec = {
            "cell": tag, "status": "ok",
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "quant": quant, "kind": cell.kind, "note": cell.note,
            "n_chips": cell.n_chips,
            "build_s": round(build_s, 2),
            "trace_s": round(traced["trace_s"], 2),
            "memory_analysis": {
                "argument_size_per_chip": traced["arg_bytes"],
                "output_size_per_chip": traced["out_bytes"],
                "temp_size_per_chip": None,
                "alias_size_per_chip": traced["alias_bytes"],
            },
            "collective_ops": count_collectives(traced["collectives"]),
            "collective_bytes": cbytes,
            "roofline": roof.as_dict(),
        }
    except (ValueError, TypeError, KeyError, AttributeError, IndexError,
            AssertionError, NotImplementedError, RuntimeError) as e:
        # a failing cell is a bug: record it loudly
        rec = {"cell": tag, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    _dump(path, rec)
    return rec


def _dump(path, rec):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--quant", default="none",
                    choices=["none", "olive", "olive_kv", "olive_w8"])
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="CalibrationArtifact JSON: trace the quantized "
                         "serve cells with static calibrated activation "
                         "scales baked in. Ignored for --quant none and "
                         "train shapes.")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch import mesh as meshmod
    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_skip = n_err = 0
    for mk in meshes:
        plan = meshmod.production_plan(multi_pod=mk == "multi")
        fake_group(plan.n_devices)
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mk, args.quant, args.out,
                               force=args.force,
                               calibration=args.calibration)
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_err += st == "error"
                line = f"[dryrun] {rec['cell']}: {st}"
                if st == "ok":
                    r = rec["roofline"]
                    line += (f"  bottleneck={r['bottleneck']}"
                             f" t_bound={r['t_bound_s']:.4g}s"
                             f" trace={rec['trace_s']:.1f}s")
                    print(line)
                    print("   memory_analysis:",
                          json.dumps(rec["memory_analysis"]))
                    print("   collectives:", json.dumps(
                        rec["collective_ops"]), "bytes/chip:",
                        json.dumps(rec["collective_bytes"]))
                    print("   cost: flops/chip=%.4g bytes/chip=%.4g "
                          "coll_bytes/chip=%.4g" % (
                              r["flops_per_chip"], r["bytes_per_chip"],
                              r["coll_bytes_per_chip"]))
                elif st == "skipped":
                    print(line + f"  ({rec['reason'][:70]}…)")
                else:
                    print(line + f"  {rec['error']}")
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
