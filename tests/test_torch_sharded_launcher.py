"""The training launcher's `--mesh`, checkpoints across plans, the dry
run and the collective half of `roofline/`, on the CPU:

- `launch/train.py --mesh 1x2` in 2 gloo ranks (`_torch_dist.spawn`):
  4 steps of `qwen1.5-0.5b-smoke` (dp_only: FSDP over both ranks), the
  losses within rtol 1e-3 of the one-device launcher's (measured: 6e-5)
  and equal on both ranks; its step-2 checkpoint (written by rank 0 in
  the one-device layout) resumes on one device, steps 3-4 within 1e-3
  of the mesh's, and its step-4 checkpoint restores in the reference's
  `ckpt.restore` (every leaf's shape and dtype the reference's own
  state's); a one-device checkpoint of step 2 resumes on the mesh, steps
  3-4 within 1e-3 of the one-device run's;
- the dry run of the smoke dense train cell in a child process over a
  fake group of 8 ranks on a (2, 4) mesh: "ok", its per-rank argument
  bytes the reference's per-device state bytes (`NamedSharding
  .shard_shape` over the 8 forced CPU devices) plus this rank's rows of
  the int64 batch, its note the reference's;
- `count_collectives`, `collective_bytes`, `reanalyze` and `report` on
  fixed records.
"""
from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as j_get_config
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.launch import specs as jspecs
from repro.models.model import build_model as j_build_model
from repro.optim.adamw import AdamW as JAdamW
from repro.train import train_step as jts
from repro_torch.checkpoint import ckpt
from repro_torch.launch import train as tlaunch
from repro_torch.roofline import analysis, hw, reanalyze, report

from _torch_dist import one_torch_thread, spawn  # noqa: F401

DENSE = "qwen1.5-0.5b-smoke"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = ["--arch", DENSE, "--steps", "4", "--batch", "4", "--seq", "16",
          "--ckpt-every", "2", "--seed", "0"]


def _one_device_launch(ckpt_dir=None):
    argv = LAUNCH + (["--ckpt-dir", ckpt_dir] if ckpt_dir else [])
    return tlaunch.run(argv, device="cpu", log_fn=lambda *a: None)


@functools.lru_cache(maxsize=None)
def _one_device_losses():
    return _one_device_launch()["history"]["loss"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The launcher's --mesh 1x2 in 2 ranks, twice: from scratch
    (checkpoints every 2 steps in `mesh_ckpt`), and resumed from a
    one-device checkpoint of step 2 (`one_ckpt`)."""
    tmp = tmp_path_factory.mktemp("sharded_launch")
    one_ckpt = str(tmp / "one_ckpt")
    _one_device_launch(one_ckpt)
    shutil.rmtree(os.path.join(one_ckpt, "step_00000004"))
    mesh_ckpt = str(tmp / "mesh_ckpt")
    mesh = ["--mesh", "1x2", "--ckpt-dir"]
    got = spawn(2, [("launch", "train_launcher",
                     dict(argv=LAUNCH + mesh + [mesh_ckpt])),
                    ("resume", "train_launcher",
                     dict(argv=LAUNCH + mesh + [one_ckpt]))], tmp)
    for r, res in enumerate(got):
        for name in ("launch", "resume"):
            if isinstance(res[name], str):
                pytest.fail(f"rank {r} case {name}: {res[name]}")
    return {"ranks": got, "mesh_ckpt": mesh_ckpt}


def test_launcher_mesh_trains_like_one_device(ranks):
    recs = [r["launch"] for r in ranks["ranks"]]
    for rec in recs:
        assert rec["history"]["step"] == [1, 2, 3, 4]
        np.testing.assert_allclose(rec["history"]["loss"],
                                   _one_device_losses(), rtol=1e-3)
        assert "dp_only(FSDP)" in rec["note"]
        assert "data=1, model=2" in rec["mesh"]
    assert recs[0]["history"]["loss"] == recs[1]["history"]["loss"]
    assert recs[0]["param_bytes"] == recs[1]["param_bytes"]


def test_mesh_checkpoint_restores_on_one_device_and_in_the_reference(
        ranks, tmp_path):
    mesh_ckpt = ranks["mesh_ckpt"]
    assert ckpt.latest_step(mesh_ckpt) == 4
    # one device resumes the mesh's run from its step-2 checkpoint
    resumed = str(tmp_path / "resume")
    shutil.copytree(os.path.join(mesh_ckpt, "step_00000002"),
                    os.path.join(resumed, "step_00000002"))
    again = _one_device_launch(resumed)["history"]
    mesh = ranks["ranks"][0]["launch"]["history"]
    assert again["step"] == [3, 4]
    np.testing.assert_allclose(again["loss"], mesh["loss"][2:], rtol=1e-3)
    # the reference reads the mesh's step-4 checkpoint into its state
    jmodel = j_build_model(j_get_config(DENSE), JQuantPolicy())
    jopt = JAdamW(moment_dtype=jnp.bfloat16)
    template = jax.eval_shape(lambda: jts.init_state(
        jmodel, jopt, jax.random.PRNGKey(0)))
    zeros = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), template)
    got = jckpt.restore(mesh_ckpt, 4, {"state": zeros})["state"]
    assert int(got.opt.step) == 4
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(zeros)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert float(jnp.abs(got.params["embed"]["table"]).max()) > 0


def test_one_device_checkpoint_resumes_on_the_mesh(ranks):
    for rec in (r["resume"] for r in ranks["ranks"]):
        assert rec["history"]["step"] == [3, 4]
        np.testing.assert_allclose(rec["history"]["loss"],
                                   _one_device_losses()[2:], rtol=1e-3)


DRY_CHILD = (
    "import json, sys\n"
    "from repro_torch.launch import dryrun, mesh\n"
    "dryrun.fake_group(8)\n"
    "m = mesh.make_mesh((2, 4), ('data', 'model'))\n"
    f"rec = dryrun.run_cell({DENSE!r}, 'train_4k', 'fake8', 'none',\n"
    "                       sys.argv[1], mesh_override=m)\n"
    "print(json.dumps(rec))\n")


def test_dry_run_of_a_smoke_cell_over_a_fake_group(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", DRY_CHILD, str(tmp_path)],
                         capture_output=True, text=True, env=env,
                         timeout=240, check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok", rec.get("trace")
    assert os.path.exists(tmp_path / f"{DENSE}__train_4k__fake8__none.json")
    # the reference's per-device state bytes on 8 forced CPU devices
    jmesh = jax.make_mesh((2, 4), ("data", "model"))
    cell = jspecs.build_train_cell(DENSE, "train_4k", jmesh)
    state_sds, batch_sds = cell.args_sds
    want = sum(int(np.prod(sh.shard_shape(s.shape))) * s.dtype.itemsize
               for s, sh in zip(jax.tree_util.tree_leaves(state_sds),
                                jax.tree_util.tree_leaves(
                                    cell.in_shardings[0])))
    # the port's batch is int64 (the reference's int32): 8 bytes a token
    gb, seq = batch_sds["tokens"].shape
    want += 2 * (gb // 8) * seq * 8
    assert rec["memory_analysis"]["argument_size_per_chip"] == want
    assert rec["note"] == cell.note
    assert rec["collective_ops"]["all-gather"] > 0
    assert rec["roofline"]["coll_bytes_per_chip"] == \
        rec["collective_bytes"]["total"] > 0


STATS = {"all_gather": 3, "sum": 2, "bytes": 700,
         "all_gather_bytes": 400, "sum_bytes": 300}


def test_collective_counts_and_bytes():
    assert analysis.count_collectives(STATS) == {"all-gather": 3,
                                                 "rank-sum": 2}
    assert analysis.collective_bytes(STATS) == {
        "all-gather": 400.0, "rank-sum": 300.0, "total": 700.0}
    assert analysis.count_collectives({}) == {}
    assert analysis.collective_bytes({}) == {"total": 0.0}


def _record(tag):
    return {"cell": tag, "status": "ok", "note": "dp_only(FSDP)",
            "collective_ops": {"all-gather": 3},
            "collective_bytes": {"all-gather": 900e9, "total": 900e9},
            "roofline": {"flops_per_chip": 1e12, "bytes_per_chip": 3.35e9,
                         "coll_bytes_per_chip": 0.0, "n_chips": 256,
                         "model_flops_global": 2.56e14,
                         "arg_bytes_per_chip": 1.0}}


def test_reanalyze_and_report_on_fixed_records(tmp_path, capsys):
    recs = {"qwen1.5-0.5b__train_4k__single__none":
            _record("qwen1.5-0.5b__train_4k__single__none"),
            "yi-6b__train_4k__single__none": {
                "cell": "yi-6b__train_4k__single__none", "status": "error",
                "error": "ValueError: boom"},
            "xlstm-350m__long_500k__single__none": {
                "cell": "xlstm-350m__long_500k__single__none",
                "status": "skipped", "reason": "why not"}}
    for tag, rec in recs.items():
        with open(tmp_path / f"{tag}.json", "w") as f:
            json.dump(rec, f)
    assert reanalyze.main(["--out", str(tmp_path)]) == 0
    with open(tmp_path / "qwen1.5-0.5b__train_4k__single__none.json") as f:
        r = json.load(f)["roofline"]
    # the collective term: the record's bytes over NVLink, 2 s
    assert r["coll_bytes_per_chip"] == 900e9
    assert r["t_collective_s"] == pytest.approx(900e9 / hw.NVLINK_BW)
    assert r["t_memory_s"] == pytest.approx(1e-3)
    assert r["bottleneck"] == "collective"
    assert r["collective_counts"] == {"all-gather": 3}
    assert "reanalyzed 1 cells" in capsys.readouterr().out
    assert report.main(["--out", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    rows = [ln for ln in text.splitlines() if ln.startswith("| ")][1:]
    # the reference's order: qwen1.5-0.5b, yi-6b, xlstm-350m
    assert [ln.split("|")[1].strip() for ln in rows] == \
        ["qwen1.5-0.5b", "yi-6b", "xlstm-350m"]
    assert "**collective**" in rows[0] and "ERROR" in rows[1] \
        and "skipped" in rows[2]
    assert "most_collective: qwen1.5-0.5b x train_4k" in text
