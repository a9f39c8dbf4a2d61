"""The port's launcher on its calibrate-then-serve path, at smoke size on
the CPU: `--calibrate --calibration PATH` calibrates on the reference
launcher's synthetic batch, saves and serves; `--calibration PATH` alone
loads and serves; slab and paged (`--paged 16 --prefill-chunk 16`). The
artifact's sites are the reference launcher's for the same arch.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.core import calibration as jcal
from repro.core import policy as jpol
from repro.models.model import build_model as j_build_model
from repro_torch import backends as tbackends
from repro_torch.launch import serve
from _torch_dist import one_torch_thread  # noqa: F401 (autouse)

STATIC = dict(compute_dtype="float32", act_scale_mode="static")


@functools.lru_cache(maxsize=None)
def _jax_launcher_sites():
    """The sites the reference launcher calibrates for the smoke arch:
    its synthetic (2, 64) batch from seed 0 through `calibrate_model`."""
    cfg = j_get_config("qwen1.5-0.5b-smoke")
    policy = jpol.OLIVE_SERVE.replace_all(**STATIC)
    model = j_build_model(cfg, policy, remat=False)
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    batch = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 64)) \
        .astype(np.int32)
    return jcal.calibrate_model(model, params,
                                [{"tokens": jnp.asarray(batch)}]).sites()


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_launcher_calibrates_then_serves(paged, tmp_path):
    """`--calibrate --calibration PATH` calibrates, saves and serves;
    `--calibration PATH` alone loads and serves; both resolve every
    activation scale statically and run the static mode only."""
    path = str(tmp_path / "calib.json")
    args = ["--arch", "qwen1.5-0.5b-smoke", "--quant", "olive_serve",
            "--requests", "3", "--max-new", "3", "--slots", "2",
            "--max-len", "32", "--calibration", path]
    if paged:
        args += ["--paged", "16", "--prefill-chunk", "16"]
    results = []
    for extra in (["--calibrate"], []):
        tbackends.reset_act_scale_stats()
        res = serve.run(args + extra, device="cpu")
        stats = tbackends.act_scale_stats()
        assert stats.get("dynamic", 0) == 0 and stats["static"] > 0
        assert [len(r.out_tokens) for r in res["completed"]] == [3, 3, 3]
        results.append(res)
    made, loaded = (r["artifact"] for r in results)
    assert made.as_dict() == loaded.as_dict()
    assert made.sites() == _jax_launcher_sites()
    assert results[0]["tokens"] == results[1]["tokens"] == 9
    assert [r.out_tokens for r in results[0]["completed"]] == \
        [r.out_tokens for r in results[1]["completed"]]


def test_launcher_errors_like_reference(tmp_path):
    with pytest.raises(SystemExit):
        serve.run(["--arch", "qwen1.5-0.5b-smoke", "--calibrate"],
                  device="cpu")
    with pytest.raises(SystemExit):
        serve.run(["--arch", "qwen1.5-0.5b-smoke", "--calibration",
                   str(tmp_path / "missing.json")], device="cpu")
