"""repro_torch.analysis: every static pass is clean on the port, each
seeded-violation fixture (tests/fixtures/analysis_torch/) flags exactly
its code, the CLI's exit codes and JSON, the policy site universe equal
to the reference's for all ten archs, and the REPRO_SANITIZE=1 runtime
hooks (the reference's cases of tests/test_analysis.py, on the port)."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import policies as ref_policies
from repro_torch import analysis
from repro_torch.analysis import kernels as ak
from repro_torch.analysis import policies, sanitize
from repro_torch.analysis.__main__ import main, sanitize_smoke

from _torch_dist import one_torch_thread  # noqa: F401

FIX = Path(__file__).parent / "fixtures" / "analysis_torch"
FIXTURE_CODES = {
    "bad_vocab.py": "VOCAB_UNREGISTERED_CODE",
    "bad_pair_split.py": "KC_PAIR_SPLIT",
    "bad_shard_split.py": "KC_SHARD_SPLIT",
    "bad_aliasing.py": "KC_ALIAS_MISSING",
    "bad_smem.py": "KC_SMEM_BUDGET",
    "bad_dead_rule.py": "POL_DEAD_RULE",
    "bad_shadowed_rule.py": "POL_SHADOWED",
    "bad_dead_glob.py": "POL_DEAD_GLOB",
    "bad_hygiene.py": "HYG_BROAD_EXCEPT",
}


def _codes(findings):
    return {f.code for f in findings}


# ---------------------------------------------------------------- clean port
@pytest.mark.parametrize("name", analysis.PASS_NAMES)
def test_pass_clean_on_the_port(name):
    assert analysis.run_pass(name) == []


def test_unknown_pass_rejected():
    with pytest.raises(KeyError):
        analysis.run_pass("nope")


def test_every_fixture_is_listed():
    assert sorted(p.name for p in FIX.glob("*.py")) == sorted(FIXTURE_CODES)


# ------------------------------------------------------- seeded violations
@pytest.mark.parametrize("fixture", sorted(FIXTURE_CODES))
def test_fixture_flags_exactly_its_code(fixture):
    found = analysis.run_all(fixtures=(str(FIX / fixture),))
    assert _codes(found) == {FIXTURE_CODES[fixture]}, found


def test_unregistered_decline_code_named():
    found = analysis.run_pass("vocab", fixtures=(str(FIX / "bad_vocab.py"),))
    assert any("decode_q_rank_bad" in f.message for f in found)


def test_smem_budget_enforced():
    # a budget below every plan's shared memory trips the served launches
    found = analysis.run_pass("kernels", smem_budget=64)
    assert _codes(found) == {"KC_SMEM_BUDGET"}


def test_plan_short_of_its_body_flagged():
    from repro_torch.kernels import ovp_matmul as mm
    plan = dataclasses.replace(mm.launch_plan(4, 1024, 1024, "int4"),
                               smem=1024)
    found = ak._check_launch("short", ak.describe(plan, n=1024), 232448)
    assert [f.code for f in found] == ["KC_SMEM_BUDGET"]
    assert "reserves 1024" in found[0].message


def test_kernel_case_that_misses_its_launch_flagged():
    """A case whose entry runs the plain version whatever the device
    never reaches the launch: KC_NO_LAUNCH."""
    from repro_torch.kernels import ovp_encode as enc
    x = torch.randn((8, 16), generator=torch.Generator().manual_seed(0))
    case = ak.Case("plain_only", lambda: [],
                   build=lambda device: (enc.ovp_encode_plain, (x,)),
                   launch="ovp_encode:_launch")
    assert not ak._reaches_launch(case)
    assert all(ak._reaches_launch(c) for c in ak.repo_cases() if c.launch)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.mark.parametrize("case", ak.repo_cases(), ids=lambda c: c.name)
def test_case_builds_every_operand_on_the_device(case):
    """`build(device)` puts every operand on that device (the card in
    chip_smoke.py; "meta" here), and the plain version runs the case."""
    _, args = case.build("meta")
    assert {t.device.type for t in _tensors(args)} == {"meta"}
    fn, args = case.build("cpu")
    assert case.plain is not None and case.launch
    case.plain(*args)


def test_served_sweep_covers_every_arch_and_kernel():
    from repro_torch.configs import ARCHS
    names = [name for name, _ in ak.served_launches()]
    assert {n.split("/")[0] for n in names} == set(ARCHS)
    assert {launch.kernel for _, launch in ak.served_launches()} == \
        {"K1", "K2", "K3", "K4", "K6", "K7"}
    # decode rows, a prefill bucket and the encoder's 1600 rows
    for rows in (4, 256, 1600):
        assert any(f"rows {rows} " in n for n in names), rows


# ---------------------------------------------------------------- the CLI
def test_cli_exit_codes_and_json(capsys):
    assert main(["--pass", "vocab", "--pass", "hygiene"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert main(["--pass", "vocab", "--json", "--fixture",
                 str(FIX / "bad_vocab.py")]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [f["code"] for f in out] == ["VOCAB_UNREGISTERED_CODE"]
    assert set(out[0]) == {"code", "where", "message"}


def test_cli_smem_budget(capsys):
    assert main(["--pass", "kernels", "--smem-budget", "64"]) == 1
    assert "KC_SMEM_BUDGET" in capsys.readouterr().out


# ------------------------------------------------------ policy site universe
def test_site_universe_equals_the_reference():
    ref = ref_policies.site_universes()
    port = policies.site_universes()
    assert set(port) == set(ref)
    for arch in ref:
        assert sorted(port[arch]) == sorted(ref[arch]), arch


# ------------------------------------------------------------- sanitizer
def test_sanitize_disabled_is_noop(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert not sanitize.enabled()
    sanitize.check(False, "never raises when disabled")


def test_sanitize_eager_check_raises(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    sanitize.check(True, "fine")
    sanitize.check(torch.ones(3) > 0, "fine")
    with pytest.raises(AssertionError, match="REPRO_SANITIZE: boom"):
        sanitize.check(False, "boom")
    with pytest.raises(AssertionError, match="boom"):
        sanitize.check(torch.tensor([True, False]), "boom")


def test_sanitize_check_in_a_captured_step(monkeypatch):
    """The reference's `jit_checked` case: a check inside a compiled
    engine step (`serve.capture.StepGraph`; the CPU runs it eagerly)
    passes clean input and raises on a failed check."""
    from repro_torch.serve.capture import StepGraph
    monkeypatch.setenv("REPRO_SANITIZE", "1")

    def step(x):
        sanitize.check(torch.all(x > 0), "non-positive input")
        return x * 2

    graph = StepGraph(step, {"x": torch.zeros(3)}, capture=True)
    assert (graph.run(x=np.ones(3, np.float32)) == 2).all()
    with pytest.raises(AssertionError, match="non-positive input"):
        graph.run(x=-np.ones(3, np.float32))


def test_sanitize_cuda_tensor_takes_the_device_assert(monkeypatch):
    """A CUDA predicate is never read on the host: it goes to
    `torch._assert_async`; its error names the check only under
    blocking launches (here a CPU tensor that reports a CUDA device
    stands in, and the CPU's assert raises at once)."""
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    calls = []

    def device_assert(pred, msg):
        calls.append(msg)
        if not bool(pred):
            raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(torch, "_assert_async", device_assert)
    ok, bad = ak._as_probe(torch.ones(2) > 0), ak._as_probe(torch.zeros(2) > 0)
    sanitize.check(ok, "fine")
    assert calls == ["REPRO_SANITIZE: fine"]
    monkeypatch.delenv("CUDA_LAUNCH_BLOCKING", raising=False)
    with pytest.raises(RuntimeError) as err:
        sanitize.check(bad, "device check")
    assert not isinstance(err.value, AssertionError)
    monkeypatch.setenv("CUDA_LAUNCH_BLOCKING", "1")
    with pytest.raises(AssertionError, match="device check"):
        sanitize.check(bad, "device check")


def test_sanitize_ovp_encode_rejects_nonfinite(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    from repro_torch.core import ovp
    ovp.ovp_encode_codes(torch.zeros((2, 4)))      # clean input passes
    with pytest.raises(AssertionError, match="non-finite"):
        ovp.ovp_encode_codes(torch.full((2, 4), float("nan")))


def test_sanitize_ovp_decode_rejects_double_identifier(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    from repro_torch.core import ovp
    from repro_torch.core.datatypes import ID4
    bad = torch.full((2, 4), ID4, dtype=torch.uint8)   # every pair
    with pytest.raises(AssertionError, match="identifier"):
        ovp.ovp_decode_codes(bad)


def test_sanitize_kv_write_rejects_nan_scale(monkeypatch):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    from repro_torch import backends
    from repro_torch.core.policy import OLIVE_SERVE
    x = torch.randn((4, 2, 16), generator=torch.Generator().manual_seed(1))
    scale = torch.ones((4, 2))
    backends.encode_kv(x, scale, policy=OLIVE_SERVE)
    scale[1, 0] = float("nan")
    with pytest.raises(AssertionError,
                       match="the KV scale must be positive and finite"):
        backends.encode_kv(x, scale, policy=OLIVE_SERVE)


def test_trace_audit_flags_unexpected_retrace():
    class FakeEngine:
        def trace_audit(self):
            return {"prefill_traces": 3, "prefill_jits": 1,
                    "decode_traces": 1, "unexpected_retraces": 2}

    with pytest.raises(AssertionError, match="rebuilds"):
        sanitize.audit_traces(FakeEngine())


def test_sanitizer_off_places_no_check(monkeypatch):
    """With REPRO_SANITIZE unset a served run places no check (the gate
    is a Python branch: no op joins a step)."""
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    from repro_torch.launch import serve
    before = sanitize.check_counts()
    serve.run(["--arch", "qwen1.5-0.5b-smoke", "--quant", "olive_serve",
               "--requests", "2", "--max-new", "3", "--max-len", "32"],
              device="cpu")
    assert sanitize.check_counts() == before


def test_sanitize_smoke_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_SANITIZE", "1")     # restored after
    out = sanitize_smoke("cpu")
    assert out["audit"]["unexpected_retraces"] == 0
    assert out["tokens"] == 4 * 8
    checks = " ".join(out["checks"])
    for name in ("encode_kv", "ovp_quantize", "logits"):
        assert name in checks, out["checks"]
    assert main(["--sanitize-smoke", "--device", "cpu"]) == 0
    assert "sanitize smoke OK" in capsys.readouterr().out
