"""The port's examples (`examples_torch/`): what they import, how they
refuse a missing card, and the bench-lm fixture they share against
`benchmarks/common.py`, on the CPU.

Tolerances: the fixture's params are bit-equal, leaf for leaf, to the
reference's tree carried across (`convert.params_from_numpy`), in the
reference's flatten order; `footprint` equals `common.footprint`
exactly for the fp32 tree and the W4, W8 and mixed PTQ trees (the
reference's traced, `jax.eval_shape`: the count reads shapes alone);
`eval_ppl` of the fp32 model within rtol 1e-5 of the reference's, the
reference's eval batches fed to both (the two corpora draw different
tokens).
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import os

import jax
import numpy as np
import pytest
import torch

from benchmarks import common
from examples_torch import fixture, serve_quantized
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models.model import build_model as j_build_model
from repro_torch.convert import params_from_numpy, params_to_reference
from repro_torch.core.calibration import _sorted_paths
from repro_torch.core.qlinear import quantize_params, tree_paths
from repro_torch.models.model import build_model as t_build_model

from _torch_dist import one_torch_thread  # noqa: F401
from _torch_examples import RefBatches

EXAMPLES = ("fixture", "quickstart", "ptq_calibrate", "serve_quantized",
            "train_e2e")
ROOT = os.path.join(os.path.dirname(__file__), "..", "examples_torch")
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks", "examples")


@pytest.fixture(scope="module")
def ref():
    return common.trained_lm(steps=30)


@pytest.fixture(scope="module")
def port():
    return fixture.trained_lm(steps=30, device="cpu")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_neither_jax_nor_the_reference(name):
    path = os.path.join(ROOT, f"{name}.py")
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(FORBIDDEN), (name, sorted(tops & set(FORBIDDEN)))
    assert "repro_torch" in tops or name != "fixture"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", EXAMPLES[1:])
def test_main_on_cuda_raises_without_a_card(name):
    mod = importlib.import_module(f"examples_torch.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([], device="cuda")


def test_fixture_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        fixture.trained_lm(device="cuda")


def test_missing_weights_name_the_file():
    with pytest.raises(FileNotFoundError, match="bench_lm_12345.npz"):
        fixture.trained_lm(steps=12345, device="cpu")


def test_lm_cfg_is_the_reference_fixture():
    want = dataclasses.asdict(common._lm_cfg())
    got = dataclasses.asdict(fixture._lm_cfg())
    assert {k: got[k] for k in want if k in got} == \
        {k: want[k] for k in want if k in got}
    assert dataclasses.asdict(fixture._corpus()) == \
        dataclasses.asdict(common._corpus())
    assert (fixture.LM_SEQ, fixture.LM_BATCH) == (common.LM_SEQ,
                                                  common.LM_BATCH)


def test_flatten_order_is_jax_tree_flatten(ref):
    _, params, _ = ref
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    model = t_build_model(fixture._lm_cfg())
    skeleton = params_to_reference(model.init(None, device="meta"),
                                   fixture._lm_cfg())
    assert [p for p, _ in _sorted_paths(skeleton)] == want


def test_trained_lm_params_bit_equal(ref, port):
    _, jparams, _ = ref
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    _, got, loader = port
    wl, gl = tree_paths(want), tree_paths(got)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, w), (_, g) in zip(wl, gl):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    assert loader.cfg.global_batch == 16 and loader.cfg.seq_len == 128


def test_eval_ppl_fp32_matches_the_reference(ref, port):
    jmodel, jparams, jloader = ref
    model, params, _ = port
    want = common.eval_ppl(jmodel, jparams, jloader)
    got = fixture.eval_ppl(model, params, RefBatches(jloader))
    assert got == pytest.approx(want, rel=1e-5)


def _j_mixed(cfg):
    """The reference example's `--mixed` program."""
    w4 = jpol.QuantPolicy(method="olive", wbits=4, abits=0,
                          compute_dtype="float32")
    w8kv = jpol.QuantPolicy(method="olive", wbits=8, abits=0,
                            w_normal_dtype="int8", compute_dtype="float32",
                            kv_bits=4)
    return jpol.PolicyProgram.from_policy(w4, name="mixed_w48").with_rules(
        [("layers/0/*", w8kv), (f"layers/{cfg.n_layers - 1}/*", w8kv)])


@pytest.mark.parametrize("mode", ["fp32", "w4", "w8", "mixed"])
def test_footprint_exact(ref, port, mode):
    _, jparams, _ = ref
    model, params, _ = port
    cfg = model.cfg
    if mode == "fp32":
        jtree, tree = jparams, params
    else:
        jcfg = common._lm_cfg()
        jp = {"w4": jpol.QuantPolicy(method="olive", wbits=4, abits=0,
                                     compute_dtype="float32"),
              "w8": jpol.QuantPolicy(method="olive", wbits=8, abits=0,
                                     w_normal_dtype="int8",
                                     compute_dtype="float32"),
              "mixed": _j_mixed(jcfg)}[mode]
        src = j_build_model(jcfg, jp, remat=False).adapt_params(jparams)
        # the footprint counts shapes alone: trace the reference's PTQ
        jtree = jax.eval_shape(lambda t: j_quantize_params(t, jp), src)
        tree = quantize_params(params, serve_quantized.policy(
            cfg, w8=mode == "w8", mixed=mode == "mixed"))
    assert fixture.footprint(tree) == common.footprint(jtree)
