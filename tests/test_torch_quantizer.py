"""PTQ of the port (repro_torch.core.quantizer / qlinear) against the JAX
reference on seeded heavy-tailed weights.

Tolerance: codes must be equal byte for byte. Scales must agree to 1e-6
relative: both sides use the population std (ddof=0) and the same
candidate grid, but XLA and torch sum the std's reductions in different
orders, so a channel's scale can differ in its last bit (never enough to
change a code here).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpol
from repro.core import qlinear as jq
from repro.core import quantizer as jquant
from repro_torch.core import policy as tpol
from repro_torch.core import qlinear as tq
from repro_torch.core import quantizer as tquant

from _torch_dist import one_torch_thread  # noqa: F401


def _heavy(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_t(3, size=shape).astype(np.float32) * 0.05
    w.reshape(-1)[::97] *= 40.0          # sparse outliers
    return w


CASES = [((256, 128), "int4", "channel"), ((176, 72), "int4", "channel"),
         ((256, 128), "flint4", "channel"), ((176, 72), "int8", "channel"),
         ((176, 72), "int4", "tensor")]


@pytest.mark.parametrize("shape,normal_dtype,granularity", CASES)
def test_quantize_weight_matches_reference(shape, normal_dtype, granularity):
    w = _heavy(shape, seed=shape[0])
    kw = dict(w_normal_dtype=normal_dtype, w_granularity=granularity,
              wbits=8 if normal_dtype == "int8" else 4)
    qj = jax.jit(jq.quantize_weight, static_argnums=1)(
        jnp.asarray(w), dataclasses.replace(jpol.OLIVE_W4, **kw))
    qt = tq.quantize_weight(torch.from_numpy(w),
                            dataclasses.replace(tpol.OLIVE_W4, **kw))
    np.testing.assert_array_equal(qt.data.numpy(), np.asarray(qj.data))
    np.testing.assert_allclose(qt.scale.numpy(), np.asarray(qj.scale),
                               rtol=1e-6, atol=0)
    assert qt.scale.shape == qj.scale.shape


def test_population_std_rule_pinned():
    """The 3σ seed uses ddof=0 (`jnp.std`), not torch's unbiased default:
    on 8 values the two differ by sqrt(8/7), far above the tolerance."""
    x = _heavy((8,), seed=5)
    ref = np.asarray(jquant.sigma_init_scale(jnp.asarray(x), "int4"))
    got = tquant.sigma_init_scale(torch.from_numpy(x), "int4").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    unbiased = 3.0 * torch.std(torch.from_numpy(x)).item() / 7.0
    assert abs(unbiased - float(ref)) > 1e-3 * float(ref)


def test_search_grid_is_the_reference_grid():
    for n in (11, 23):
        ref = np.asarray(jnp.geomspace(0.35, 2.2, n))
        np.testing.assert_array_equal(
            tquant._grid(0.35, 2.2, n, "cpu").numpy(), ref)


def test_quantize_params_walks_sites():
    """Only linear weights of enabled sites quantize; the tied head,
    norms and biases stay fp."""
    params = {"embed": {"table": torch.randn(512, 64)},
              "lm_head": {"w_out": torch.randn(64, 512)},
              "layers": [{"ln1": {"gamma_scale": torch.ones(64)},
                          "attn": {"wq": torch.randn(64, 64),
                                   "bq": torch.zeros(64)},
                          "mlp": {"wg": torch.randn(64, 128)}}]}
    out = tq.quantize_params(params, tpol.OLIVE_W4)
    layer = out["layers"][0]
    assert isinstance(layer["attn"]["wq"], tq.QuantizedTensor)
    assert isinstance(layer["mlp"]["wg"], tq.QuantizedTensor)
    for leaf in (out["embed"]["table"], out["lm_head"]["w_out"],
                 layer["attn"]["bq"], layer["ln1"]["gamma_scale"]):
        assert isinstance(leaf, torch.Tensor)
    assert [p for p, _ in tq.tree_paths(out)][:2] == ["embed/table",
                                                      "lm_head/w_out"]
