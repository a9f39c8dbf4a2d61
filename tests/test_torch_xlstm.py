"""The xLSTM family's layers (xLSTM-350M: mLSTM and sLSTM blocks, recurrent
state only) against the reference, on inputs made with numpy from a
seed:

- the configs `xlstm-350m`, full and `-smoke`, equal the reference's
  field for field (the port's fields), and `param_count` equals the
  reference's on them and on a 5-layer variant whose fifth layer is a
  `tail` mlstm;
- the mLSTM cores: the port's `_mlstm_core` (per token) and
  `_mlstm_chunkwise` against the reference's at chunk 1/4/16/48/64 and
  T 1/3/17/33/65/130 (ragged lengths pad the last chunk), from a
  non-zero initial state (a 16-token warm-up from m0 = 1.5), and the
  port's two forms against each other; rtol 2e-4, atol 2e-5, the
  tolerance of the reference's `tests/test_mlstm_chunkwise.py`;
- `mlstm_forward` and `slstm_forward`, fp32 and unquantized, at smoke
  width (d 64, 4 heads: mLSTM heads of 32, sLSTM heads of 16, ff 84): a
  prefill at T 1, 7, 64, 65 and 130, then 8 chained one-token decodes
  on the state the prefill left (the chunkwise form hands its state to
  the per-token one); outputs and every state leaf within rtol 2e-4,
  atol 2e-5 (the same tolerance: XLA's scan and torch's loop round the
  exponentials and the (Dh x Dh) products differently in the last
  bits);
- one mLSTM and one sLSTM layer at full width (d 1024, 4 heads: mLSTM
  heads of 512, sLSTM heads of 256, ff 1364), T 70 (past one 64-token
  chunk), then 2 decodes: outputs within atol 1e-4 and the states
  within rtol 2e-4, atol 1e-4 (sums of 1024-4096 products in another
  order).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import QuantPolicy as JPolicy
from repro.models import layers as jl
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.models import layers as tl

from _torch_dist import one_torch_thread  # noqa: F401

ARCH = "xlstm-350m"
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread (the suite's workers
    share the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg):
    fields = {f.name for f in dataclasses.fields(tbase.ArchConfig)}
    return tbase.ArchConfig(**{k: v for k, v in
                               dataclasses.asdict(jcfg).items()
                               if k in fields})


def _to_port(tree):
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    return params_from_numpy({"sub": np_tree}, device="cpu")["sub"]


def _close(got, ref, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **(tol or TOL))


# --------------------------------------------------------------------------
# Configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", ["", "-smoke"])
def test_config_matches_reference(smoke):
    jcfg = jconfigs.get_config(ARCH + smoke)
    tcfg = tconfigs.get_config(ARCH + smoke)
    assert _port_cfg(jcfg) == tcfg
    assert tcfg.block_pattern == ("mlstm", "slstm")
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.d_ff,
            tcfg.vocab, tcfg.mlstm_chunk, tcfg.family) == \
        ((4, 64, 4, 0, 512, 64, "ssm") if smoke
         else (24, 1024, 4, 0, 50304, 64, "ssm"))


@pytest.mark.parametrize("n_layers", [None, 5])
@pytest.mark.parametrize("smoke", ["", "-smoke"])
def test_param_count_matches_reference(smoke, n_layers):
    jcfg = jconfigs.get_config(ARCH + smoke)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    assert _port_cfg(jcfg).param_count() == jcfg.param_count()


# --------------------------------------------------------------------------
# The mLSTM cores
# --------------------------------------------------------------------------
B, H, DH, WARM = 2, 2, 16, 16


def _core_inputs(t, seed):
    """q, k, v, gates for T tokens, and a non-zero state: the reference's
    per-token scan over WARM tokens from m0 = 1.5."""
    rng = np.random.default_rng(seed)

    def gates(n):
        x = rng.standard_normal((B, n, H, 3 * DH + 2)).astype(np.float32)
        q, k, v = np.split(x[..., :3 * DH], 3, axis=-1)
        i_pre = 2.0 * x[..., 3 * DH]
        f_pre = np.array(jax.nn.log_sigmoid(x[..., 3 * DH + 1] + 2.0))
        return q, k, v, i_pre, f_pre

    st0 = {"c": jnp.zeros((B, H, DH, DH)), "n": jnp.zeros((B, H, DH)),
           "m": jnp.full((B, H), 1.5)}
    _, st = jl._mlstm_core(*map(jnp.asarray, gates(WARM)), st0)
    return gates(t), {k: np.asarray(v) for k, v in st.items()}


def _port_state(st):
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


@pytest.mark.parametrize("t", [1, 3, 17, 33, 65, 130])
def test_mlstm_core_matches_reference(t):
    xs, st = _core_inputs(t, seed=t)
    assert float(np.abs(st["c"]).max()) > 0 and float(st["m"].min()) != 0
    h_ref, st_ref = jax.jit(jl._mlstm_core)(*map(jnp.asarray, xs), st)
    h, st_got = tl._mlstm_core(*map(torch.from_numpy, xs), _port_state(st))
    _close(h, h_ref)
    for key in ("c", "n", "m"):
        _close(st_got[key], st_ref[key])


@pytest.mark.parametrize("t", [1, 3, 17, 33, 65, 130])
@pytest.mark.parametrize("chunk", [1, 4, 16, 48, 64])
def test_mlstm_chunkwise_matches_reference(chunk, t):
    xs, st = _core_inputs(t, seed=100 + t)
    h_ref, st_ref = jax.jit(lambda *a: jl._mlstm_chunkwise(
        *a, chunk=chunk))(*map(jnp.asarray, xs), st)
    h, st_got = tl._mlstm_chunkwise(*map(torch.from_numpy, xs),
                                    _port_state(st), chunk=chunk)
    _close(h, h_ref)
    for key in ("c", "n", "m"):
        _close(st_got[key], st_ref[key])


@pytest.mark.parametrize("t", [1, 3, 17, 33, 65, 130])
@pytest.mark.parametrize("chunk", [1, 4, 16, 48, 64])
def test_mlstm_chunkwise_matches_the_port_core(chunk, t):
    xs, st = _core_inputs(t, seed=200 + t)
    xs = tuple(map(torch.from_numpy, xs))
    h_ref, st_ref = tl._mlstm_core(*xs, _port_state(st))
    h, st_got = tl._mlstm_chunkwise(*xs, _port_state(st), chunk=chunk)
    _close(h, h_ref.numpy())
    for key in ("c", "n", "m"):
        _close(st_got[key], st_ref[key].numpy())


# --------------------------------------------------------------------------
# The blocks: prefill, then chained decodes
# --------------------------------------------------------------------------
def _block_params(btype, d, nh, seed):
    key = jax.random.PRNGKey(seed)
    if btype == "mlstm":
        p = jl.mlstm_params(key, d, nh)
        # a spread of input-gate biases, not the init's zeros
        bias = np.random.default_rng(seed).uniform(-1, 1, nh)
        return dict(p, igate_bias=jnp.asarray(bias, jnp.float32))
    return jl.slstm_params(key, d, nh)


def _states(btype, b, d, nh):
    if btype == "mlstm":
        return (jl.mlstm_init_state(b, d, nh),
                tl.mlstm_init_state(b, d, nh, device="cpu"))
    return jl.slstm_init_state(b, d), tl.slstm_init_state(b, d, device="cpu")


def _leaves(st):
    return [st[k] for k in sorted(st) if k != "mem"] \
        + [st["mem"][k] for k in sorted(st["mem"])]


def _prefill_then_decodes(btype, cfg_name, t, steps, b, seed, out_tol,
                          st_tol):
    jcfg = jconfigs.get_config(cfg_name)
    tcfg = tconfigs.get_config(cfg_name)
    d, nh = jcfg.d_model, jcfg.n_heads
    jp = _block_params(btype, d, nh, seed)
    tp = _to_port(jp)
    x = np.random.default_rng(seed).standard_normal(
        (b, t + steps, d)).astype(np.float32)
    jfwd = {"mlstm": jl.mlstm_forward, "slstm": jl.slstm_forward}[btype]
    tfwd = {"mlstm": tl.mlstm_forward, "slstm": tl.slstm_forward}[btype]
    jpol, tpol = JPolicy(compute_dtype="float32"), \
        TPolicy(compute_dtype="float32")
    fwd = jax.jit(lambda p, xx, st: jfwd(p, xx, jcfg, jpol, state=st,
                                         mode="decode"))
    jst, tst = _states(btype, b, d, nh)
    kept = [leaf.data_ptr() for leaf in _leaves(tst)]
    for lo, hi in [(0, t)] + [(i, i + 1) for i in range(t, t + steps)]:
        ref, jst = fwd(jp, jnp.asarray(x[:, lo:hi]), jst)
        got, tst = tfwd(tp, torch.from_numpy(x[:, lo:hi]), tcfg, tpol,
                        state=tst)
        _close(got, ref, **out_tol)
    assert [leaf.data_ptr() for leaf in _leaves(tst)] == kept   # in place
    for got, ref in zip(_leaves(tst), _leaves(jst)):
        _close(got, ref, **st_tol)


@pytest.mark.parametrize("t", [1, 7, 64, 65, 130])
@pytest.mark.parametrize("btype", ["mlstm", "slstm"])
def test_block_prefill_then_decodes_smoke(btype, t):
    _prefill_then_decodes(btype, ARCH + "-smoke", t, steps=8, b=2,
                          seed=t, out_tol=TOL, st_tol=TOL)


@pytest.mark.parametrize("btype", ["mlstm", "slstm"])
def test_block_at_full_width(btype):
    _prefill_then_decodes(btype, ARCH, 70, steps=2, b=1, seed=3,
                          out_tol=dict(rtol=0, atol=1e-4),
                          st_tol=dict(rtol=2e-4, atol=1e-4))


def test_mlstm_head_width_is_twice_d_over_heads():
    """The mLSTM head is 2 d_model / n_heads wide (512 at full width),
    not `cfg.head_dim` (256); the sLSTM head d_model / n_heads, and its
    MLP int(4 d / 3) rounded down to even (1364)."""
    cfg = tconfigs.get_config(ARCH)
    st = tl.mlstm_init_state(1, cfg.d_model, cfg.n_heads, device="meta")
    assert st["mem"]["c"].shape == (1, 4, 512, 512)
    assert st["conv"].shape == (1, 3, 2048)
    p = tl.slstm_params(None, cfg.d_model, cfg.n_heads, device="meta")
    assert p["r_z"].shape == (4, 256, 256)
    assert p["mlp"]["wu2"].shape == (1024, 1364)
    assert cfg.head_dim == 256


def test_forwards_without_state_are_fresh_prefills():
    """No state: the mLSTM starts from zeros, the sLSTM from n = 1 (as a
    fresh cache)."""
    cfg = tconfigs.get_config(ARCH + "-smoke")
    pol = TPolicy(compute_dtype="float32")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 9, cfg.d_model)).astype(np.float32))
    for btype, fwd, init in (
            ("mlstm", tl.mlstm_forward,
             lambda: tl.mlstm_init_state(1, 64, 4, device="cpu")),
            ("slstm", tl.slstm_forward,
             lambda: tl.slstm_init_state(1, 64, device="cpu"))):
        p = _to_port(_block_params(btype, 64, 4, seed=5))
        a, none = fwd(p, x, cfg, pol)
        b, st = fwd(p, x, cfg, pol, state=init())
        assert none is None and torch.equal(a, b)
        assert float(st["mem"]["c"].abs().sum()) > 0
