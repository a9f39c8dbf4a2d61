"""repro_torch.roofline and the configs' accounting: the H100 constants,
`Roofline`'s properties against hand-computed values, `step_stats` on a
smoke model of every family against a count written here from the
config, and the accounting (`param_count`, `active_param_count`,
`moe_block_count`, `sub_quadratic`, `shape_applicable`) equal to the
reference's for every arch and shape."""
from __future__ import annotations

import pytest
import torch

from repro import configs as ref_configs
from repro.roofline import analysis as ref_analysis
from repro_torch import configs
from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape
from repro_torch.core.ovp import ovp_quantize
from repro_torch.models.model import build_model
from repro_torch.roofline import Roofline, analyze, hw, step_stats

from _torch_dist import one_torch_thread  # noqa: F401

ROWS, SLOTS, POS = 2, 16, (3, 9)


# ----------------------------------------------------------- the accounting
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_accounting_equals_the_reference(arch):
    for port, ref in ((ARCHS[arch], ref_configs.ARCHS[arch]),
                      (get_config(arch + "-smoke"),
                       ref_configs.get_config(arch + "-smoke"))):
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert port.moe_block_count() == ref.moe_block_count()
        assert port.sub_quadratic == ref.sub_quadratic
        assert port.has_decoder == ref.has_decoder
        for name, shape in SHAPES.items():
            runs, why = configs.shape_applicable(port, shape)
            ref_runs, _ = ref_configs.shape_applicable(
                ref, ref_configs.SHAPES[name])
            assert runs == ref_runs and bool(why) == (not runs)


def test_shapes_equal_the_reference():
    assert set(SHAPES) == set(ref_configs.SHAPES)
    for name, shape in SHAPES.items():
        ref = ref_configs.SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind) == \
            (ref.seq_len, ref.global_batch, ref.kind)
        assert get_shape(name) == shape
    with pytest.raises(KeyError):
        get_shape("nope")


# ------------------------------------------------------------- constants
def test_h100_constants_and_bound():
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_FP8, hw.PEAK_FLOPS_TF32,
            hw.PEAK_FLOPS_FP32) == (989e12, 1979e12, 495e12, 67e12)
    assert (hw.HBM_BW, hw.HBM_BYTES, hw.NVLINK_BW, hw.SMEM_PER_BLOCK) == \
        (3.35e12, 80e9, 450e9, 232448)
    assert hw.bound_s(3.35e12, 67e12, peak=hw.PEAK_FLOPS_FP32) == \
        (1.0, "bytes")
    assert hw.bound_s(3.35e12, 2 * 989e12) == (2.0, "operations")


def test_roofline_properties_by_hand():
    r = Roofline(flops_per_chip=989e12, bytes_per_chip=3.35e12 / 2,
                 coll_bytes_per_chip=0.0, n_chips=1,
                 model_flops_global=494.5e12)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.5)
    assert r.t_collective == 0.0
    assert r.bottleneck == "compute" and r.t_bound == pytest.approx(1.0)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    assert r.mfu_bound == pytest.approx(0.5)
    m = Roofline(flops_per_chip=989e9, bytes_per_chip=3.35e12, n_chips=2,
                 coll_bytes_per_chip=450e9 * 0.25, model_flops_global=0.0)
    assert (m.bottleneck, m.t_bound) == ("memory", pytest.approx(1.0))
    assert m.t_collective == pytest.approx(0.25)
    assert m.mfu_bound == 0.0 and m.useful_flops_ratio == 0.0
    ref = ref_analysis.Roofline(1.0, 1.0, 0.0, 1)
    assert set(r.as_dict()) == set(ref.as_dict())
    assert r.as_dict()["t_bound_s"] == r.t_bound


def test_analyze_splits_a_count_over_chips():
    stats = step_stats.StepStats("decode", 4, {"weights": 8.0},
                                 {"linears": 6.0}, 3.0, 10.0)
    r = analyze(stats, n_chips=2)
    assert (r.bytes_per_chip, r.flops_per_chip, r.coll_bytes_per_chip,
            r.model_flops_global, r.arg_bytes_per_chip) == \
        (4.0, 3.0, 0.0, 3.0, 5.0)
    assert analyze(stats, model_flops_global=7.0).model_flops_global == 7.0


@pytest.mark.parametrize("t,offset,window", [(1, 0, 0), (16, 0, 0),
                                             (16, 32, 0), (5, 3, 4),
                                             (40, 10, 8), (3, 20, 8)])
def test_causal_keys_closed_form(t, offset, window):
    want = sum(min(offset + j + 1, window or offset + j + 1)
               for j in range(t))
    assert step_stats._causal_keys(t, offset, window) == want


def test_tree_bytes_counts_codes_and_scales():
    w = torch.randn((64, 32))
    qt = ovp_quantize(w, w.std(dim=0, keepdim=True), "int4", pair_axis=-2)
    assert step_stats.leaf_bytes(qt) == 32 * 32 + 32 * 4
    assert step_stats.tree_bytes({"a": qt, "b": [torch.zeros(3)]}) == \
        32 * 32 + 32 * 4 + 12


# -------------------------------------------- step_stats against the config
def _layer(cfg, btype, decode):
    """(weight elements, linear K·N of one token) of one layer of `btype`,
    written from the config (the expert stacks apart: see `_experts`)."""
    d, h, kv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    attn_lin = d * h * hd + 2 * d * kv * hd + h * hd * d
    attn_bias = (h + 2 * kv) * hd if cfg.qkv_bias else 0
    mlp_lin = (3 if cfg.mlp_kind == "swiglu" else 2) * d * ff
    mlp_bias = ff + d if cfg.mlp_kind == "gelu" else 0
    if btype in ("attn", "local_attn"):
        lin = attn_lin + mlp_lin
        return lin + attn_bias + mlp_bias + 2 * d, lin
    if btype == "moe":
        lin = attn_lin + d * cfg.n_experts
        return lin + attn_bias + 2 * d, lin
    if btype == "encdec_attn":
        cross = attn_lin - (2 * d * kv * hd if decode else 0)
        cross_bias = attn_bias - (2 * kv * hd if decode and cfg.qkv_bias
                                  else 0)
        lin = attn_lin + cross + mlp_lin
        return lin + attn_bias + cross_bias + mlp_bias + 3 * d, lin
    if btype == "rglru":
        dr = cfg.d_rnn or d
        lin = 3 * d * dr + 2 * dr * dr + mlp_lin
        return lin + 4 * dr + dr + dr + 2 * d, lin
    if btype == "mlstm":
        di = 2 * d
        lin = d * 2 * di + 3 * di * di + 2 * di * h + di * d
        return lin + 4 * di + di + 2 * h + di + d, lin
    if btype == "slstm":
        f2 = int(4 * d / 3) // 2 * 2
        lin = 4 * d * d + 3 * h * (d // h) ** 2 + 2 * d * f2
        return lin + d + d, lin
    raise ValueError(btype)


def _experts(cfg, rows):
    """(bytes, FLOPs) of one MoE layer's routed experts for `rows` tokens:
    min(E, rows·k) experts read, rows·k expert rows computed."""
    per = 3 * cfg.d_model * cfg.d_ff
    return (4 * min(cfg.n_experts, rows * cfg.top_k) * per,
            2.0 * rows * cfg.top_k * per)


def _fp_model(arch):
    cfg = get_config(arch)
    model = build_model(cfg, remat=False)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return cfg, model, params


def _kv_live(cfg, btype, slots):
    window = cfg.window if btype == "local_attn" else 0
    return sum(min(p + 1, slots, window or slots) for p in POS)


FAMILIES = ("qwen1.5-0.5b", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
            "xlstm-350m", "seamless-m4t-large-v2", "internvl2-1b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_stats_against_the_config(arch):
    cfg, model, params = _fp_model(arch + "-smoke")
    src_len = 5
    caches = model.init_caches(ROWS, SLOTS, enc_len=8, device="cpu")
    got = step_stats.decode_step_stats(model, params, caches, POS,
                                       src_len=src_len)
    d, vp = cfg.d_model, cfg.padded_vocab
    slot = 2 * cfg.n_kv_heads * cfg.head_dim * 4     # fp32 K and V
    weights = kv_read = state = lin = attn = cross = 0
    for i in range(cfg.n_layers):
        bt = model.block_type(i)
        elems, kn = _layer(cfg, bt, decode=True)
        weights += 4 * elems
        lin += 2.0 * ROWS * kn
        if bt == "moe":
            b, f = _experts(cfg, ROWS)
            weights += b
            lin += f
        if bt in ("attn", "moe", "local_attn", "encdec_attn"):
            slots = min(cfg.window, SLOTS) if bt == "local_attn" else SLOTS
            live = _kv_live(cfg, bt, slots)
            kv_read += live * slot
            attn += 4.0 * cfg.n_heads * cfg.head_dim * live
        if bt == "encdec_attn":
            cross += ROWS * src_len * slot
            attn += 4.0 * cfg.n_heads * cfg.head_dim * ROWS * src_len
        if bt == "rglru":
            dr = cfg.d_rnn or d
            state += 2 * 4 * ROWS * (dr + 3 * dr)
        if bt == "mlstm":
            dh = 2 * d // cfg.n_heads
            state += 2 * 4 * ROWS * (cfg.n_heads * (dh * dh + dh + 1)
                                     + 3 * 2 * d)
        if bt == "slstm":
            state += 2 * 4 * ROWS * 4 * d
    n_kv = sum(model.block_type(i) in ("attn", "moe", "local_attn",
                                       "encdec_attn")
               for i in range(cfg.n_layers))
    assert got.parts["weights"] == weights
    assert got.parts["kv_read"] == kv_read
    assert got.parts["kv_write"] == n_kv * ROWS * slot
    assert got.parts["cross_read"] == cross
    assert got.parts["state"] == state
    assert got.parts["head"] == 4 * (vp * d + d + ROWS * vp)
    assert got.parts["embed"] == 4 * ROWS * d
    assert got.flop_parts["linears"] == lin + 2.0 * ROWS * d * vp
    assert got.flop_parts["attention"] == attn
    assert got.model_flops == 2.0 * cfg.active_param_count() * ROWS
    r = analyze(got)
    assert r.bottleneck == "memory"
    assert r.t_bound == pytest.approx(got.bytes / 3.35e12)


def test_decode_step_stats_counts_routed_experts_only():
    cfg, model, params = _fp_model("qwen3-moe-30b-a3b-smoke")
    caches = model.init_caches(ROWS, SLOTS, device="cpu")
    base = step_stats.decode_step_stats(model, params, caches, POS)
    one = step_stats.decode_step_stats(model, params, caches, POS,
                                       experts_touched=1)
    per = 4 * 3 * cfg.d_model * cfg.d_ff
    touched = min(cfg.n_experts, ROWS * cfg.top_k)
    assert base.parts["weights"] - one.parts["weights"] == \
        cfg.moe_block_count() * (touched - 1) * per


def test_paged_decode_reads_the_table():
    cfg, model, params = _fp_model("qwen1.5-0.5b-smoke")
    slab = model.init_caches(ROWS, SLOTS, device="cpu")
    paged = model.init_paged_caches(8, 4, ROWS, SLOTS // 4, device="cpu")
    a = step_stats.decode_step_stats(model, params, slab, POS)
    b = step_stats.decode_step_stats(model, params, paged, POS)
    table = ROWS * (SLOTS // 4) * 4
    assert b.parts["kv_read"] - a.parts["kv_read"] == cfg.n_layers * table
    assert b.flops == a.flops


@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "seamless-m4t-large-v2",
                                  "internvl2-1b", "recurrentgemma-9b"))
def test_prefill_step_stats_against_the_config(arch):
    cfg, model, params = _fp_model(arch + "-smoke")
    t, frames = 12, (6 if cfg.enc_dec else 0)
    patches = cfg.n_frontend_tokens if cfg.frontend == "vit" else 0
    caches = model.init_caches(1, SLOTS + patches, enc_len=8, device="cpu")
    got = step_stats.prefill_step_stats(model, params, caches, t,
                                        frames=frames, patches=patches)
    n = t + patches
    d, vp = cfg.d_model, cfg.padded_vocab
    slot = 2 * cfg.n_kv_heads * cfg.head_dim * 4
    per_q = 4.0 * cfg.n_heads * cfg.head_dim
    attn = kv_write = cross_write = 0
    for i in range(cfg.n_layers):
        bt = model.block_type(i)
        if bt in ("attn", "moe", "local_attn", "encdec_attn"):
            window = cfg.window if bt == "local_attn" else 0
            attn += per_q * sum(min(j + 1, window or j + 1)
                                for j in range(n))
            slots = min(cfg.window, SLOTS + patches) if bt == "local_attn" \
                else SLOTS + patches
            kv_write += min(n, slots) * slot
        if bt == "encdec_attn":
            attn += per_q * n * frames
            cross_write += frames * slot
    enc = 0.0
    if cfg.enc_dec:
        _, kn = _layer(cfg, "attn", decode=False)
        enc = cfg.n_enc_layers * (2.0 * frames * kn
                                  + per_q * frames * (frames + 1) // 2)
    if cfg.frontend:
        enc += 2.0 * (frames or patches) * cfg.frontend_dim * d
    assert got.flop_parts["attention"] == attn
    assert got.flop_parts["encoder"] == enc
    assert got.parts["kv_write"] == kv_write
    assert got.parts["cross_write"] == cross_write
    assert got.parts["kv_read"] == 0
    assert got.parts["embed"] == 4 * t * d
    assert got.parts["head"] == 4 * (vp * d + d + n * vp)
    assert got.tokens == n


def test_train_step_stats():
    cfg, model, params = _fp_model("qwen1.5-0.5b-smoke")
    fwd = step_stats.prefill_step_stats(model, params, None, 32, rows=2)
    got = step_stats.train_step_stats(model, params, 2, 32,
                                      opt_state=[torch.zeros(10)])
    w = step_stats.tree_bytes(params)
    assert got.flops == pytest.approx(4 * fwd.flops)
    assert step_stats.train_step_stats(model, params, 2, 32, remat=False) \
        .flops == pytest.approx(3 * fwd.flops)
    assert got.model_flops == 6.0 * cfg.active_param_count() * 64
    assert got.parts["weights"] == 3 * w
    assert got.parts["optimizer"] == 80
    assert got.arg_bytes == w


def test_mean_over_steps():
    cfg, model, params = _fp_model("qwen1.5-0.5b-smoke")
    caches = model.init_caches(ROWS, SLOTS, device="cpu")
    a = step_stats.decode_step_stats(model, params, caches, (3, 9))
    b = step_stats.decode_step_stats(model, params, caches, (5, 11))
    m = step_stats.mean([a, b])
    assert m.bytes == pytest.approx((a.bytes + b.bytes) / 2)
    assert m.flops == pytest.approx((a.flops + b.flops) / 2)
