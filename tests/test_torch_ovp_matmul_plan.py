"""K1/K5's launch plan (`kernels/ovp_matmul.py::launch_plan`), the
geometry the dense CUDA entry `ovp_mm_launch` is launched with, checked
on the CPU at the serving paths' shapes: every output column and K pair
is covered exactly once, each output element has exactly one writer (so
the output is never zeroed and nothing is added across clusters), the
shared memory fits a block, and a 4-row decode fills one wave of an
H100's 132 SMs. Also: the ctypes signature matches the C entries."""
from __future__ import annotations

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import ovp_matmul as tmm

from _torch_dist import one_torch_thread  # noqa: F401

# (K, N): Qwen1.5-0.5B q/k/v/o, gate/up, down; Qwen3-30B-A3B attention
# q, k/v, o
PATH_SHAPES = [(1024, 1024), (1024, 2816), (2816, 1024), (2048, 4096),
               (2048, 512), (4096, 2048)]
ROWS = (1, 3, 4, 8, 16, 31, 128, 512)


def _check_plan(plan, rows: int, k: int, n: int, w_rows: int = 1):
    k2, n_pad = k // 2, -(-n // 16) * 16
    assert (plan.rows, plan.k2, plan.n) == (rows, k2, n_pad)
    x_blocks, y_blocks, z_blocks = plan.grid
    assert z_blocks == 1 and x_blocks == (n_pad // 16) * plan.split
    # one cluster: share column tiles x split K slices, at most 8 blocks,
    # tiling the grid's x exactly
    assert plan.split in (1, 2, 4, 8) and plan.share in (1, 2, 4, 8)
    assert plan.split * plan.share <= 8
    assert (n_pad // 16) % plan.share == 0
    pairs = np.zeros((rows, n_pad), np.int64)     # K pairs summed
    owners = np.zeros((rows, n_pad), np.int64)    # clusters writing it
    for y in range(y_blocks):
        for tile in range(n_pad // 16):
            spans = []
            c, t = divmod(tile, plan.share)
            for rank in range(plan.split):
                x = (c * plan.share + t) * plan.split + rank
                r_rng, c_rng, k_rng = plan.tile(x, y)
                assert len(r_rng) > 0 and len(k_rng) > 0
                assert c_rng == range(tile * 16, tile * 16 + 16)
                pairs[r_rng.start:r_rng.stop, c_rng.start:c_rng.stop] += \
                    len(k_rng)
                spans.append((k_rng.start, k_rng.stop))
            # the cluster's K slices tile [0, K/2) in rank order
            assert spans[0][0] == 0 and spans[-1][1] == k2
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            owners[r_rng.start:r_rng.stop, c_rng.start:c_rng.stop] += 1
    assert (pairs == k2).all()
    assert (owners == 1).all()
    assert 0 <= plan.smem <= tmm.SMEM_MAX
    if plan.body == "decode":
        assert 1 <= plan.row_tile <= 8
        assert plan.row_tile == min(rows, 8)      # no padded rows at <= 8
        assert plan.smem == tmm._dec_smem(plan.row_tile, plan.slice,
                                          w_rows, plan.split)
    else:
        assert (plan.split, plan.slice, plan.smem) == (1, k2, 0)


@pytest.mark.parametrize("a_mode", ["fp", "static"])
@pytest.mark.parametrize("w_dtype", ["int4", "int8"])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("k,n", PATH_SHAPES)
def test_plan_covers_each_output_and_pair_once(k, n, rows, w_dtype, a_mode):
    plan = tmm.launch_plan(rows, k, n, w_dtype, a_mode=a_mode)
    _check_plan(plan, rows, k, n, 2 if w_dtype == "int8" else 1)
    # every path shape's slice fits: the decode body at any row count
    assert plan.body == "decode"
    # the quantize modes share a quantized slice across as many column
    # tiles as the cluster holds and the tiles divide into; fp never
    tiles = -(-n // 16)
    assert plan.share == (1 if a_mode == "fp" else max(
        g for g in (1, 2, 4, 8) if g * plan.split <= 8 and tiles % g == 0))
    if rows == 4:
        assert plan.blocks >= 132


@pytest.mark.parametrize("body", tmm.BODIES)
@pytest.mark.parametrize("rows", (8, 16, 32))
@pytest.mark.parametrize("k,n", PATH_SHAPES)
def test_forced_bodies_plan_validly(k, n, rows, body):
    """Each body can be forced (the chip's K1/K5 sweep and timing run
    both), and its plan is as valid as the default one."""
    plan = tmm.launch_plan(rows, k, n, "int4", body)
    assert plan.body == body
    _check_plan(plan, rows, k, n)


# (split, slice, share in the quantize modes) of each path shape at rows
# 4 (csrc/ovp_matmul.cu header)
ROWS4_PLANS = {(1024, 1024): (4, 128, 2), (1024, 2816): (1, 512, 8),
               (2816, 1024): (4, 352, 2), (2048, 4096): (2, 512, 4),
               (2048, 512): (8, 128, 1), (4096, 2048): (4, 512, 2)}


@pytest.mark.parametrize("a_mode", ["fp", "quantize", "static", "codes4"])
@pytest.mark.parametrize("k,n", PATH_SHAPES)
def test_rows4_tiling_is_the_documented_one(k, n, a_mode):
    plan = tmm.launch_plan(4, k, n, "int4", a_mode=a_mode)
    assert (plan.body, plan.row_tile) == ("decode", 4)
    split, slice_, share = ROWS4_PLANS[(k, n)]
    assert (plan.split, plan.slice) == (split, slice_)
    assert plan.share == (share if a_mode in ("quantize", "static") else 1)


@pytest.mark.parametrize("k,n", [(272, 40), (2816, 1000), (64, 24),
                                 (1024, 96)])
@pytest.mark.parametrize("rows", (1, 3, 16, 31))
def test_ragged_shapes_plan_validly(k, n, rows):
    """A ragged N (padded to 16), K off a 128-pair stage, and tile counts
    that only some cluster shares divide."""
    for w_dtype in ("int4", "flint4", "int8"):
        for a_mode in ("fp", "quantize"):
            _check_plan(tmm.launch_plan(rows, k, n, w_dtype, a_mode=a_mode),
                        rows, k, n, 2 if w_dtype == "int8" else 1)


# (K, N) of one layer of each dense 7-8B config: q and o, k and v,
# gate and up, down
DENSE_7B = {"qwen2-7b": [(3584, 3584), (3584, 512), (3584, 18944),
                         (18944, 3584)],
            "yi-6b": [(4096, 4096), (4096, 512), (4096, 11008),
                      (11008, 4096)],
            "minitron-8b": [(4096, 4096), (4096, 1024), (4096, 16384),
                            (16384, 4096)]}
DENSE_7B_SHAPES = sorted({kn for shapes in DENSE_7B.values()
                          for kn in shapes})


@pytest.mark.parametrize("w_dtype", ["int4", "int8"])
@pytest.mark.parametrize("k,n", DENSE_7B_SHAPES)
def test_dense_7b_linears_take_the_decode_body(k, n, w_dtype):
    """Every linear of Qwen2-7B, Yi-6B and Minitron-8B, at every row count
    a decode step (1-8 slots), a ragged prompt (31) and a prefill bucket
    (128) give it: the decode body, within shared memory, and a valid
    tiling."""
    for rows in (1, 2, 3, 4, 5, 6, 7, 8, 31, 128):
        plan = tmm.launch_plan(rows, k, n, w_dtype)
        assert plan.body == "decode" and plan.smem <= tmm.SMEM_MAX
        if rows in (1, 4, 31, 128):
            _check_plan(plan, rows, k, n, 2 if w_dtype == "int8" else 1)


@pytest.mark.parametrize("w_dtype", ["int4", "int8"])
@pytest.mark.parametrize("k,n", DENSE_7B_SHAPES)
def test_dense_7b_linears_plan_the_static_mode(k, n, w_dtype):
    """The calibrated W4A4 and W8A8 programs run every 7-8B linear in the
    static mode (K5): the decode body within shared memory, a valid
    tiling, and the quantize modes' column share (the most tiles that
    divide the tiles and keep the cluster at 8 blocks), at the same
    split and slice as the fp mode."""
    tiles = -(-n // 16)
    for rows in (1, 2, 3, 4, 5, 6, 7, 8, 31, 128):
        plan = tmm.launch_plan(rows, k, n, w_dtype, a_mode="static")
        fp = tmm.launch_plan(rows, k, n, w_dtype)
        assert plan.body == "decode" and plan.smem <= tmm.SMEM_MAX
        assert (plan.split, plan.slice, plan.smem) == \
            (fp.split, fp.slice, fp.smem)
        assert plan.share == max(g for g in (1, 2, 4, 8)
                                 if g * plan.split <= 8 and tiles % g == 0)
        if rows in (1, 4, 31, 128):
            _check_plan(plan, rows, k, n, 2 if w_dtype == "int8" else 1)


# the down projections' K slices at rows 4: split 8, past _DEC_SLICE
DENSE_7B_WD = {(18944, 3584): 1184, (11008, 4096): 688, (16384, 4096): 1024}


@pytest.mark.parametrize("k,n", sorted(DENSE_7B_WD))
def test_dense_7b_down_projection_slices_exceed_the_usual_cap(k, n):
    """At K 11008-18944 even the largest split leaves a block more than
    `_DEC_SLICE` pairs; the decode body still fits (int8 weights too)."""
    for w_dtype in ("int4", "int8"):
        plan = tmm.launch_plan(4, k, n, w_dtype)
        assert (plan.body, plan.split, plan.slice) == \
            ("decode", 8, DENSE_7B_WD[(k, n)])
        assert plan.slice > tmm._DEC_SLICE and plan.blocks >= 132


def test_slice_too_large_for_shared_memory_falls_back_to_fma():
    plan = tmm.launch_plan(8, 65536, 1024, "int8")
    assert plan.body == "fma"
    _check_plan(plan, 8, 65536, 1024, 2)
    with pytest.raises(ValueError, match="body"):
        tmm.launch_plan(4, 1024, 1024, "int4", "tensor")


_CTYPE = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
          "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("entry", sorted(tmm._SIGNATURE))
def test_ctypes_signature_matches_the_c_entry(entry):
    """A wrong argtypes silently cuts a pointer or shifts every later
    argument: each C entry's parameters, in order, match `_SIGNATURE`."""
    src = (Path(tmm.__file__).resolve().parent.parent / "csrc"
           / "ovp_matmul.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, entry
    # "const void* a" -> "const void*": the type is all but the name
    params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    assert [_CTYPE[p] for p in params] == tmm._SIGNATURE[entry]
