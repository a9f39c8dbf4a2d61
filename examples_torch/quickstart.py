"""OliVe quickstart on the port: OVP-quantize a tensor, inspect the
encoding, run the fused OVP-decode matmul, and see why outlier-blind
int4 fails. Port of `examples/quickstart.py`.

Run:  PYTHONPATH=src python examples_torch/quickstart.py

On the card the last section launches the hand-written fused matmul
(`kernels.ops.matmul_w4a16`, K1 in `fp` mode); `report(x, a, "cpu")`
runs its plain PyTorch version. The inputs come from numpy's
`default_rng` (the reference draws JAX's threefry, which the port does
not reproduce), so both packages can be fed the same arrays.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples_torch.fixture import check_device  # noqa: E402

from repro_torch.core import baselines  # noqa: E402
from repro_torch.core.datatypes import ABFLOAT_FOR_NORMAL  # noqa: E402
from repro_torch.core.ovp import (ovp_dequantize, ovp_quantize,  # noqa: E402
                                  pair_statistics, unpack4)
from repro_torch.core.quantizer import (QuantSpec,  # noqa: E402
                                        quantization_error, quantize,
                                        sigma_init_scale)
from repro_torch.kernels import ops, ref  # noqa: E402

OUTLIERS = ((3, 17, 41.0), (100, 200, -57.0), (200, 333, 88.0))


def inputs():
    """x (256, 512): a Gaussian bulk with three huge outliers; a (64,
    256): the matmul's activations."""
    x = np.random.default_rng(0).standard_normal((256, 512)) \
        .astype(np.float32)
    for i, j, v in OUTLIERS:
        x[i, j] = v
    a = np.random.default_rng(1).standard_normal((64, 256)) \
        .astype(np.float32)
    return x, a


def report(x: np.ndarray, a: np.ndarray, device="cuda") -> dict:
    """Every number the script prints, computed on `device`: the pair
    statistics, the PTQ's packed bytes and SQNR, the outliers after OVP
    and after int4, the first victim's code pair, the abfloat
    magnitudes and the fused matmul against its oracle."""
    device = check_device(device, "examples_torch/quickstart.py")
    xt = torch.as_tensor(x, device=device)
    out = {"stats": {k: float(v) for k, v in
                     pair_statistics(xt.reshape(-1)).items()}}
    qt = quantize(xt, QuantSpec(normal_dtype="int4", granularity="tensor"))
    out["packed_bytes"], out["fp32_bytes"] = qt.nbytes(), xt.numel() * 4
    out["sqnr_db"] = quantization_error(xt, QuantSpec(normal_dtype="int4")
                                        )["sqnr_db"]
    xh = ovp_dequantize(qt)
    xi4 = baselines.uniform_int_fake_quant(xt, 4)
    out["outliers"] = [(i, j, float(xt[i, j]), float(xh[i, j]),
                        float(xi4[i, j])) for i, j, _ in OUTLIERS]
    codes = unpack4(qt.data, qt.pair_axis)
    vi, vj = (int(c) for c in torch.nonzero(codes == 0x8)[0])
    pj = vj + 1 if vj % 2 == 0 else vj - 1
    out["victim"] = (vi, vj, pj, int(codes[vi, vj]), int(codes[vi, pj]))
    spec = ABFLOAT_FOR_NORMAL["int4"]
    out["abfloat"] = (spec.bias, [float(m) for m in spec.magnitudes()])
    at = torch.as_tensor(a, device=device)
    wq = ovp_quantize(xt, sigma_init_scale(xt, "int4"), "int4", pair_axis=0)
    got = ops.matmul_w4a16(at, wq.data, wq.scale)
    want = ref.ovp_matmul_w4a16_ref(at, wq.data) * wq.scale
    out["kernel_err"] = float((got - want).abs().max())
    out["kernel"] = ("hand-written CUDA kernel, K1 fp" if device.type ==
                     "cuda" else "plain PyTorch version, CPU")
    return out


def main(argv=None, device="cuda") -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]) \
        .parse_args(argv)
    r = report(*inputs(), device=device)
    print("== pair statistics (paper Table 2) ==")
    for k, v in r["stats"].items():
        print(f"  {k}: {v:.6f}")

    print("\n== OliVe PTQ (scale search + OVP encode + pack) ==")
    print(f"  packed bytes: {r['packed_bytes']}  (fp32 was "
          f"{r['fp32_bytes']})")
    print(f"  sqnr: {r['sqnr_db']:.2f} dB")
    for i, j, v, vq, _ in r["outliers"]:
        print(f"  outlier x[{i},{j}] = {v:+.1f}  ->  {vq:+.1f}")
    print("  int4 (outlier-blind):     "
          + "  ".join(f"{v4:+.2f}" for *_, v4 in r["outliers"]))

    print("\n== the byte IS the pair: inspect one OV pair ==")
    vi, vj, pj, cv, co = r["victim"]
    print(f"  codes[{vi},{vj}] = 0x{cv:x} (victim id), "
          f"codes[{vi},{pj}] = 0x{co:x} (abfloat outlier)")
    bias, mags = r["abfloat"]
    print(f"  abfloat E2M1 bias={bias}: magnitudes {mags}")

    print(f"\n== fused OVP-decode matmul ({r['kernel']}) ==")
    print(f"  kernel vs oracle max err: {r['kernel_err']:.2e}")
    print("done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
