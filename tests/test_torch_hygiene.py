"""Hygiene of the port: it stands apart from the JAX package, has no broad
exception handlers, and never reaches a kernel from a CPU tensor."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_dist import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_has_no_broad_except(path):
    broad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ExceptHandler):
            name = getattr(node.type, "id", None) if node.type else "bare"
            if name in ("bare", "Exception", "BaseException"):
                broad.append(node.lineno)
    assert not broad, f"{path.name}: broad except at lines {broad}"


def test_port_serves_on_cpu_without_jax_or_kernels():
    """A fresh interpreter imports the launcher, serves the smoke model on
    the CPU in slab mode and in paged mode through the async front end,
    and ends with no JAX module loaded and every kernel counter at 0:
    CPU tensors only ever take the plain versions."""
    code = (
        "import json, sys\n"
        "from repro_torch.launch import serve\n"
        "args = ['--arch', 'qwen1.5-0.5b-smoke', '--quant', 'olive_serve',\n"
        "        '--requests', '3', '--max-new', '3', '--slots', '2',\n"
        "        '--max-len', '32']\n"
        "slab = serve.run(args, device='cpu')\n"
        "paged = serve.run(args + ['--paged', '16', '--prefill-chunk',\n"
        "                          '16', '--async'], device='cpu')\n"
        "print(json.dumps({'jax': sorted(m for m in sys.modules\n"
        "                   if m.split('.')[0] in ('jax', 'jaxlib')),\n"
        "                  'tokens': [slab['tokens'], paged['tokens']],\n"
        "                  'launches': serve.kernel_launches()}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res == {"jax": [], "tokens": [9, 9],
                   "launches": {"ovp_matmul[fp]": 0,
                                "ovp_matmul[quantize]": 0,
                                "ovp_matmul[static]": 0,
                                "ovp_matmul[codes4]": 0,
                                "ovp_matmul[codes8]": 0,
                                "ovp_matmul<int4>": 0,
                                "ovp_matmul<flint4>": 0,
                                "ovp_matmul<int8>": 0,
                                "grouped[fp]": 0, "grouped[quantize]": 0,
                                "grouped[static]": 0, "grouped[codes4]": 0,
                                "grouped[codes8]": 0, "grouped<int4>": 0,
                                "grouped<flint4>": 0, "grouped<int8>": 0,
                                "ovp_encode": 0,
                                "decode_attn": 0, "paged_decode_attn": 0,
                                "prefill_attn": 0,
                                "decode_attn<int4>": 0,
                                "decode_attn<float32>": 0,
                                "decode_attn<bfloat16>": 0,
                                "decode_attn<float16>": 0,
                                "paged_decode_attn<int4>": 0,
                                "paged_decode_attn<float32>": 0,
                                "paged_decode_attn<bfloat16>": 0,
                                "paged_decode_attn<float16>": 0}}


def test_launcher_has_no_cpu_switch():
    """The CLI's flags are the reference launcher's, `--mesh` included;
    there is no device flag (without a card it raises)."""
    from repro_torch.launch import serve
    flags = {a.option_strings[0] for a in serve.parser()._actions
             if a.option_strings and a.option_strings[0] != "-h"}
    assert flags == {"--arch", "--quant", "--policy-rules", "--backend",
                     "--calibration", "--calibrate", "--requests",
                     "--max-new", "--slots", "--max-len", "--paged",
                     "--prefill-chunk", "--async", "--stream", "--mesh",
                     "--metrics-out", "--seed"}
