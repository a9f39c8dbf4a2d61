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
    the CPU, and ends with no JAX module loaded and both kernel counters
    at 0: CPU tensors only ever take the plain versions."""
    code = (
        "import json, sys\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.kernels import decode_attn, ovp_matmul\n"
        "res = serve.run(['--arch', 'qwen1.5-0.5b-smoke', '--quant',\n"
        "                 'olive_serve', '--requests', '3', '--max-new',\n"
        "                 '3', '--slots', '2', '--max-len', '32'],\n"
        "                device='cpu')\n"
        "print(json.dumps({'jax': sorted(m for m in sys.modules\n"
        "                   if m.split('.')[0] in ('jax', 'jaxlib')),\n"
        "                  'tokens': res['tokens'],\n"
        "                  'k1': ovp_matmul.fused_ovp_matmul.launches,\n"
        "                  'k2':\n"
        "                  decode_attn.fused_decode_attention.launches}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res == {"jax": [], "tokens": 9, "k1": 0, "k2": 0}


def test_launcher_has_no_cpu_switch():
    """The CLI's flags are the reference launcher's; there is no device
    flag (without a card it raises)."""
    from repro_torch.launch import serve
    flags = {a.option_strings[0] for a in serve.parser()._actions
             if a.option_strings and a.option_strings[0] != "-h"}
    assert flags == {"--arch", "--quant", "--backend", "--requests",
                     "--max-new", "--slots", "--max-len", "--seed"}
