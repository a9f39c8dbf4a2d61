"""Hygiene pass: no broad exception handlers in `src/repro_torch/`.

A bare ``except:``, ``except Exception`` or ``except BaseException``
swallows typed failures that dispatch should surface as decline codes
or hard errors. Handlers name the exception types they mean, as a tuple
if there are several. A handler that re-raises the broad class
unconditionally is fine: that is narrowing, not swallowing.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Sequence

from . import Finding

REPO = Path(__file__).resolve().parents[3]
SRC = REPO / "src" / "repro_torch"

_BROAD = ("Exception", "BaseException")


def _names(expr: ast.AST) -> List[str]:
    """Exception-class names an `except <expr>` clause mentions."""
    out: List[str] = []
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Name):
            out.append(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.append(sub.attr)
    return out


def _always_reraises(handler: ast.ExceptHandler) -> bool:
    """True when the handler's body holds a bare `raise` at top level."""
    return any(isinstance(stmt, ast.Raise) and stmt.exc is None
               for stmt in handler.body)


def scan_file(path: Path) -> List[Finding]:
    findings: List[Finding] = []
    tree = ast.parse(path.read_text(), filename=str(path))
    rel = path.relative_to(REPO).as_posix() if path.is_relative_to(REPO) \
        else path.name
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            findings.append(Finding(
                "HYG_BROAD_EXCEPT", f"{rel}:{node.lineno}",
                "bare `except:` — name the exception types this handler "
                "means (a tuple of types)"))
            continue
        broad = [n for n in _names(node.type) if n in _BROAD]
        if broad and not _always_reraises(node):
            findings.append(Finding(
                "HYG_BROAD_EXCEPT", f"{rel}:{node.lineno}",
                f"`except {broad[0]}` swallows typed failures — name the "
                f"exception types this handler means (a tuple of types)"))
    return findings


def check(fixtures: Sequence[str] = ()) -> List[Finding]:
    files = sorted(SRC.rglob("*.py"))
    files += [Path(f) for f in fixtures if str(f).endswith(".py")]
    findings: List[Finding] = []
    for path in files:
        findings.extend(scan_file(path))
    return findings
