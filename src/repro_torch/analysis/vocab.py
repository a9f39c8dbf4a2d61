"""Vocabulary pass: decline codes and stats keys against the port's
`backends/base.py` registry (the reference's codes, copied so dispatch
counts compare across the two packages).

Three directions of drift:

- **code -> registry**: AST-scan every module under the port's
  `backends/` and `kernels/` for decline-code string literals (returns
  inside `*decline*` functions, arguments of `decline(...)`), the
  `record_act_scale(...)` keys and the `"[...]"` dispatch markers; each
  must be registered (VOCAB_UNREGISTERED_CODE, VOCAB_BAD_STATS_KEY).
- **registry -> code**: every registered decline code is produced
  somewhere in the scanned source (VOCAB_UNUSED_CODE).
- **registry <-> docs**: the quoted tables of docs/backends.md and
  docs/sharding.md, read as they stand, list exactly the registered
  codes (VOCAB_UNDOCUMENTED_CODE, VOCAB_DOC_DRIFT).

Fixture files (seeded violations) are scanned with the same AST walk
but are exempt from the registry -> code and doc directions.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, List, Sequence, Set, Tuple

from . import Finding

REPO = Path(__file__).resolve().parents[3]
SRC = REPO / "src" / "repro_torch"
SCAN_DIRS = (SRC / "backends", SRC / "kernels")
DOC_VOCAB = (
    # (path, heading of the section holding the quoted tables)
    (REPO / "docs" / "backends.md", "Decline and dispatch vocabulary"),
    (REPO / "docs" / "sharding.md", "Sharded decline vocabulary"),
)

# decline codes are lower_snake identifiers of these families; the
# filter keeps ordinary literals ("int8", error text) and the
# `*_decline_reason` accessor names out of the scan
_CODE_RE = re.compile(
    r"^(?:shard|decode|paged|prefill|grouped|stacked|lhs|pair)_[a-z0-9_]+$")


def looks_like_code(s: str) -> bool:
    return bool(_CODE_RE.match(s)) and not s.endswith("_reason")


def _const_strings(node: ast.AST) -> Iterable[str]:
    """String constants of an expression (plain, `a if c else b`, boolean
    operators)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub.value


def scan_file(path: Path) -> Tuple[List[Tuple[str, str]],
                                   List[Tuple[str, str]],
                                   List[Tuple[str, str]]]:
    """(decline literals, act-scale keys, markers) of one file, each as
    (literal, where) pairs."""
    tree = ast.parse(path.read_text(), filename=str(path))
    declines: List[Tuple[str, str]] = []
    act_keys: List[Tuple[str, str]] = []
    markers: List[Tuple[str, str]] = []
    rel = path.name

    class V(ast.NodeVisitor):
        def __init__(self):
            self.fn_stack: List[str] = []

        def visit_FunctionDef(self, node):
            self.fn_stack.append(node.name)
            self.generic_visit(node)
            self.fn_stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Return(self, node):
            fn = self.fn_stack[-1] if self.fn_stack else ""
            if node.value is not None and "decline" in fn:
                for s in _const_strings(node.value):
                    if looks_like_code(s):
                        declines.append((s, f"{rel}::{fn}:{node.lineno}"))
            self.generic_visit(node)

        def visit_Call(self, node):
            name = ""
            if isinstance(node.func, ast.Name):
                name = node.func.id
            elif isinstance(node.func, ast.Attribute):
                name = node.func.attr
            where = f"{rel}:{node.lineno}"
            if name == "decline":
                for arg in node.args:
                    declines.extend((s, where) for s in _const_strings(arg))
            if name == "record_act_scale":
                for arg in node.args:
                    act_keys.extend((s, where) for s in _const_strings(arg))
            self.generic_visit(node)

        def visit_Constant(self, node):
            if isinstance(node.value, str) and node.value.startswith("[") \
                    and node.value.endswith("]") and len(node.value) > 2 \
                    and node.value[1:-1].isidentifier():
                markers.append((node.value, f"{rel}:{node.lineno}"))

    V().visit(tree)
    return declines, act_keys, markers


def _doc_codes(path: Path, heading: str) -> Set[str]:
    """Backtick tokens that look like decline codes, from one heading's
    section only (up to the next `## `)."""
    text = path.read_text()
    m = re.search(rf"^##+\s+{re.escape(heading)}\s*$", text, re.MULTILINE)
    if m is None:
        return set()
    section = text[m.end():]
    nxt = re.search(r"^## ", section, re.MULTILINE)
    if nxt:
        section = section[:nxt.start()]
    return {tok for tok in re.findall(r"`([a-z0-9_]+)`", section)
            if looks_like_code(tok)}


def check(fixtures: Sequence[str] = ()) -> List[Finding]:
    from repro_torch.backends.base import (ACT_SCALE_KEYS, ALL_DECLINE_CODES,
                                           DISPATCH_MARKERS)
    findings: List[Finding] = []
    repo_files = sorted(p for d in SCAN_DIRS for p in d.glob("*.py"))
    fixture_files = [Path(f) for f in fixtures if str(f).endswith(".py")]

    produced: Set[str] = set()
    for path, is_fixture in [(p, False) for p in repo_files] \
            + [(p, True) for p in fixture_files]:
        declines, act_keys, markers = scan_file(path)
        for code, where in declines:
            if code in ALL_DECLINE_CODES:
                if not is_fixture:
                    produced.add(code)
            else:
                findings.append(Finding(
                    "VOCAB_UNREGISTERED_CODE", where,
                    f"decline literal {code!r} is not registered in "
                    f"backends.base.DECLINE_CODES"))
        for key, where in act_keys:
            if key not in ACT_SCALE_KEYS:
                findings.append(Finding(
                    "VOCAB_BAD_STATS_KEY", where,
                    f"act-scale stats key {key!r} not in ACT_SCALE_KEYS "
                    f"{ACT_SCALE_KEYS}"))
        for marker, where in markers:
            if marker not in DISPATCH_MARKERS:
                findings.append(Finding(
                    "VOCAB_BAD_STATS_KEY", where,
                    f"dispatch marker {marker!r} not in DISPATCH_MARKERS "
                    f"{DISPATCH_MARKERS}"))

    for code in sorted(ALL_DECLINE_CODES - produced):
        findings.append(Finding(
            "VOCAB_UNUSED_CODE", "backends/base.py::DECLINE_CODES",
            f"registered decline code {code!r} is produced nowhere in "
            f"backends/ or kernels/"))

    documented: Set[str] = set()
    for path, heading in DOC_VOCAB:
        codes = _doc_codes(path, heading)
        documented |= codes
        for code in sorted(codes - ALL_DECLINE_CODES):
            findings.append(Finding(
                "VOCAB_DOC_DRIFT", f"{path.name}#{heading}",
                f"doc table lists {code!r}, which is not a registered "
                f"decline code"))
    for code in sorted(ALL_DECLINE_CODES - documented):
        findings.append(Finding(
            "VOCAB_UNDOCUMENTED_CODE", "docs/backends.md+docs/sharding.md",
            f"registered decline code {code!r} appears in neither quoted "
            f"doc table"))
    return findings
