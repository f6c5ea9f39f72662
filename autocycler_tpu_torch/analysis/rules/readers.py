"""Never-raise reader contract.

Observability readers (``read_*``, ``*_report`` builders, ``follow*``
followers — obs/watch.py, obs/timeseries.py, obs/report.py and friends)
run against files another process is writing, half-written JSON, and runs
that died mid-stage.  They must degrade to empty results, never take the
caller down:

- ``readers.raise``: a ``raise`` statement anywhere in a reader (bare
  re-raise included);
- ``readers.unguarded-io``: ``open()``, ``Path.read_text/read_bytes`` or
  ``json.load/loads`` outside any ``try`` block.

Writers and pure renderers (``write_*``, ``render_*``) are exempt.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..engine import Finding, LintContext, Module

IO_READ_ATTRS = {"read_text", "read_bytes"}
EXEMPT_PREFIXES = ("write_", "render_")


def is_reader_name(name: str) -> bool:
    if name.startswith(EXEMPT_PREFIXES):
        return False
    return (name.startswith("read_")
            or name.endswith("_report")
            or name == "follow" or name.startswith("follow_"))


def _is_io_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Name) and fn.id == "open":
        return True
    if isinstance(fn, ast.Attribute):
        if fn.attr in IO_READ_ATTRS:
            return True
        if fn.attr in ("load", "loads") \
                and isinstance(fn.value, ast.Name) \
                and fn.value.id == "json":
            return True
    return False


def _inside_try(mod: Module, node: ast.AST, func: ast.AST) -> bool:
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.Try) and anc.handlers:
            return True
        if anc is func:
            return False
    return False


class ReaderRules:
    name = "readers"
    ids = ("readers.raise", "readers.unguarded-io")

    def check_module(self, mod: Module, ctx: LintContext
                     ) -> Iterable[Finding]:
        for func in ast.walk(mod.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not is_reader_name(func.name):
                continue
            for node in ast.walk(func):
                if isinstance(node, ast.Raise):
                    yield Finding(
                        "readers.raise", mod.rel, node.lineno,
                        f"never-raise reader '{func.name}' contains a "
                        "raise statement")
                elif _is_io_call(node) and not _inside_try(mod, node, func):
                    yield Finding(
                        "readers.unguarded-io", mod.rel, node.lineno,
                        f"file/JSON read in reader '{func.name}' outside "
                        "any try/except")
