"""Knob-registry discipline.

- ``knobs.direct-read``: an ``AUTOCYCLER_*`` name read straight from
  ``os.environ`` (``.get``/``getenv``/subscript load) anywhere outside
  the port's registry, ``autocycler_tpu_torch/utils/knobs.py``.  Writes
  (``environ[...] = ``, ``setdefault``, ``pop``, ``del``) stay legal —
  chip_smoke.py and tests pin knobs that way.
- ``knobs.undeclared``: a call of one of the port's accessors
  (``knob_*``) naming a knob that is not declared in the registry.
- ``knobs.docs-drift``: the registry and the generated knob table in
  docs_torch/cli.md disagree (either direction).  Only the region between
  the ``<!-- knobs:begin -->`` / ``<!-- knobs:end -->`` markers is
  compared, so CLI usage placeholders elsewhere in the file don't count.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, List

from ..engine import Finding, LintContext, Module

KNOB_RE = re.compile(r"^AUTOCYCLER_[A-Z0-9_]+$")
KNOB_TOKEN_RE = re.compile(r"AUTOCYCLER_[A-Z0-9_]+")
ACCESSORS = ("knob_int", "knob_float", "knob_bool", "knob_str",
             "knob_raw", "knob_set")
DOCS_BEGIN = "<!-- knobs:begin -->"
DOCS_END = "<!-- knobs:end -->"
# the one module that may read the environment for a knob
REGISTRY_MODULE = "autocycler_tpu_torch/utils/knobs.py"


def _const_str(node) -> str:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return ""


def _is_os_environ(node) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name) and node.value.id == "os")


def _registry():
    from ...utils.knobs import KNOBS
    return KNOBS


class KnobRules:
    name = "knobs"
    ids = ("knobs.direct-read", "knobs.undeclared", "knobs.docs-drift")

    def check_module(self, mod: Module, ctx: LintContext
                     ) -> Iterable[Finding]:
        if mod.rel.replace("\\", "/").endswith(REGISTRY_MODULE):
            return
        consts = mod.module_str_constants()
        declared = _registry()

        def resolve(node) -> str:
            value = _const_str(node)
            if not value and isinstance(node, ast.Name):
                value = consts.get(node.id, "")
            return value

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                fn = node.func
                env_get = (isinstance(fn, ast.Attribute) and fn.attr == "get"
                           and _is_os_environ(fn.value))
                getenv = ((isinstance(fn, ast.Attribute)
                           and fn.attr == "getenv"
                           and isinstance(fn.value, ast.Name)
                           and fn.value.id == "os")
                          or (isinstance(fn, ast.Name)
                              and fn.id == "getenv"))
                if (env_get or getenv) and node.args:
                    name = resolve(node.args[0])
                    if KNOB_RE.match(name):
                        yield Finding(
                            "knobs.direct-read", mod.rel, node.lineno,
                            f"direct environment read of {name}; go through "
                            "the typed accessors in utils/knobs.py")
                        continue
                meth = (fn.id if isinstance(fn, ast.Name)
                        else fn.attr if isinstance(fn, ast.Attribute)
                        else None)
                if meth in ACCESSORS and node.args:
                    name = resolve(node.args[0])
                    if KNOB_RE.match(name) and name not in declared:
                        yield Finding(
                            "knobs.undeclared", mod.rel, node.lineno,
                            f"{meth}() reads {name}, which is not declared "
                            "in the utils/knobs.py registry")
            elif isinstance(node, ast.Subscript) and _is_os_environ(node.value):
                if isinstance(node.ctx, ast.Load):
                    name = resolve(node.slice)
                    if KNOB_RE.match(name):
                        yield Finding(
                            "knobs.direct-read", mod.rel, node.lineno,
                            f"direct environment read of {name}; go through "
                            "the typed accessors in utils/knobs.py")

    def check_project(self, modules: List[Module], ctx: LintContext
                      ) -> List[Finding]:
        docs = ctx.docs_path
        if docs is None:
            return []
        docs = Path(docs)
        try:
            rel = docs.resolve().relative_to(ctx.root.resolve()).as_posix()
        except ValueError:
            rel = docs.as_posix()
        try:
            lines = docs.read_text().splitlines()
        except OSError as e:
            return [Finding("knobs.docs-drift", rel, 1,
                            f"knob docs unreadable: {e}")]
        begin = end = None
        for i, line in enumerate(lines, start=1):
            if DOCS_BEGIN in line and begin is None:
                begin = i
            elif DOCS_END in line and begin is not None:
                end = i
                break
        if begin is None or end is None:
            return [Finding(
                "knobs.docs-drift", rel, 1,
                f"missing {DOCS_BEGIN} / {DOCS_END} markers around the "
                "generated knob table (autocycler lint --knobs-md)")]
        documented = {}
        for i in range(begin, end):
            for token in KNOB_TOKEN_RE.findall(lines[i - 1]):
                documented.setdefault(token, i)
        out: List[Finding] = []
        for name in _registry():
            if name not in documented:
                out.append(Finding(
                    "knobs.docs-drift", rel, begin,
                    f"declared knob {name} is missing from the knob table "
                    "(regenerate with autocycler lint --knobs-md)"))
        for name, line in sorted(documented.items()):
            if name not in _registry():
                out.append(Finding(
                    "knobs.docs-drift", rel, line,
                    f"documented knob {name} is not declared in "
                    "utils/knobs.py"))
        return out
