"""Metric and span naming hygiene, checked statically.

A registry snapshot shows only the names a run happens to touch.  These
rules apply the Prometheus conventions to every ``counter_inc``/``gauge_set``/
``observe``/``info_set`` call site in the source, resolving first
arguments through the module-level string-constant idiom
(``DEVICE_SECONDS = "autocycler_device_seconds_total"``).  Dynamic names
that cannot be resolved statically are skipped.

- ``metrics.name``: name regex, ``__``, ``_total`` reserved for counters
  and required on them, histograms need a unit suffix and must not end in
  ``_count``/``_sum``/``_bucket``;
- ``metrics.label``: label-name regex and the reserved Prometheus labels;
- ``metrics.span``: literal span names (or the literal head of an
  f-string) must be lowercase slug-like.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Optional

from ..engine import Finding, LintContext, Module

NAME_RE = re.compile(r"^autocycler_[a-z][a-z0-9_]*[a-z0-9]$")
LABEL_RE = re.compile(r"^[a-z][a-z0-9_]*$")
SPAN_RE = re.compile(r"^[a-z0-9][a-z0-9_./: -]*$")
UNIT_SUFFIXES = ("_seconds", "_bytes", "_ratio")
FORBIDDEN_HIST_SUFFIXES = ("_count", "_sum", "_bucket")
RESERVED_LABELS = {"le", "quantile", "job", "instance"}
KIND_BY_METHOD = {"counter_inc": "counter", "gauge_set": "gauge",
                  "observe": "histogram", "info_set": "info"}
NON_LABEL_KWARGS = {"help", "buckets", "value"}


def _resolve_name(node, consts) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def _name_findings(name: str, kind: str):
    if not NAME_RE.match(name):
        yield (f"metric name {name!r} does not match "
               "^autocycler_[a-z][a-z0-9_]*[a-z0-9]$")
        return
    if "__" in name:
        yield f"metric name {name!r} contains a double underscore"
    if kind == "counter" and not name.endswith("_total"):
        yield f"counter {name!r} must end with _total"
    if kind != "counter" and name.endswith("_total"):
        yield (f"{kind} {name!r} must not end with _total "
               "(reserved for counters)")
    if kind == "histogram":
        if not name.endswith(UNIT_SUFFIXES):
            yield (f"histogram {name!r} needs a unit suffix "
                   f"({', '.join(UNIT_SUFFIXES)})")
        if name.endswith(FORBIDDEN_HIST_SUFFIXES):
            yield (f"histogram {name!r} must not end with "
                   "_count/_sum/_bucket (Prometheus series suffixes)")


class MetricsRules:
    name = "metrics"
    ids = ("metrics.name", "metrics.label", "metrics.span")

    def check_module(self, mod: Module, ctx: LintContext
                     ) -> Iterable[Finding]:
        if mod.rel.replace("\\", "/").endswith("obs/metrics_registry.py"):
            return     # the registry plumbs names through variables
        consts = mod.module_str_constants()
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            meth = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)
            if meth in KIND_BY_METHOD:
                kind = KIND_BY_METHOD[meth]
                name = (_resolve_name(node.args[0], consts)
                        if node.args else None)
                if name is not None:
                    for msg in _name_findings(name, kind):
                        yield Finding("metrics.name", mod.rel,
                                      node.lineno, msg)
                for kw in node.keywords:
                    if kw.arg is None or kw.arg in NON_LABEL_KWARGS:
                        continue
                    if kw.arg in RESERVED_LABELS:
                        yield Finding(
                            "metrics.label", mod.rel, node.lineno,
                            f"label {kw.arg!r} is reserved by Prometheus")
                    elif not LABEL_RE.match(kw.arg):
                        yield Finding(
                            "metrics.label", mod.rel, node.lineno,
                            f"label {kw.arg!r} does not match "
                            "^[a-z][a-z0-9_]*$")
            elif meth == "span" and node.args:
                head = None
                arg = node.args[0]
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str):
                    head = arg.value
                elif isinstance(arg, ast.JoinedStr) and arg.values \
                        and isinstance(arg.values[0], ast.Constant) \
                        and isinstance(arg.values[0].value, str):
                    head = arg.values[0].value
                if head and not SPAN_RE.match(head):
                    yield Finding(
                        "metrics.span", mod.rel, node.lineno,
                        f"span name {head!r} is not a lowercase slug "
                        "([a-z0-9_./: -], lowercase start)")
