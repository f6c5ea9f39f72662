"""Fault-site documentation discipline.

- ``faults.documented``: the port's fault-site registry
  (``utils/resilience.FAULT_SITES``, which includes the registered
  ``CRASH_POINTS``) and the site table of docs_torch/failure-modes.md,
  beside the knob table's page, disagree (either direction).  Only the region
  between the ``<!-- faults:begin -->`` / ``<!-- faults:end -->``
  markers is compared, and only each table row's first backticked cell
  counts as a documented site, so prose mentions elsewhere in the file
  don't mask a missing row.

Chaos recovery claims live in that table (crash point -> what survives,
how resume re-enters); this rule is what keeps the table honest when a
new fault hook or crash point lands in code.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterable, List

from ..engine import Finding, LintContext, Module

DOCS_BEGIN = "<!-- faults:begin -->"
DOCS_END = "<!-- faults:end -->"
DOCS_NAME = "failure-modes.md"
# a table row whose first cell is one backticked site token
ROW_RE = re.compile(r"^\s*\|\s*`([a-z][a-z0-9_-]*)`\s*\|")


def _registry():
    from ...utils.resilience import FAULT_SITES
    return FAULT_SITES


class FaultRules:
    name = "faults"
    ids = ("faults.documented",)

    def check_module(self, mod: Module, ctx: LintContext
                     ) -> Iterable[Finding]:
        return ()

    def check_project(self, modules: List[Module], ctx: LintContext
                      ) -> List[Finding]:
        # same gate as the knob docs rule: no docs tree (linting an
        # arbitrary target, not this repo) -> nothing to check. A missing
        # failure-modes.md counts as "no docs tree" too, exactly like a
        # missing cli.md does for the knob rule.
        if ctx.docs_path is None:
            return []
        docs = Path(ctx.docs_path).parent / DOCS_NAME
        if not docs.is_file():
            return []
        try:
            rel = docs.resolve().relative_to(ctx.root.resolve()).as_posix()
        except ValueError:
            rel = docs.as_posix()
        try:
            lines = docs.read_text().splitlines()
        except OSError as e:
            return [Finding("faults.documented", rel, 1,
                            f"fault-site docs unreadable: {e}")]
        begin = end = None
        for i, line in enumerate(lines, start=1):
            if DOCS_BEGIN in line and begin is None:
                begin = i
            elif DOCS_END in line and begin is not None:
                end = i
                break
        if begin is None or end is None:
            return [Finding(
                "faults.documented", rel, 1,
                f"missing {DOCS_BEGIN} / {DOCS_END} markers around the "
                "fault-site table (one row per utils/resilience.FAULT_SITES "
                "entry)")]
        documented = {}
        for i in range(begin, end):
            m = ROW_RE.match(lines[i - 1])
            if m:
                documented.setdefault(m.group(1), i)
        out: List[Finding] = []
        for site in _registry():
            if site not in documented:
                out.append(Finding(
                    "faults.documented", rel, begin,
                    f"fault site {site} (utils/resilience.FAULT_SITES) has "
                    "no row in the fault-site table"))
        for site, line in sorted(documented.items()):
            if site not in _registry():
                out.append(Finding(
                    "faults.documented", rel, line,
                    f"documented fault site {site} is not registered in "
                    "utils/resilience.FAULT_SITES"))
        return out
