"""`autocycler lint` — run the static invariant checks over the port.

Defaults to linting the port's package and the repo-level chip_smoke.py
when run from a source tree, against the port's committed baseline,
``lint_baseline_torch.json``.  Exit code 0 means no non-baselined
findings.

Also the home of ``--knobs-md`` (prints the knob table embedded in
docs_torch/cli.md) and ``--write-baseline`` (accepts the current findings
as the new baseline).  ``--report`` writes a ``lint_report.json`` artifact
readable by ``autocycler report`` and ``autocycler doctor``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import List, Optional

from ..analysis import (LintContext, load_baseline, run_lint,
                        split_baseline, write_baseline)
from ..analysis.rules import rule_ids
from ..utils.knobs import knobs_markdown

BASELINE_NAME = "lint_baseline_torch.json"
DOCS_DIR = "docs_torch"


def repo_root() -> Path:
    """The source tree root (the directory holding the package dir)."""
    return Path(__file__).resolve().parents[2]


def default_paths(root: Path) -> List[Path]:
    out = [root / "autocycler_tpu_torch"]
    if (root / "chip_smoke.py").exists():
        out.append(root / "chip_smoke.py")
    return out


def default_baseline() -> Path:
    return repo_root() / BASELINE_NAME


def run(paths: Optional[List[str]] = None,
        baseline: Optional[str] = None,
        rules: Optional[List[str]] = None,
        write_baseline_path: Optional[str] = None,
        report_path: Optional[str] = None,
        docs: Optional[str] = None) -> dict:
    """The reusable core: returns the result dict the CLI renders."""
    root = repo_root()
    targets = [Path(p) for p in paths] if paths else default_paths(root)
    default_docs = root / DOCS_DIR / "cli.md"
    docs_path = Path(docs) if docs else (
        default_docs if default_docs.exists() else None)
    ctx = LintContext(root=root, docs_path=docs_path)
    start = time.perf_counter()
    findings, n_files = run_lint(targets, ctx, selectors=rules)
    wall_s = time.perf_counter() - start
    baseline_path = Path(baseline) if baseline else default_baseline()
    baseline_keys = load_baseline(baseline_path) \
        if baseline_path.exists() else set()
    new, old = split_baseline(findings, baseline_keys)
    if write_baseline_path:
        write_baseline(findings, write_baseline_path)
    result = {
        "files": n_files,
        "wall_s": round(wall_s, 4),
        "findings": [f.to_dict() for f in new],
        "baselined": len(old),
        "baseline": str(baseline_path) if baseline_path.exists() else None,
        "rules": list(rules) if rules else sorted(rule_ids()),
    }
    if report_path:
        payload = dict(result, generated_at=round(time.time(), 3))
        Path(report_path).write_text(
            json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return result


def lint(paths: Optional[List[str]] = None,
         baseline: Optional[str] = None,
         rules: Optional[List[str]] = None,
         as_json: bool = False,
         write_baseline_path: Optional[str] = None,
         report_path: Optional[str] = None,
         knobs_md: bool = False) -> int:
    """CLI entry. Returns the process exit code."""
    if knobs_md:
        print(knobs_markdown(), end="")
        return 0
    known = rule_ids()
    for sel in rules or ():
        if not any(r == sel or r.startswith(sel + ".") for r in known):
            print(f"autocycler lint: unknown rule {sel!r} "
                  f"(known: {', '.join(known)})")
            return 2
    result = run(paths=paths, baseline=baseline, rules=rules,
                 write_baseline_path=write_baseline_path,
                 report_path=report_path)
    if as_json:
        print(json.dumps(result, indent=2, sort_keys=True))
    else:
        for f in result["findings"]:
            print(f"{f['path']}:{f['line']}: [{f['rule']}] {f['message']}")
        status = ("clean" if not result["findings"]
                  else f"{len(result['findings'])} finding(s)")
        print(f"lint: {status} across {result['files']} files "
              f"in {result['wall_s']:.2f}s"
              + (f" ({result['baselined']} baselined)"
                 if result["baselined"] else ""))
    if write_baseline_path:
        total = len(result["findings"]) + result["baselined"]
        print(f"lint: wrote baseline with {total} finding(s) "
              f"to {write_baseline_path}")
        return 0
    return 0 if not result["findings"] else 1
