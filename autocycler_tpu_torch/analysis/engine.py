"""The lint engine: file discovery, AST modules, suppressions, baselines.

Rules (see :mod:`.rules`) are callables over a parsed :class:`Module` (or,
for cross-file checks, over the whole batch) that yield :class:`Finding`
objects.  The engine layers two escape hatches on top:

- per-line suppressions: ``# lint: ignore[rule-id]`` on the offending line
  (bare ``# lint: ignore`` silences every rule on that line; a family
  prefix like ``knobs`` silences every ``knobs.*`` rule);
- a committed baseline file (the port's ``lint_baseline_torch.json``)
  holding fingerprints of accepted findings, so new code is held to the
  bar without blocking on archaeology.

Fingerprints hash (rule, path, message) — deliberately not the line
number, so unrelated edits above a baselined finding don't un-baseline it.
"""

from __future__ import annotations

import ast
import hashlib
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*ignore(?:\[(?P<rules>[A-Za-z0-9_.,\s-]*)\])?")

SKIP_DIRS = {"__pycache__", ".git", ".cache", "node_modules", ".venv",
             "build", "dist"}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # posix-style path relative to the lint root
    line: int
    message: str

    def fingerprint(self) -> str:
        key = f"{self.rule}|{self.path}|{self.message}"
        return hashlib.sha1(key.encode("utf-8")).hexdigest()[:12]

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "fingerprint": self.fingerprint()}

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def rule_matches(selector: str, rule_id: str) -> bool:
    """``knobs`` matches every ``knobs.*`` rule; exact ids match themselves."""
    return rule_id == selector or rule_id.startswith(selector + ".")


def _parse_suppressions(lines: Sequence[str]) -> Dict[int, Optional[Set[str]]]:
    """{1-based line: None (suppress all) or set of rule selectors}."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, text in enumerate(lines, start=1):
        if "lint:" not in text:
            continue
        m = SUPPRESS_RE.search(text)
        if not m:
            continue
        raw = m.group("rules")
        if raw is None or not raw.strip():
            out[i] = None
        else:
            out[i] = {part.strip() for part in raw.split(",") if part.strip()}
    return out


class Module:
    """One parsed source file, with parent links and suppression info."""

    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self.suppressions = _parse_suppressions(self.lines)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child._lint_parent = node  # type: ignore[attr-defined]

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return getattr(node, "_lint_parent", None)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def suppressed(self, line: int, rule_id: str) -> bool:
        sel = self.suppressions.get(line, False)
        if sel is False:
            return False
        if sel is None:
            return True
        return any(rule_matches(s, rule_id) for s in sel)

    def module_str_constants(self) -> Dict[str, str]:
        """Module-level ``NAME = "literal"`` assignments (the metric-name
        constant idiom) for resolving Name references statically."""
        out: Dict[str, str] = {}
        for node in self.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                out[node.targets[0].id] = node.value.value
        return out


@dataclass
class LintContext:
    root: Path                      # paths in findings are relative to this
    docs_path: Optional[Path] = None  # the knob table's page (docs-drift)


def iter_python_files(paths: Sequence[Path]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_file() and p.suffix == ".py":
            files.append(p)
        elif p.is_dir():
            for sub in sorted(p.rglob("*.py")):
                if not any(part in SKIP_DIRS for part in sub.parts):
                    files.append(sub)
    seen: Set[Path] = set()
    out = []
    for f in files:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            out.append(f)
    return out


def _relpath(path: Path, root: Path) -> str:
    try:
        return path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def load_modules(paths: Sequence[Path], ctx: LintContext
                 ) -> Tuple[List[Module], List[Finding]]:
    """Parse every file; unparseable files become findings, not crashes."""
    modules: List[Module] = []
    errors: List[Finding] = []
    for f in iter_python_files(paths):
        rel = _relpath(f, ctx.root)
        try:
            source = f.read_text(encoding="utf-8", errors="replace")
            modules.append(Module(f, rel, source))
        except SyntaxError as e:
            errors.append(Finding("engine.parse", rel, e.lineno or 1,
                                  f"syntax error: {e.msg}"))
        except OSError as e:
            errors.append(Finding("engine.parse", rel, 1,
                                  f"unreadable: {e}"))
    return modules, errors


def run_lint(paths: Sequence[Path], ctx: LintContext,
             rules: Optional[Sequence] = None,
             selectors: Optional[Sequence[str]] = None
             ) -> Tuple[List[Finding], int]:
    """Run rules over paths. Returns (non-suppressed findings sorted by
    path/line, number of files checked). ``selectors`` filters rule ids
    (family prefixes allowed)."""
    from .rules import ALL_RULES
    active = list(rules if rules is not None else ALL_RULES)
    modules, findings = load_modules(paths, ctx)
    # one engine.parse finding per unparseable file: those files were
    # still checked, so they count
    n_files = len(modules) + len(findings)
    for rule in active:
        for mod in modules:
            for finding in rule.check_module(mod, ctx):
                if not mod.suppressed(finding.line, finding.rule):
                    findings.append(finding)
        project_check = getattr(rule, "check_project", None)
        if project_check is not None:
            findings.extend(project_check(modules, ctx))
    if selectors:
        findings = [f for f in findings
                    if any(rule_matches(s, f.rule) for s in selectors)]
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings, n_files


# ---- baseline ----

def load_baseline(path) -> Set[Tuple[str, str, str]]:
    """{(rule, path, fingerprint)} from a baseline file; empty when the
    file is missing or unreadable (a broken baseline must not hide new
    findings silently — it surfaces as every finding being 'new')."""
    try:
        data = json.loads(Path(path).read_text())
        return {(e["rule"], e["path"], e["fingerprint"])
                for e in data.get("findings", [])}
    except (OSError, ValueError, KeyError, TypeError):
        return set()


def split_baseline(findings: Sequence[Finding],
                   baseline: Set[Tuple[str, str, str]]
                   ) -> Tuple[List[Finding], List[Finding]]:
    """(new findings, baselined findings)."""
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        key = (f.rule, f.path, f.fingerprint())
        (old if key in baseline else new).append(f)
    return new, old


def write_baseline(findings: Sequence[Finding], path) -> None:
    entries = [{"rule": f.rule, "path": f.path, "message": f.message,
                "fingerprint": f.fingerprint()} for f in findings]
    entries.sort(key=lambda e: (e["path"], e["rule"], e["message"]))
    payload = {"version": 1, "findings": entries}
    Path(path).write_text(json.dumps(payload, indent=2, sort_keys=True)
                          + "\n")
