"""Lock discipline for modules that own concurrency.

- ``locks.unguarded-global``: in a module that defines a module-level
  ``Lock``/``RLock``, a ``global X; X = ...`` rebind (or augmented
  assignment) executed outside any ``with <lock>:`` block.  The module
  declared its state shared by defining a lock; every writer must hold it.
  Functions named ``*_locked`` are exempt: the suffix is the repo's
  contract that the caller already holds the lock.
- ``locks.thread-daemon``: ``threading.Thread(...)`` constructed without
  ``daemon=True`` — the sampler/watcher/probe convention, so a wedged
  helper thread can never hold a process open.
- ``locks.guarded-field``: a class that declares its lock discipline with
  a ``_GUARDED_BY = {"_lock": ("_jobs", ...)}`` literal (the serve
  scheduler's contract, where N worker threads mutate one job table) gets
  every mutation of a guarded instance field checked: assignment,
  augmented assignment, subscript store and known mutator calls
  (``.pop``/``.update``/…) must sit inside ``with self.<lock>:``.
  ``__init__`` (single-threaded construction) and ``*_locked`` methods
  (caller holds the lock) are exempt.
"""

from __future__ import annotations

import ast
from typing import Iterable, Set

from ..engine import Finding, LintContext, Module

LOCK_FACTORIES = {"Lock", "RLock"}


def _callee_name(fn) -> str:
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def module_lock_names(mod: Module) -> Set[str]:
    names: Set[str] = set()
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if _callee_name(node.value.func) in LOCK_FACTORIES:
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        names.add(target.id)
    return names


def _own_scope_walk(func) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested defs/lambdas,
    so ``global`` declarations and writes attach to the right scope."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _under_lock(mod: Module, node: ast.AST, locks: Set[str]) -> bool:
    """Whether the statement sits lexically inside a ``with <lock>:`` in
    its own function (an enclosing function's lock does not protect a
    nested function body that runs later)."""
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                ce = item.context_expr
                if isinstance(ce, ast.Name) and ce.id in locks:
                    return True
        elif isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
    return False


# method calls that mutate a container in place — the guarded-field rule
# treats these as writes
MUTATOR_CALLS = {"append", "add", "update", "pop", "popitem", "clear",
                 "remove", "discard", "extend", "setdefault", "insert"}


def _guard_map(cls: ast.ClassDef) -> dict:
    """The class's ``_GUARDED_BY`` literal as {lock_field: {field, ...}},
    or {} when absent/unparseable (the rule only binds where the class
    opted in)."""
    for stmt in cls.body:
        if not isinstance(stmt, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "_GUARDED_BY"
                   for t in stmt.targets):
            continue
        try:
            value = ast.literal_eval(stmt.value)
        except (ValueError, SyntaxError, TypeError):
            return {}
        if not isinstance(value, dict):
            return {}
        return {str(lock): {str(f) for f in (fields or ())}
                for lock, fields in value.items() if isinstance(lock, str)}
    return {}


def _self_attr(node) -> str:
    """``self.<attr>`` -> the attr name, else ''."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return ""


def _under_self_lock(mod: Module, node: ast.AST, locks: Set[str]) -> bool:
    """Whether the statement sits lexically inside ``with self.<lock>:``
    in its own function."""
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                if _self_attr(item.context_expr) in locks:
                    return True
        elif isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
    return False


def _field_mutations(func) -> Iterable:
    """(node, field) pairs for every mutation of a ``self.<field>`` in the
    function's own scope: plain/aug/ann assignment, subscript store, and
    in-place mutator calls."""
    for node in _own_scope_walk(func):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                field = _self_attr(target)
                if field:
                    yield node, field
                elif isinstance(target, ast.Subscript):
                    field = _self_attr(target.value)
                    if field:
                        yield node, field
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in MUTATOR_CALLS:
            field = _self_attr(node.func.value)
            if field:
                yield node, field


class LockRules:
    name = "locks"
    ids = ("locks.unguarded-global", "locks.thread-daemon",
           "locks.guarded-field")

    def check_module(self, mod: Module, ctx: LintContext
                     ) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) \
                    and _callee_name(node.func) == "Thread":
                daemon_true = any(
                    kw.arg == "daemon"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                    for kw in node.keywords)
                if not daemon_true:
                    yield Finding(
                        "locks.thread-daemon", mod.rel, node.lineno,
                        "Thread(...) without daemon=True; helper threads "
                        "must not be able to hold the process open")

        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            guards = _guard_map(cls)
            if not guards:
                continue
            lock_names = set(guards)
            guarded = {f for fields in guards.values() for f in fields}
            for func in cls.body:
                if not isinstance(func, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if func.name == "__init__" or func.name.endswith("_locked"):
                    continue
                for node, field in _field_mutations(func):
                    if field not in guarded:
                        continue
                    if not _under_self_lock(mod, node, lock_names):
                        yield Finding(
                            "locks.guarded-field", mod.rel, node.lineno,
                            f"mutation of '{cls.name}.{field}' outside "
                            f"'with self.<lock>:' — _GUARDED_BY declares "
                            f"it lock-protected")

        locks = module_lock_names(mod)
        if not locks:
            return
        for func in ast.walk(mod.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if func.name.endswith("_locked"):
                continue    # contract: caller holds the lock
            declared_global: Set[str] = set()
            for stmt in _own_scope_walk(func):
                if isinstance(stmt, ast.Global):
                    declared_global.update(stmt.names)
            if not declared_global:
                continue
            for node in _own_scope_walk(func):
                if isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    for target in targets:
                        if not (isinstance(target, ast.Name)
                                and target.id in declared_global):
                            continue
                        if not _under_lock(mod, node, locks):
                            yield Finding(
                                "locks.unguarded-global", mod.rel,
                                node.lineno,
                                f"write to module global '{target.id}' "
                                "outside a 'with <lock>:' block in a "
                                "module that defines a lock")
