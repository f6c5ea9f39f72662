"""Purity inside compiled or captured call graphs.

``purity.impure-call`` flags host side effects and device-sync coercions
inside any function reachable from a compile or capture site in the same
module: ``time.*``, stdlib ``random.*`` and ``np.random.*`` (a
``torch.Generator`` passed in stays legal), ``os.environ``, ``print``,
``open``, ``.item()`` and ``float(...)`` coercions.  A host effect inside
a compiled graph runs once at trace time, and inside a captured CUDA graph
never again on replay; a sync coercion breaks the graph or the capture.

The roots are the port's counterparts of the JAX package's
``jit``/``vmap``/``pallas_call``: ``torch.compile``, ``torch.jit.script``/
``trace``, ``torch.func.vmap``/``vmap`` and ``make_graphed_callables`` as
decorators (``@torch.compile``, ``@torch.compile(...)``,
``@partial(torch.compile, ...)``) or applied to a function
(``torch.compile(fn)``), and every function called inside a
``with torch.cuda.graph(...):`` capture block.  Reachability is the JAX
rule's module-local, name-based call graph: a BFS over plain-name calls.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Set

from ..engine import Finding, LintContext, Module

COMPILE_WRAPPERS = {"compile", "script", "trace", "vmap",
                    "make_graphed_callables"}
CAPTURE_CONTEXTS = {"graph"}


def _callee_name(fn) -> str:
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def compile_roots(mod: Module, funcs: Dict[str, ast.AST]) -> Set[str]:
    roots: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if _callee_name(target) in COMPILE_WRAPPERS:
                    roots.add(node.name)
                elif isinstance(dec, ast.Call) \
                        and _callee_name(dec.func) == "partial" \
                        and dec.args \
                        and _callee_name(dec.args[0]) in COMPILE_WRAPPERS:
                    roots.add(node.name)
        elif isinstance(node, ast.Call) \
                and _callee_name(node.func) in COMPILE_WRAPPERS \
                and node.args and isinstance(node.args[0], ast.Name):
            roots.add(node.args[0].id)
        elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call)
                and _callee_name(item.context_expr.func) in CAPTURE_CONTEXTS
                for item in node.items):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Name):
                        roots.add(sub.func.id)
    return roots & set(funcs)


def _reachable(funcs: Dict[str, ast.AST], roots: Set[str]) -> Set[str]:
    reach: Set[str] = set()
    stack = list(roots)
    while stack:
        name = stack.pop()
        if name in reach:
            continue
        reach.add(name)
        for node in ast.walk(funcs[name]):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id in funcs \
                    and node.func.id not in reach:
                stack.append(node.func.id)
    return reach


def _impure_reason(node: ast.AST) -> str:
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name):
            if fn.id == "print":
                return "print() (host side effect)"
            if fn.id == "open":
                return "open() (host I/O)"
            if fn.id == "float" and node.args:
                return "float(...) coercion (forces device sync)"
        elif isinstance(fn, ast.Attribute):
            if isinstance(fn.value, ast.Name) and fn.value.id == "time":
                return f"time.{fn.attr}() (host clock)"
            if isinstance(fn.value, ast.Name) and fn.value.id == "random":
                return (f"random.{fn.attr}() (host RNG; pass a "
                        "torch.Generator)")
            if isinstance(fn.value, ast.Attribute) \
                    and fn.value.attr == "random" \
                    and isinstance(fn.value.value, ast.Name) \
                    and fn.value.value.id in ("np", "numpy"):
                return (f"np.random.{fn.attr}() (host RNG; "
                        "pass a torch.Generator)")
            if fn.attr == "item" and not node.args:
                return ".item() (forces device sync)"
    elif isinstance(node, ast.Attribute) and node.attr == "environ" \
            and isinstance(node.value, ast.Name) and node.value.id == "os":
        return "os.environ access (host state)"
    return ""


class PurityRules:
    name = "purity"
    ids = ("purity.impure-call",)

    def check_module(self, mod: Module, ctx: LintContext
                     ) -> Iterable[Finding]:
        funcs: Dict[str, ast.AST] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.setdefault(node.name, node)
        roots = compile_roots(mod, funcs)
        if not roots:
            return
        for name in sorted(_reachable(funcs, roots)):
            func = funcs[name]
            for node in ast.walk(func):
                reason = _impure_reason(node)
                if reason:
                    yield Finding(
                        "purity.impure-call", mod.rel, node.lineno,
                        f"{reason} inside '{name}', which is reachable "
                        "from a compile/vmap/CUDA-graph capture site")
