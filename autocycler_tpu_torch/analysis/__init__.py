"""Static analysis for the port's own invariants (`autocycler lint`).

A self-contained AST-walking rule engine (stdlib ``ast`` only), the JAX
package's, that enforces the conventions the port runs on but nothing else
checks: knob-registry discipline, lock discipline around shared state,
purity inside compiled or captured call graphs, never-raise reader
contracts, Prometheus metric/span naming and the fault-site table.
"""

from .engine import (Finding, LintContext, Module, load_baseline, run_lint,
                     split_baseline, write_baseline)
from .rules import ALL_RULES, rule_ids

__all__ = [
    "ALL_RULES",
    "Finding",
    "LintContext",
    "Module",
    "load_baseline",
    "rule_ids",
    "run_lint",
    "split_baseline",
    "write_baseline",
]
