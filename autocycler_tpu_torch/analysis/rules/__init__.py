"""The lint rule families. Each rule object exposes:

- ``name``: the family prefix its rule ids live under;
- ``check_module(module, ctx)``: per-file findings generator;
- optionally ``check_project(modules, ctx)``: cross-file findings.

``ALL_RULES`` is the registry the engine and CLI run by default, in the
JAX package's order and with its rule ids; adding a family means
appending an instance here.
"""

from .faults import FaultRules
from .knobs import KnobRules
from .locks import LockRules
from .metrics import MetricsRules
from .purity import PurityRules
from .readers import ReaderRules

ALL_RULES = (
    KnobRules(),
    LockRules(),
    PurityRules(),
    ReaderRules(),
    MetricsRules(),
    FaultRules(),
)


def rule_ids():
    """Every concrete rule id, for --rule validation and docs."""
    out = []
    for rule in ALL_RULES:
        out.extend(rule.ids)
    return tuple(out)


__all__ = ["ALL_RULES", "FaultRules", "KnobRules", "LockRules",
           "MetricsRules", "PurityRules", "ReaderRules", "rule_ids"]
