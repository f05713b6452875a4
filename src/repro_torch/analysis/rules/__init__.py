"""Rule registry for the port's serving-invariant analyzer.

A rule is a named check over one of three surfaces (the kinds keep the
reference's names):

``jaxpr``    recorded tick programs (``repro_torch.analysis.targets``):
             the aten ops and kernel launches of one real run, the
             port's stand-in for a traced jaxpr
``ast``      the ``src/repro_torch`` source tree
``runtime``  checks that must actually run programs (load audits)

Register with the :func:`rule` decorator; ``all_rules()`` imports the
built-in rule modules and returns the registry. Adding a rule is:
write ``check(ctx) -> List[Finding]`` in a module under
``repro_torch/analysis/rules/``, decorate it, add the module name to
``_BUILTIN``. Suppression (inline ``# repro-allow:`` comments and the
``DEFAULT_ALLOWLIST``) is handled by the driver, not by rules.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List, Optional, Sequence

_BUILTIN = ("materialization", "precision", "compat_gate", "host_sync",
            "trace_stability")

RULES: Dict[str, "Rule"] = {}


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    kind: str          # "jaxpr" | "ast" | "runtime"
    doc: str
    check: Callable    # (AnalysisContext) -> List[Finding]


def rule(id: str, kind: str, doc: str):
    """Decorator: register ``check(ctx)`` under ``id``."""
    def wrap(fn):
        if id in RULES:
            raise ValueError(f"duplicate rule id {id!r}")
        RULES[id] = Rule(id=id, kind=kind, doc=doc, check=fn)
        return fn
    return wrap


def all_rules(names: Optional[Sequence[str]] = None) -> List[Rule]:
    """The registry (built-ins imported on first use), optionally
    filtered to ``names`` (unknown names raise)."""
    for mod in _BUILTIN:
        importlib.import_module(f"{__name__}.{mod}")
    if names is None:
        return [RULES[k] for k in sorted(RULES)]
    unknown = [n for n in names if n not in RULES]
    if unknown:
        raise ValueError(
            f"unknown rules {unknown}; available: {sorted(RULES)}")
    return [RULES[n] for n in names]
