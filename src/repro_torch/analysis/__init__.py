"""repro_torch.analysis — program analysis over the port's serving
stack (the twin of ``repro.analysis``).

Two halves share this package:

- **Cost analysis** (``hlo``, ``roofline``, ``report``): the dry run's
  counted step (aten ops under ``FakeTensorMode``), its H100 roofline
  terms, and the tables of its records.
- **Serving-invariant analyzer** (``rules``, ``targets``, ``cli``): a
  rule-based checker with two front ends — a walker over the REAL tick
  programs of the serving runners, recorded by running each once
  (``jaxpr_walk``, ``targets``: the port's stand-in for traced jaxprs),
  and an AST linter over ``src/repro_torch`` — plus a runtime load
  audit. ``python -m repro_torch.analysis`` runs it (on the card;
  ``--device cpu`` on the CPU). Rules: no-materialization, precision,
  compat, host-sync, trace-stability (see
  ``repro_torch/serving/__init__.py``, "Invariants", for the contracts
  they pin).

Only torch-light names are re-exported here, so ``import
repro_torch.analysis.hlo`` keeps working without building the analyzer.
"""
from repro_torch.analysis.findings import (ALLOW_RE, Finding,
                                           apply_allowlist, inline_allowed,
                                           is_allowed, parse_allow_entry)
from repro_torch.analysis.jaxpr_walk import (EqnSite, eqn_provenance,
                                             find_eqns, gather_sizes,
                                             iter_eqns, sub_jaxprs)

__all__ = [
    "ALLOW_RE", "Finding", "apply_allowlist", "inline_allowed",
    "is_allowed", "parse_allow_entry",
    "EqnSite", "eqn_provenance", "find_eqns", "gather_sizes",
    "iter_eqns", "sub_jaxprs",
]
