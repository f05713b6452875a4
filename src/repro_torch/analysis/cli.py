"""``python -m repro_torch.analysis`` — run the serving-invariant rules
over the port.

Exit status 0 when every rule passes (after allowlist suppression),
1 when any finding survives, 2 on usage errors. See
``repro_torch/serving/__init__.py`` ("Invariants") for what each rule
guards. The trace and runtime rules record the port's tick programs on
the card; ``--device cpu`` records them on the CPU (the kernels' plain
versions), and without a card and without it such a run raises. The AST
rules (``compat``, ``host-sync``) need no device.

Usage:
    python -m repro_torch.analysis                    # all rules, card
    python -m repro_torch.analysis --device cpu       # all rules, CPU
    python -m repro_torch.analysis --rules compat,host-sync
    python -m repro_torch.analysis --list-rules
    python -m repro_torch.analysis --json             # machine-readable
    python -m repro_torch.analysis --allow 'precision:qmatmul*'
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from typing import List, Optional, Sequence

from repro_torch.analysis.allowlist import DEFAULT_ALLOWLIST
from repro_torch.analysis.context import AnalysisContext
from repro_torch.analysis.findings import Finding, apply_allowlist
from repro_torch.analysis.rules import all_rules
from repro_torch.device import resolve_device


def run_rules(ctx: AnalysisContext,
              names: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the (selected) registered rules; a rule that crashes is
    itself a finding — the gate must not silently skip checks."""
    findings: List[Finding] = []
    for r in all_rules(names):
        try:
            findings.extend(r.check(ctx))
        except Exception:
            tb = traceback.format_exc().strip().splitlines()[-1]
            findings.append(Finding(
                r.id, f"rule:{r.id}",
                f"rule crashed instead of checking: {tb}"))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static + trace analysis of the serving invariants")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the registry and exit")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit findings as JSON")
    p.add_argument("--root", default=None,
                   help="source root to lint (default: src/repro_torch)")
    p.add_argument("--allow", action="append", default=[],
                   metavar="RULE[:GLOB]",
                   help="extra allowlist entry (repeatable)")
    p.add_argument("--no-default-allowlist", action="store_true",
                   help="ignore DEFAULT_ALLOWLIST")
    p.add_argument("--device", default=None,
                   help="where the tick programs are recorded (default: "
                        "cuda; 'cpu' runs the kernels' plain versions)")
    args = p.parse_args(argv)

    if args.list_rules:
        for r in all_rules():
            print(f"{r.id:20s} [{r.kind:7s}] {r.doc}")
        return 0

    names = ([n.strip() for n in args.rules.split(",") if n.strip()]
             if args.rules else None)
    try:
        rules = all_rules(names)
    except ValueError as e:                       # unknown rule name
        print(f"error: {e}", file=sys.stderr)
        return 2
    if any(r.kind != "ast" for r in rules):
        # the programs run on the card unless asked for the CPU: raise
        # here, before any rule could report the refusal as a finding
        resolve_device(args.device)
    ctx = (AnalysisContext(src_root=args.root, rel_prefix="",
                           device=args.device)
           if args.root else AnalysisContext(device=args.device))
    findings = run_rules(ctx, names)

    allowlist = (list(() if args.no_default_allowlist
                      else DEFAULT_ALLOWLIST) + args.allow)
    kept, suppressed = apply_allowlist(findings, allowlist)

    if args.as_json:
        print(json.dumps({
            "findings": [vars(f) for f in kept],
            "suppressed": [vars(f) for f in suppressed]}, indent=2))
    else:
        for f in kept:
            print(f)
        tail = f" ({len(suppressed)} suppressed)" if suppressed else ""
        if kept:
            print(f"repro_torch.analysis: {len(kept)} finding(s){tail}")
        else:
            print(f"repro_torch.analysis: clean{tail}")
    return 1 if kept else 0
