"""Findings + allowlist/suppression machinery for ``repro_torch.analysis``
(the port's copy of ``repro.analysis.findings``).

A :class:`Finding` is one invariant violation with provenance:

- AST rules report ``where`` as ``path/to/file.py:LINE``.
- trace rules report ``where`` as ``<target>::<op path>`` — the recorded
  program's name (e.g. ``step[qwen1.5-4b-smoke/cuda/mixed]``) plus the
  enclosing plain-version path of the offending op — with the op's
  ``file:line`` appended to the message.

Suppression comes in two layers, both per rule:

1. **Inline** (AST rules): a ``# repro-allow: <rule-id>[, <rule-id>]``
   comment on the flagged line or the line directly above it (the same
   marker as the reference's, so one comment serves either package).
2. **Allowlist** (any rule): entries of the form ``"<rule-id>:<glob>"``
   where the glob matches ``Finding.where`` (``fnmatch``; a bare
   ``"<rule-id>"`` suppresses the rule everywhere). The repo-wide
   default list lives in
   ``repro_torch.analysis.allowlist.DEFAULT_ALLOWLIST``; the CLI adds
   entries via ``--allow``.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import re
from typing import Iterable, List, Sequence, Tuple

ALLOW_RE = re.compile(r"#\s*repro-allow:\s*([\w\-, ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation: which rule, where, and what happened."""
    rule: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"{self.where}: [{self.rule}] {self.message}"


def parse_allow_entry(entry: str) -> Tuple[str, str]:
    """``"rule:glob"`` -> ``(rule, glob)``; a bare rule means ``*``."""
    rule, _, pat = entry.partition(":")
    return rule.strip(), (pat.strip() or "*")


def is_allowed(finding: Finding, allowlist: Sequence[str]) -> bool:
    for entry in allowlist:
        rule, pat = parse_allow_entry(entry)
        if rule in (finding.rule, "*") and fnmatch.fnmatch(finding.where, pat):
            return True
    return False


def apply_allowlist(findings: Iterable[Finding],
                    allowlist: Sequence[str]
                    ) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into ``(kept, suppressed)`` under the allowlist."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for f in findings:
        (suppressed if is_allowed(f, allowlist) else kept).append(f)
    return kept, suppressed


def inline_allowed(source_lines: Sequence[str], lineno: int,
                   rule: str) -> bool:
    """Is ``rule`` suppressed by a ``# repro-allow:`` comment on line
    ``lineno`` (1-based) or the line directly above it?"""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(source_lines):
            m = ALLOW_RE.search(source_lines[ln - 1])
            if m and rule in [r.strip() for r in m.group(1).split(",")]:
                return True
    return False
