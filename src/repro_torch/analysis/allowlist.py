"""Repo-wide default allowlist for the port's serving-invariant analyzer.

Entries are ``"<rule-id>:<glob>"`` where the glob matches
``Finding.where`` (``<file>:<line>`` for AST rules,
``<target>::<op path>`` for trace rules); a bare ``"<rule-id>"``
suppresses the rule everywhere (don't). Prefer an inline
``# repro-allow: <rule-id>`` comment for one-off AST suppressions —
this list is for invariant-shaped exceptions that outlive single
lines, and every entry says why on the line above it.

Empty: the port's tree passes every rule with no exceptions. The CLI
adds ad-hoc entries via ``--allow``.
"""
from __future__ import annotations

from typing import Tuple

DEFAULT_ALLOWLIST: Tuple[str, ...] = ()
