"""Rule ``compat``: version-dependent PyTorch APIs only via
``repro_torch.compat``.

The reference's mechanism, over the port's torch surfaces: the port
pins ``torch>=2.4`` (``requirements-torch.txt``), and a few of the
names it uses moved between releases or live in a private module —

- the DTensor API (``torch.distributed.tensor``: ``DTensor``,
  ``Replicate``, ``Shard``, ``distribute_tensor``), public there only in
  newer releases, ``torch.distributed._tensor`` before;
- ``torch._subclasses.fake_tensor`` (``FakeTensorMode``, ``is_fake``),
  private.

They route through the shims in ``src/repro_torch/compat.py``. A raw
reference anywhere else in ``src/repro_torch`` breaks the day the
installed torch moves them; this rule makes it a static error instead
of a version-matrix surprise.

Flags, in every file except ``compat.py`` itself:

- an attribute chain rooted at ``torch`` that names a gated module
  (``torch.distributed.tensor.Shard``) or ends in a gated name;
- ``from torch[...] import <gated name>``, and any import from (or of)
  a gated module;
- ``getattr(torch..., "<gated name>")`` probing (that litter is exactly
  what the shim module exists to contain).

Importing the same names from ``repro_torch.compat`` is of course fine
— those are ``repro_torch``-rooted and don't match. Suppress a
deliberate use with ``# repro-allow: compat``.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.findings import Finding, inline_allowed
from repro_torch.analysis.rules import rule

GATED_MODULES = ("torch.distributed.tensor", "torch.distributed._tensor",
                 "torch._subclasses.fake_tensor")
GATED_APIS = ("DTensor", "Replicate", "Shard", "distribute_tensor",
              "FakeTensorMode", "is_fake")
_EXEMPT_BASENAME = "compat.py"


def _attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name of an attribute chain on a ``Name``
    (``torch.distributed.tensor.Shard``), else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    return ".".join([node.id] + parts[::-1])


def _gated_module(dotted: str) -> bool:
    return any(dotted == m or dotted.startswith(m + ".")
               for m in GATED_MODULES)


def check_source(relpath: str, source: str,
                 tree: Optional[ast.AST] = None) -> List[Finding]:
    """Scan one file's source (public so tests can seed snippets)."""
    if relpath.replace("\\", "/").split("/")[-1] == _EXEMPT_BASENAME:
        return []
    if tree is None:
        tree = ast.parse(source, filename=relpath)
    lines = source.splitlines()
    findings: List[Finding] = []

    def flag(node: ast.AST, api: str, how: str) -> None:
        if inline_allowed(lines, node.lineno, "compat"):
            return
        findings.append(Finding(
            "compat", f"{relpath}:{node.lineno}",
            f"version-dependent torch API {api!r} {how} outside "
            f"repro_torch/compat.py — route it through repro_torch.compat "
            f"so the torch>=2.4 pin keeps holding"))

    # the outermost chain of each expression only (``a.b.c`` holds
    # ``a.b`` as its value: one finding, not one per prefix)
    inner = {id(n.value) for n in ast.walk(tree)
             if isinstance(n, ast.Attribute)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and id(node) not in inner:
            dotted = _attr_chain(node)
            if dotted and dotted.split(".")[0] == "torch" and (
                    _gated_module(dotted)
                    or dotted.split(".")[-1] in GATED_APIS):
                flag(node, dotted, "referenced")
        elif (isinstance(node, ast.ImportFrom) and node.module
                and node.module.split(".")[0] == "torch"):
            for alias in node.names:
                full = f"{node.module}.{alias.name}"
                if (_gated_module(node.module) or _gated_module(full)
                        or alias.name in GATED_APIS):
                    flag(node, full, "imported")
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if _gated_module(alias.name):
                    flag(node, alias.name, "imported")
        elif (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "getattr" and len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)
                and node.args[1].value in GATED_APIS
                and (_attr_chain(node.args[0]) or "").split(".")[0]
                == "torch"):
            flag(node, str(node.args[1].value), "probed via getattr")
    return findings


@rule("compat", "ast",
      "version-dependent torch APIs (torch.distributed.tensor's DTensor, "
      "Replicate, Shard, distribute_tensor; torch._subclasses.fake_tensor"
      "'s FakeTensorMode, is_fake) are referenced only inside "
      "repro_torch/compat.py")
def check(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for relpath, source, tree in ctx.ast_files():
        findings.extend(check_source(relpath, source, tree))
    return findings
