"""Rule ``host-sync``: device->host synchronization in the engine/runner
tick paths must be explicit.

"Nanopore Base Calling on the Edge" (PAPERS.md) motivates keeping the
serving hot loop free of ACCIDENTAL host synchronization: one stray
``.cpu()``/``.item()`` on a device tensor turns an async enqueue into a
per-tick round trip, and the regression is invisible in a diff. The
engine's ticks intentionally sync exactly once (reading the emitted
tokens) — so every sync point in a tick function must carry a
structured ``# sync: <reason>`` annotation on its line (or in the
comment block directly above it). New unannotated syncs fail the gate;
the annotation is the reviewable record of why the round trip is
intentional.

Scope (the reference's): the per-tick hot path in
``serving/engine.py`` and ``serving/runner.py`` — ``step``/``_step_*``/
``_run_works`` plus the pipelined split (``dispatch``/``_dispatch_*``,
``collect``/``_collect_*``, ``_harvest*``). The async engine's dispatch
half performs ZERO syncs (the one token readback lives in ``collect``,
a tick behind), so an unannotated sync creeping into a dispatch
function silently re-serializes the pipeline. Model code lies outside
the scope, as the reference's does (there it is traced).

Sync calls detected — the reference's (``np.asarray``/
``numpy.asarray``, ``.item()``, ``device_get``,
``.block_until_ready()``) and PyTorch's: ``.cpu()``, ``.numpy()``,
``.tolist()``, ``torch.cuda.synchronize``/``.synchronize()``, and the
port's one-sync helper ``readback(...)`` (``serving/runner.py``).
Suppress a false positive (a call on a host value) with
``# repro-allow: host-sync``.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional

from repro_torch.analysis.findings import Finding, inline_allowed
from repro_torch.analysis.rules import rule

TICK_FILES = ("serving/engine.py", "serving/runner.py")
TICK_FUNC_RE = re.compile(
    r"^(step|_step_\w+|_run_works"
    r"|dispatch|_dispatch_\w+|collect|_collect_\w+|_harvest\w*)$")
SYNC_MARKER_RE = re.compile(r"#\s*sync:\s*\S")
# argument-free methods that read a device tensor back to the host
_SYNC_METHODS = ("item", "cpu", "numpy", "tolist", "synchronize")


def _sync_call(node: ast.Call) -> Optional[str]:
    """A human-readable name when ``node`` is a device-sync call."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if (fn.attr == "asarray" and isinstance(fn.value, ast.Name)
                and fn.value.id in ("np", "numpy")):
            return f"{fn.value.id}.asarray"
        if fn.attr in _SYNC_METHODS and not node.args:
            return f".{fn.attr}()"
        if fn.attr == "block_until_ready":
            return ".block_until_ready()"
        if fn.attr == "device_get":
            return "jax.device_get"
        if fn.attr == "readback":
            return "readback"
    elif isinstance(fn, ast.Name) and fn.id in ("device_get", "readback"):
        return fn.id
    return None


def _is_tick_file(relpath: str) -> bool:
    p = relpath.replace("\\", "/")
    return any(p.endswith(t) for t in TICK_FILES)


def _marker_near(lines: List[str], node: ast.AST) -> bool:
    """Marker on the statement's own lines, or anywhere in the
    contiguous comment block directly above it."""
    end = getattr(node, "end_lineno", node.lineno) or node.lineno
    for ln in range(node.lineno, end + 1):
        if 1 <= ln <= len(lines) and SYNC_MARKER_RE.search(lines[ln - 1]):
            return True
    ln = node.lineno - 1
    while 1 <= ln <= len(lines) and lines[ln - 1].lstrip().startswith("#"):
        if SYNC_MARKER_RE.search(lines[ln - 1]):
            return True
        ln -= 1
    return False


def check_source(relpath: str, source: str,
                 tree: Optional[ast.AST] = None) -> List[Finding]:
    """Scan one tick-path file (public so tests can seed snippets)."""
    if not _is_tick_file(relpath):
        return []
    if tree is None:
        tree = ast.parse(source, filename=relpath)
    lines = source.splitlines()
    findings: List[Finding] = []

    def visit(node: ast.AST, in_tick: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            in_tick = in_tick or bool(TICK_FUNC_RE.match(node.name))
        elif in_tick and isinstance(node, ast.Call):
            what = _sync_call(node)
            if (what is not None and not _marker_near(lines, node)
                    and not inline_allowed(lines, node.lineno,
                                           "host-sync")):
                findings.append(Finding(
                    "host-sync", f"{relpath}:{node.lineno}",
                    f"{what} in a tick path without a '# sync: <reason>' "
                    f"annotation — device->host syncs in the serving hot "
                    f"loop must be explicit and justified"))
        for child in ast.iter_child_nodes(node):
            visit(child, in_tick)

    visit(tree, False)
    return findings


@rule("host-sync", "ast",
      "np.asarray/.item()/.cpu()/.numpy()/.tolist()/synchronize/readback "
      "inside engine/runner tick paths carry an explicit "
      "'# sync: <reason>' marker")
def check(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for relpath, source, tree in ctx.ast_files():
        findings.extend(check_source(relpath, source, tree))
    return findings
