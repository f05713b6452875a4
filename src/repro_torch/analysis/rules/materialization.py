"""Rule ``no-materialization``: the fused decode path never gathers a
``(B, T*block_len)``-or-larger logical KV view out of the block arena.

This is THE property the paged-attention kernels exist for: the gather
reference copies ``B * T * block_len`` positions of K and V per layer
per tick; the ``cuda`` path reads the arena in place, one block at a
time, and the logical view never exists. The rule walks the real runner
tick programs (both tick shapes, every cache family, int8 arenas
included) and the ``ops.decode_*`` dispatch, as recorded
(:mod:`repro_torch.analysis.targets`):

- backend ``cuda``: any gather (``index``, ``index_select``,
  ``gather``, ``take``, ``embedding``) whose operand is ARENA-SHAPED —
  its leading dims match a pool group's ``(n_blocks, block_len)``
  signature, as the op sees it — and whose output is at least the
  logical-view size is a violation. So is a reshape (``view``,
  ``_unsafe_view``, ``reshape``) flattening an arena operand into a
  view-sized result, and a view-sized copy of one (``clone``,
  ``_to_copy``, ``contiguous``): on the card the recorded ops are the
  glue around the kernel launches, where an arena copied to meet a
  kernel's layout would be exactly such a copy. On the CPU the plain
  versions are recorded; they walk the arena one table column at a
  time, as the kernels do, so a view-sized gather there means the plain
  version and its kernel part ways. Matching on the operand's arena
  signature (not raw output size) is what keeps embedding-table lookups
  and logits slicing out of the blast radius.
- backend ``gather``: the reference MUST contain such a gather — it is
  exactly the copy being eliminated. Its absence means the recorded
  program is no longer the oracle the parity gates compare against
  (oracle drift), which is reported too.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.jaxpr_walk import (GATHER_OPS, eqn_provenance,
                                             iter_eqns)
from repro_torch.analysis.rules import rule
from repro_torch.analysis.targets import TraceTarget

_RESHAPE_OPS = ("view", "_unsafe_view", "reshape")
_COPY_OPS = ("clone", "_to_copy", "contiguous")


def check_target(tgt: TraceTarget) -> List[Finding]:
    """Apply the rule to one recorded target (public so tests can seed
    deliberately-broken programs)."""
    if not tgt.arena_sigs or tgt.backend not in ("gather", "cuda"):
        return []
    hits = []
    for site in iter_eqns(tgt.jaxpr):
        op = site.eqn
        if op.name not in GATHER_OPS + _RESHAPE_OPS + _COPY_OPS \
                or not op.in_shapes:
            continue
        floor = tgt.view_floor(op.in_shapes[0])
        if floor is None:
            continue
        for i, shape in enumerate(op.out_shapes):
            if op.name in _RESHAPE_OPS and shape == op.in_shapes[0]:
                continue            # a dtype view: nothing flattened
            if op.out_numel(i) >= floor:
                hits.append((site, shape, op.out_numel(i), floor))
    findings: List[Finding] = []
    if tgt.backend == "cuda":
        for site, shape, size, floor in hits:
            src = eqn_provenance(site.eqn)
            findings.append(Finding(
                "no-materialization", f"{tgt.name}::{site.path_str}",
                f"fused path materializes a logical KV view: "
                f"{site.eqn.name} of an arena operand produces "
                f"{tuple(shape)} ({size} elems >= view floor "
                f"{floor})" + (f" at {src}" if src else "")))
    elif not any(site.eqn.name in GATHER_OPS for site, *_ in hits):
        findings.append(Finding(
            "no-materialization", f"{tgt.name}::oracle",
            "reference (gather) program contains NO logical-view arena "
            "gather — the parity oracle no longer measures the copy the "
            "fused path eliminates (oracle drift)"))
    return findings


@rule("no-materialization", "jaxpr",
      "no gather/reshape/copy materializes a (B, T*block_len)+ logical KV "
      "view inside fused paged decode/chunk programs (the gather "
      "reference must keep it: oracle)")
def check(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for tgt in ctx.jaxpr_targets:
        findings.extend(check_target(tgt))
    return findings
