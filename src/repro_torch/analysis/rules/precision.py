"""Rule ``precision``: fp32 softmax statistics and accumulators in the
attention / quantized-matmul programs.

The quantized serving stack keeps one numerical contract: KV bytes may
be bf16/fp8/int8, but softmax statistics (max/sum/exp) and matmul
ACCUMULATION are always fp32 — fp32 accumulators in the kernels, fp32
scale math, and in the plain versions an fp32 product of inputs
rounded to the compute dtype. Helix (PAPERS.md) is the cautionary
tale: quantized basecalling paths silently lose accuracy when exactly
these spots drift to low precision. The rule walks the recorded
attention-op and serving-step programs and flags, in aten terms:

- ``exp`` over a non-fp32 float (softmax stats computed in bf16/f16);
- float ``amax``/``max``/``sum`` reductions over non-fp32 operands
  (online-softmax running stats must be fp32), and ``_softmax``/
  ``_log_softmax``/``logsumexp`` over a half-precision input, which
  compute those statistics inside;
- a matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``_scaled_mm``, and
  the ``mv``/``dot`` family) with a low-precision input (int8/fp8/bf16/
  f16) whose output is not fp32 (or int32 for an integer product).
  PyTorch has no ``preferred_element_type``: a bf16 ``mm`` IS a bf16
  accumulator's output, so a low-precision product must be widened to
  fp32 before the matmul;
- on QUANTIZED attention-op and qmatmul programs: an fp32 -> bf16/f16
  ``_to_copy`` whose value then REACHES softmax stats or a non-fp32
  matmul (followed through layout and elementwise ops) — the "silent
  downcast" that launders fp32 math back through half precision. The
  dataflow qualifier is what exempts the deliberate casts of the
  quantization contract: ``dequantize_kv``'s fp32-multiply-then-cast-
  to-compute-dtype and the probabilities rounded to the compute dtype
  are clean, because every consumer widens back and accumulates in
  fp32.

At smoke scale the serving programs run in fp32 (``ModelConfig.smoke``
sets ``dtype="float32"``), as the reference's gate runs them: at full
width the bf16 projections of either package are bf16 matmuls by
design.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.jaxpr_walk import EqnSite, Op, eqn_provenance
from repro_torch.analysis.rules import rule
from repro_torch.analysis.targets import TraceTarget

_F32 = (torch.float32, torch.float64)
_HALF = (torch.bfloat16, torch.float16)

_EXP = ("exp", "exp_")
_REDUCE = ("amax", "max", "sum")
_SOFTMAX = ("_softmax", "_log_softmax", "logsumexp")
_MATMUL = ("mm", "bmm", "addmm", "baddbmm", "_scaled_mm", "mv", "dot",
           "addmv", "addbmm")

# ops a downcast value may pass through without changing the verdict:
# pure layout ops plus elementwise arithmetic (bf16 QK/PV INPUTS are
# the alignment contract — only stats/accumulation must be fp32)
_PASSTHROUGH = frozenset((
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "slice", "select", "flip", "alias",
    "clone", "contiguous", "_to_copy", "detach",
    "mul", "add", "sub", "div", "neg", "maximum", "minimum", "where",
    "clamp", "clamp_min", "clamp_max",
    "mul_", "add_", "sub_", "div_", "neg_", "clamp_", "clamp_min_",
    "clamp_max_",
))


def _is_low_precision(dt: torch.dtype) -> bool:
    return dt in _HALF or dt == torch.int8 or "float8" in str(dt)


def _finding(tgt, site, msg) -> Finding:
    src = eqn_provenance(site.eqn)
    return Finding("precision", f"{tgt.name}::{site.path_str}",
                   msg + (f" at {src}" if src else ""))


def _is_reduction(op: Op) -> bool:
    """``max`` also names the elementwise two-tensor form."""
    return op.name in _REDUCE and len(op.in_shapes) == 1


def _bad_stat_sink(op: Op) -> bool:
    """Is this op a place where half precision breaks the contract —
    stats math or a low-precision accumulator?"""
    if op.name in _EXP or _is_reduction(op):
        dt = op.in_dtypes[0]
        return dt.is_floating_point and dt not in _F32
    if op.name in _SOFTMAX:
        return op.in_dtypes[0] in _HALF
    if op.name in _MATMUL:
        out_dt = op.out_dtypes[0]
        return out_dt not in _F32 and out_dt != torch.int32
    return False


def _launders(op: Op, consumers: Dict[int, List[Op]]) -> bool:
    """Does the downcast value reach a bad stat sink, following layout
    and elementwise ops? Other consumers end the walk (their own direct
    checks cover them)."""
    seen = set()
    stack = list(op.out_ids)
    while stack:
        v = stack.pop()
        for c in consumers.get(v, ()):
            if _bad_stat_sink(c):
                return True
            if c.name in _PASSTHROUGH:
                for ov in c.out_ids:
                    if ov not in seen:
                        seen.add(ov)
                        stack.append(ov)
    return False


def check_target(tgt: TraceTarget) -> List[Finding]:
    """Apply the rule to one recorded target (public for seeded
    tests)."""
    findings: List[Finding] = []
    ops = tgt.jaxpr.ops
    consumers: Dict[int, List[Op]] = {}
    for op in ops:
        for v in op.in_ids:
            consumers.setdefault(v, []).append(op)
    launder = tgt.quantized and tgt.kind in ("attn-op", "qmatmul")
    for op in ops:
        site = EqnSite(op, op.path)
        if op.name in _EXP:
            dt = op.in_dtypes[0]
            if dt.is_floating_point and dt not in _F32:
                findings.append(_finding(
                    tgt, site, f"softmax stats must be fp32: exp over "
                    f"{str(dt)[6:]}"))
        elif _is_reduction(op):
            dt = op.in_dtypes[0]
            if dt.is_floating_point and dt not in _F32:
                findings.append(_finding(
                    tgt, site, f"softmax/scale reduction must accumulate "
                    f"in fp32: {op.name} over {str(dt)[6:]}"))
        elif op.name in _SOFTMAX:
            if op.in_dtypes[0] in _HALF:
                findings.append(_finding(
                    tgt, site, f"softmax stats must be fp32: {op.name} "
                    f"over {str(op.in_dtypes[0])[6:]}"))
        elif op.name in _MATMUL:
            out_dt = op.out_dtypes[0]
            if (any(_is_low_precision(dt) for dt in op.in_dtypes)
                    and out_dt not in _F32 and out_dt != torch.int32):
                findings.append(_finding(
                    tgt, site, f"low-precision accumulator: {op.name}("
                    f"{', '.join(str(d)[6:] for d in op.in_dtypes)}) -> "
                    f"{str(out_dt)[6:]}; widen the inputs and accumulate "
                    f"in fp32"))
        elif op.name == "_to_copy" and launder and op.in_dtypes:
            src_dt, dst_dt = op.in_dtypes[0], op.out_dtypes[0]
            if src_dt in _F32 and dst_dt in _HALF and _launders(
                    op, consumers):
                findings.append(_finding(
                    tgt, site, f"silent fp32->{str(dst_dt)[6:]} downcast "
                    f"on a quantized path reaches softmax stats / a low-"
                    f"precision accumulator"))
    return findings


@rule("precision", "jaxpr",
      "softmax stats, scale math and matmul accumulation in attention/"
      "qmatmul programs stay fp32 (no bf16/int8 accumulators, no silent "
      "fp32->bf16 downcasts on quantized paths)")
def check(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for tgt in ctx.jaxpr_targets:
        findings.extend(check_target(tgt))
    return findings
