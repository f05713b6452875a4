"""Counts behind the dry run's roofline (the port's counterpart of
``repro.analysis.hlo``).

The reference parses the compiled SPMD program's HLO, whose shapes are
per partition, and scales each loop body by its trip count. The port
has no compiled SPMD program to parse. It runs the cell's step (train
step, prefill or decode) once under ``FakeTensorMode`` on the CPU
device, where every kernel wrapper takes its plain version and no
storage is allocated, and counts each aten op:

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of
  the matmuls and convolutions (``dot_flops`` / ``conv_flops``;
  elementwise work is left out, as the reference leaves it out);
- ``hbm_bytes``: each op's tensor operands plus its result. Views move
  nothing and count nothing; an indexed read (``index``, ``gather``,
  ``embedding``, ``index_select``) counts the rows it reads, not its
  whole source, and an indexed write (``index_put_``, ``scatter``)
  the rows it writes, not its whole destination. The plain versions
  stand in for the kernels: the attention prefill's plain version
  materialises its scores, which the flash kernel keeps on chip, so
  the prefill and train cells' byte counts are above what the card's
  kernels move;
- ``collective_bytes``: the traffic the placements imply for one step
  (:func:`collective_bytes`), not a count of collectives in a program.

The reference's numbers are per partition, from the compiler. The
port's are the global step's counts split evenly over the chips
(:func:`per_device`), plus the counted collectives, which are per
device already.
"""
from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# indexed reads and writes: the first operand is the source / destination
# of which only the indexed rows move
_INDEXED_READS = ("index", "gather", "index_select", "embedding",
                  "take_along_dim")
_INDEXED_WRITES = ("index_put", "index_put_", "_index_put_impl_",
                   "scatter", "scatter_", "scatter_add", "scatter_add_",
                   "index_copy", "index_copy_", "index_add", "index_add_")
# allocations that write nothing
_NO_TRAFFIC = ("empty", "empty_strided", "empty_like", "lift_fresh",
               "_local_scalar_dense")
_CONV_OPS = ("convolution", "_convolution", "convolution_backward")


def _nbytes(t) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """Every result aliases an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class _ByteCounter(TorchDispatchMode):
    """Per aten op: calls and the bytes its operands and result move."""

    def __init__(self):
        super().__init__()
        self.calls: Dict[str, int] = defaultdict(int)
        self.bytes: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func.namespace != "aten" or _is_view(func) or name in _NO_TRAFFIC:
            return out          # prim.device and the like read no tensor
        ins = tree_flatten((args, kwargs))[0]
        outs = tree_flatten(out)[0]
        if name in _INDEXED_READS:
            moved = 2 * sum(map(_nbytes, outs)) + sum(map(_nbytes, ins[1:]))
        elif name in _INDEXED_WRITES:
            # the written values twice (read and stored) and the indices
            moved = 2 * sum(map(_nbytes, ins[2:])) + _nbytes(ins[1])
        else:
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.calls[name] += 1
        self.bytes[name] += moved
        return out


def count_ops(fn: Callable, *args, **kwargs):
    """Run ``fn`` (on fake tensors) under the counters. Returns (its
    result, the per-op table ``{op: {"calls", "bytes", "flops"}}``)."""
    fc = FlopCounterMode(display=False)
    bc = _ByteCounter()
    with fc, bc:
        out = fn(*args, **kwargs)
    table = {name: {"calls": bc.calls[name], "bytes": bc.bytes[name],
                    "flops": 0} for name in bc.calls}
    for op, flops in fc.get_flop_counts().get("Global", {}).items():
        name = getattr(op, "__name__", str(op))
        table.setdefault(name, {"calls": 0, "bytes": 0, "flops": 0})
        table[name]["flops"] += int(flops)
    return out, table


def scale_table(table: Dict, k: float) -> Dict:
    return {n: {key: v * k for key, v in row.items()}
            for n, row in table.items()}


def merge_tables(*tables: Dict) -> Dict:
    out: Dict = {}
    for t in tables:
        for n, row in t.items():
            acc = out.setdefault(n, {"calls": 0, "bytes": 0, "flops": 0})
            for key, v in row.items():
                acc[key] += v
    return out


def totals(table: Dict) -> Dict[str, float]:
    """Whole-step ``dot_flops``, ``conv_flops``, ``flops`` and
    ``hbm_bytes`` of a per-op table."""
    conv = sum(r["flops"] for n, r in table.items() if n in _CONV_OPS)
    flops = sum(r["flops"] for r in table.values())
    return {"dot_flops": float(flops - conv), "conv_flops": float(conv),
            "flops": float(flops),
            "hbm_bytes": float(sum(r["bytes"] for r in table.values()))}


# ---------------------------------------------------------------------------
# Collectives from the placements (the FSDP pattern of
# repro_torch.parallel.sharding)

# leaves whose 'model'-sharded input makes each use end in an all-reduce
# of its output (the vocab-sharded embedding lookup, the row-parallel
# output projections); an expert stack's (the MoE combine) ends in an
# all-to-all instead
_ROW_PARALLEL = re.compile(r"(^embed|(wo|out_proj)/kernel|ffn/wo)(/0)?$")
_DP_AXES = ("pod", "data")


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def moe_slots(n_experts: int, experts_per_tok: int, groups: int,
              group_len: int, dp: int, capacity_factor: float = 1.25
              ) -> float:
    """One MoE layer's dispatch slots on one data shard: ``n_experts x
    groups x capacity / dp``, the rows of the (E, G, capacity, d)
    dispatch tensor (``moe.moe_ffn``'s capacity rule: ``max(ceil(
    group_len x k / E x capacity_factor), 4)``)."""
    cap = max(int(math.ceil(group_len * experts_per_tok / n_experts
                            * capacity_factor)), 4)
    return n_experts * groups * cap / dp


def collective_bytes(leaves, sizes: Dict[str, int], *, n_micro: int,
                     train: bool, tokens: int, frames: int,
                     act_bytes: int, moe_slots: float = 0.0
                     ) -> Dict[str, float]:
    """Per-device bytes of one step's collectives under the FSDP pattern:
    ``leaves`` are ``(path, shape, itemsize, spec)`` of every parameter
    (the spec filtered to the mesh of axis ``sizes``).

    - all-gather: a weight sharded over 'data'/'pod' is gathered (to its
      'model' shard) for each microbatch's forward, and again in the
      backward when training; counted as the gathered result's bytes;
    - reduce-scatter (training): its gradient, the pre-scatter bytes,
      each microbatch; a weight replicated over the data axes has its
      accumulated gradient all-reduced once a step instead;
    - all-reduce: the output (tokens x width, in the activation dtype)
      of each use of a 'model'-sharded embedding, row-parallel
      projection or MoE combine, per forward and again in the backward;
      ``tokens`` is one microbatch's tokens on one data shard
      (``frames`` for the audio encoder's leaves);
    - all-to-all: where an expert stack (``ffn/wo``) shards its expert
      dim on 'model', each MoE layer's dispatch sends the (E, G,
      capacity, d) dispatch tensor to the experts' shards and its
      combine sends the experts' outputs back, one all-to-all each per
      pass, each the device's ``moe_slots / model`` rows of ``d``
      (:func:`moe_slots`). The combine is carried by this all-to-all,
      not by an all-reduce of the layer's output;
    - collective-permute: none (the port has no pipeline or ring); a
      key because the reference's record has one.

    A collective over one device moves nothing."""
    dp_world = math.prod(sizes.get(a, 1) for a in _DP_AXES)
    passes = n_micro * (2 if train else 1)
    out = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
    for path, shape, itemsize, spec in leaves:
        axes = [a for e in spec for a in _axes(e)]
        dp = math.prod(sizes[a] for a in axes if a in _DP_AXES)
        mp = math.prod(sizes[a] for a in axes if a == "model")
        gathered = math.prod(shape) * itemsize / mp
        if dp > 1:
            out["all-gather"] += passes * gathered
            if train:
                out["reduce-scatter"] += n_micro * gathered
        elif train and dp_world > 1:
            out["all-reduce"] += gathered
        if mp > 1 and _ROW_PARALLEL.search(path):
            # layers stacked before (din, dout), or before (E, ff, d)
            if path.endswith(("ffn/wo", "ffn/wo/0")):
                uses = math.prod(shape[:-3])
                out["all-to-all"] += passes * uses * 2 * moe_slots / mp \
                    * shape[-1] * act_bytes
                continue
            uses = math.prod(shape[:-2])
            n_tok = frames if path.startswith("encoder/") else tokens
            out["all-reduce"] += passes * uses * n_tok * shape[-1] \
                * act_bytes
    return out


def per_device(totals_: Dict[str, float], n_chips: int,
               coll: Dict[str, float]) -> Dict[str, float]:
    """The record's ``hlo`` field: the step's totals split evenly over
    ``n_chips`` plus the per-device collectives."""
    rec = {k: v / n_chips for k, v in totals_.items()}
    rec["collective_bytes"] = float(sum(coll.values()))
    rec.update({f"coll_{k}": float(v) for k, v in sorted(coll.items())})
    return rec
