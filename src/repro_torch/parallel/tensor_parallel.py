"""Tensor parallelism over the ``model`` axis of a training mesh.

A train step on a ``(data, model)`` mesh with a model axis of M > 1
(``training/train_loop.run``) gives each rank its shard of every leaf
that a unit of the model splits (``sharding.model_split_dim``): the
attention by whole heads (``wq``/``wk``/``wv`` columns and their
biases, ``wo`` rows), the dense MLP by its hidden width (``wi``/``wg``
columns, ``wo`` rows), the vocabulary (``embed`` rows, ``lm_head``
columns) and the expert stacks; a unit that M does not divide stays
whole on every rank. The residual stream is whole on every rank, as
the reference pins it (``src/repro/models/lm/transformer.py:129``), so
a split unit is a Megatron pair: its input passes :func:`copy_to_model`
(identity forward, a sum over the model group backward), its
column-parallel half computes this rank's heads, hidden columns,
vocabulary or experts, and its row-parallel half ends in
:func:`reduce_from_model` (a sum forward, identity backward). These
are the places where the reference's GSPMD program pins activations on
``model`` (``common.constrain``), and the step computes the same
function as the one-process step: only the order of a few fp32 sums
differs.

The model code does its collectives while :func:`over_model` is in
force and a unit is split (the width a rank holds differs from the
config's). Outside it (one process, a model axis of 1, serving) there
is no group, no collective is issued and every function below is the
identity, so one formula serves both cases. Every collective of this
module goes through :func:`all_reduce_` (``dist.all_reduce``, SUM or
MAX only, which gloo also runs on CUDA tensors), which counts calls and
bytes in :data:`COUNTS`. At import this module loads only torch and the
sharding rules.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import tree_map, tree_map_with_path
from repro_torch.parallel.sharding import (Segments, model_coordinate,
                                          model_split_dim)

_GROUP: Optional[dist.ProcessGroup] = None

# every all-reduce issued here: calls and bytes, for the tests and the
# card's phase (reset with :func:`reset_counts`)
COUNTS: Dict[str, int] = {"calls": 0, "bytes": 0}


@contextlib.contextmanager
def over_model(group: Optional[dist.ProcessGroup]):
    """Split units reduce over ``group`` inside (``None``: none)."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = prev


def size() -> int:
    """Ranks in the model group (1 without one)."""
    return 1 if _GROUP is None else dist.get_world_size(_GROUP)


def rank() -> int:
    """This rank's index in the model group (0 without one)."""
    return 0 if _GROUP is None else dist.get_rank(_GROUP)


def reset_counts() -> None:
    COUNTS.update(calls=0, bytes=0)


def all_reduce_(t: torch.Tensor, op: str = "sum",
                group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """``t`` replaced by its sum (``op="sum"``) or maximum (``"max"``)
    over ``group`` (default: the model group in force; none: ``t`` as
    it is). Counted in :data:`COUNTS`."""
    group = _GROUP if group is None else group
    if group is None:
        return t
    COUNTS["calls"] += 1
    COUNTS["bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    return t


def all_max_(t: torch.Tensor) -> torch.Tensor:
    """``t`` replaced by its maximum over the model group (no gradient):
    the amax of a fake-quant scale whose extent the group splits."""
    return all_reduce_(t, "max")


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the group, since every
    rank's shard reads the whole input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), group=ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the group forward; identity backward, since every rank
    holds the whole result and its whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, is_split: bool = True) -> torch.Tensor:
    """The input of a split unit (``x`` itself without a group or where
    the unit is whole)."""
    if _GROUP is None or not is_split:
        return x
    return _CopyToModel.apply(x, _GROUP)


def reduce_from_model(x: torch.Tensor, is_split: bool = True
                      ) -> torch.Tensor:
    """The sum over the model group of a split unit's partial output
    (``x`` itself without a group or where the unit is whole)."""
    if _GROUP is None or not is_split:
        return x
    return _ReduceFromModel.apply(x, _GROUP)


# ---------------------------------------------------------------------------
# Whole leaves and shards


def split_dims(tree, cfg: ModelConfig, model: int):
    """A tree matching a whole parameter tree: how a model axis of
    ``model`` splits each leaf (``sharding.model_split_dim``: a dim, a
    ``Segments``, or None where it stays whole)."""
    return tree_map_with_path(
        lambda path, leaf: model_split_dim(path, tuple(leaf.shape), cfg,
                                           model), tree)


def local_shard(leaf: torch.Tensor, path: str, cfg: ModelConfig,
                mesh) -> torch.Tensor:
    """This rank's shard of a whole leaf at ``path`` on ``mesh`` (the
    leaf itself where its unit stays whole)."""
    index, model = model_coordinate(mesh)
    return shard(leaf, model_split_dim(path, tuple(leaf.shape), cfg, model),
                 index, model)


def _segments(t: torch.Tensor, seg: Segments, lengths):
    """``t``'s consecutive pieces along ``seg.dim``, of ``lengths``."""
    return t.split(list(lengths), seg.dim)


def shard(leaf: torch.Tensor, split, index: int,
          model: int) -> torch.Tensor:
    """Part ``index`` of ``model`` of ``leaf`` under ``split`` (a copy,
    so the whole leaf can be freed; the leaf itself for ``split=None``):
    along a dim, or of each split segment of a ``Segments``, every whole
    segment kept."""
    if split is None:
        return leaf
    if isinstance(split, Segments):
        pieces = _segments(leaf, split, [n for n, _ in split.parts])
        return torch.cat([p.chunk(model, split.dim)[index] if s else p
                          for p, (_, s) in zip(pieces, split.parts)],
                         dim=split.dim)
    return leaf.chunk(model, split)[index].clone()


def shard_tree(tree, dims, index: int, model: int):
    """:func:`shard` over a tree and its :func:`split_dims`."""
    return tree_map(lambda t, d: shard(t, d, index, model), tree, dims)


def split_parts(t: torch.Tensor, split) -> Tuple[list, list]:
    """(this rank's parts of split segments, whole segments) of a
    rank's leaf ``t`` under ``split``, so that a sum over the whole leaf
    (the global norm's squares) sums the split parts over the model
    group and counts a replicated segment once."""
    if split is None:
        return [], [t]
    if not isinstance(split, Segments):
        return [t], []
    pieces = _segments(t, split, split.lengths(size()))
    return ([p for p, (_, s) in zip(pieces, split.parts) if s],
            [p for p, (_, s) in zip(pieces, split.parts) if not s])


def whole(t: torch.Tensor, split, group: dist.ProcessGroup) -> torch.Tensor:
    """The whole leaf of which ``t`` is this rank's part under ``split``,
    on every rank of ``group``: each part written into its place in a
    buffer of -0.0 and the buffers summed (``x + -0.0`` is ``x`` for
    every ``x``, a signed zero too, so the sum is exact). A whole
    segment of a ``Segments`` is written by rank 0 alone, so it too is
    summed with -0.0 only. On ``t``'s device, or on the current card
    where the group runs NCCL."""
    if split is None:
        return t
    m, r = dist.get_world_size(group), dist.get_rank(group)
    dev = t.device
    if dist.get_backend(group) == "nccl" and dev.type != "cuda":
        t = t.to("cuda")
    if isinstance(split, Segments):
        dim, lengths = split.dim, split.lengths(m)
        places = [(n, s, p) for (n, s), p in
                  zip(split.parts, _segments(t, split, lengths))]
    else:
        dim = split
        places = [(t.shape[dim] * m, True, t)]
    shape = list(t.shape)
    shape[dim] = sum(n for n, _, _ in places)
    fill = -0.0 if t.is_floating_point() else 0
    buf = torch.full(shape, fill, dtype=t.dtype, device=t.device)
    at = 0
    for n, s, p in places:
        if s:
            buf.narrow(dim, at + r * p.shape[dim], p.shape[dim]).copy_(p)
        elif r == 0:
            buf.narrow(dim, at, n).copy_(p)
        at += n
    return all_reduce_(buf, group=group).to(dev)


_CARRY_PREFIX = re.compile(r"^\.params/|^\.opt_state/\.[mv]/")


def carry_key_dims(dims) -> Callable[[str], Any]:
    """The split of each checkpoint key of a ``TrainCarry`` (the params
    and AdamW's ``m``/``v`` mirror :func:`split_dims`; the step, int8
    moments' scales and model state are whole)."""
    flat: Dict[str, Any] = {}
    tree_map_with_path(lambda path, d: flat.__setitem__(path, d), dims)

    def of(key: str) -> Any:
        if not _CARRY_PREFIX.search(key):
            return None
        return flat.get(_CARRY_PREFIX.sub("", key))
    return of
