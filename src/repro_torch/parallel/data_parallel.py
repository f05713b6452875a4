"""Batch statistics and gradients over a data-parallel group.

A data-parallel train step (``training/train_loop.run`` on a ``(data=n,
model=1)`` mesh) gives each of ``n`` ranks its own rows of one global
batch. The reference's GSPMD program computes a batch-wide statistic
over the whole global batch, so the two places in the models that read
the batch take theirs over the data group while
:func:`batch_stats_over` is in force:

- BatchNorm's mean and variance (``models/basecaller/blocks.batchnorm``):
  the per-channel sum, then the sum of squares about the global mean,
  each summed over the group with a gradient (:func:`all_sum`), so every
  rank normalises and updates its running statistics alike;
- per-tensor activation fake-quant's amax (the activation quantizers of
  ``models/basecaller/blocks`` and ``models/lm/common.dense`` hand
  :func:`all_max_` to ``core/quant/fake_quant.fake_quant``): the
  maximum over the group; the scale sits behind the straight-through
  ``detach``, so it takes no gradient.

Outside it (one process, serving, evaluation) there is no group: the
sums and the maximum are the local ones, the group's size is 1, and no
collective is issued. One formula serves both cases. At import this
module loads only torch.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

_GROUP: Optional[dist.ProcessGroup] = None


@contextlib.contextmanager
def batch_stats_over(group: Optional[dist.ProcessGroup]):
    """Batch statistics reduce over ``group`` inside (``None``: none)."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = prev


def group_size() -> int:
    """Ranks in the batch group (1 without one)."""
    return 1 if _GROUP is None else dist.get_world_size(_GROUP)


class _AllSum(torch.autograd.Function):
    """Sum over a group; its gradient is the sum over the group of the
    result's gradients, since every rank's result reads every ``t``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllSum.apply(grad, ctx.group), None


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the batch group, differentiable (``t`` itself
    without a group)."""
    return t if _GROUP is None else _AllSum.apply(t, _GROUP)


def all_max_(t: torch.Tensor) -> torch.Tensor:
    """``t`` replaced by its maximum over the batch group (no gradient;
    ``t`` as it is without a group)."""
    if _GROUP is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_GROUP)
    return t


def mean_over(group: dist.ProcessGroup, grads, loss: torch.Tensor):
    """(gradients, loss) averaged over ``group``: every leaf flattened
    into one fp32 buffer, one all-reduce, and the means copied back into
    the gradient leaves (views into the buffer would sit at other
    alignments than the one-process step's leaves, and a reduction over
    them, such as the optimizer's gradient norm, adds in another order).
    Gradient leaves are fp32."""
    from repro_torch.core.quant.policy import tree_map
    leaves = []
    tree_map(leaves.append, grads)
    flat = torch.cat([g.reshape(-1) for g in leaves]
                     + [loss.detach().float().reshape(1)])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    off = 0
    for g in leaves:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return grads, flat[off].reshape(loss.shape)
