"""One-shot L1 pruning: unstructured (element) and structured (channel).

Paper Figs. 6 & 14: prune at a target sparsity, then fine-tune to
convergence. Unstructured gives the best compression but irregular
sparsity; structured removes whole output channels, so dense math
stays dense on smaller tiles. Trees are dicts and lists; a leaf's path
is its '/'-joined keys, and the reference's name test picks the
prunable leaves, so the masks come out the same.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.policy import (tree_items, tree_leaves, tree_map,
                                           tree_map_with_path)


def _prunable(path: str, leaf) -> bool:
    return hasattr(leaf, "ndim") and leaf.ndim >= 2 and \
        any(k in path for k in ("dw", "pw", "kernel", "wi", "wg", "wo"))


def unstructured_mask(params, sparsity: float):
    """Global magnitude threshold over prunable weights -> 0/1 mask tree."""
    allw = torch.cat([l.abs().reshape(-1) for p, l in tree_items(params)
                      if _prunable(p, l)])
    k = int(sparsity * allw.numel())
    thresh = torch.sort(allw).values[k - 1] if k > 0 else -float("inf")

    def one(path, leaf):
        if _prunable(path, leaf):
            return (leaf.abs() > thresh).to(leaf.dtype)
        return torch.ones_like(leaf)
    return tree_map_with_path(one, params)


def structured_channel_mask(params, sparsity: float):
    """Per layer: zero the lowest-L1 output channels (last axis)."""
    def one(path, leaf):
        if not _prunable(path, leaf):
            return torch.ones_like(leaf)
        norms = leaf.abs().sum(dim=tuple(range(leaf.ndim - 1)))
        k = int(sparsity * norms.numel())
        if k == 0:
            return torch.ones_like(leaf)
        thresh = torch.sort(norms).values[k - 1]
        keep = (norms > thresh).to(leaf.dtype)
        return keep.expand(leaf.shape).clone()
    return tree_map_with_path(one, params)


def apply_mask(params, mask):
    return tree_map(lambda p, m: p * m, params, mask)


def sparsity_of(mask) -> float:
    leaves = tree_leaves(mask)
    tot = sum(m.numel() for m in leaves)
    nz = sum(int((m != 0).sum()) for m in leaves)
    return 1.0 - nz / tot


def model_size_bytes(params, mask=None, bits: int = 32) -> float:
    """Size honouring pruning (nonzero weights only) and quantization."""
    if mask is None:
        n = sum(l.numel() for l in tree_leaves(params))
    else:
        n = sum(int((m != 0).sum()) for m in tree_leaves(mask))
    return n * bits / 8.0
