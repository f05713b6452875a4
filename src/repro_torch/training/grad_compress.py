"""int8 gradient compression with error feedback — the paper's
quantization idea applied to the gradient all-reduce's bytes.

``compress -> all-reduce(int8 payload) -> decompress`` cuts the
gradient bytes 4x against fp32. Error feedback (Karimireddy et al.)
keeps the quantization residual locally and re-injects it the next
step, which keeps Adam's convergence. On one device the round trip is
what the reduction would see; ``train_loop`` runs it when
``grad_compress_bits=8``. A tensor-parallel rank's shard of a split leaf
takes the whole leaf's per-tensor scale (the maximum over the model
group); its error state stays local.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.quant.policy import tree_map
from repro_torch.parallel import tensor_parallel as tp


def init_error_state(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress(g: torch.Tensor, err: torch.Tensor, split=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale, new_err). Per-tensor symmetric scale;
    ``split`` (not None: a split dim or segments): ``g`` is this rank's
    shard of a leaf split over the model group, whose amax is the
    group's (a replicated segment's maximum is its own on every rank)."""
    gf = g.float() + err
    amax = gf.abs().amax()
    if split is not None:
        tp.all_max_(amax)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.float() * scale
    return q, scale, new_err


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, err_state, split=None):
    """Tree version: (quantized payload tree, scales, new errors). The
    payload is what crosses the wire (int8); the scales are 0-d fp32
    tensors reduced beside it. ``split``: the leaves' split dims
    (``tensor_parallel.split_dims``; None: none)."""
    if split is None:
        split = tree_map(lambda _: None, grads)
    out = tree_map(compress, grads, err_state, split)
    return tuple(tree_map(lambda t: t[i], out) for i in range(3))


def decompress_tree(qs, scales):
    return tree_map(decompress, qs, scales)


def roundtrip_tree(grads, err_state, split=None):
    """compress + decompress in one step: (gradients as the reduction
    sees them, new errors)."""
    qs, scales, errs = compress_tree(grads, err_state, split)
    return decompress_tree(qs, scales), errs
