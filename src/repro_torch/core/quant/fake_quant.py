"""Symmetric fake-quantization for QAT (straight-through estimator).

Values are rounded to the b-bit grid but kept in float; gradients flow
through unchanged (STE). Serving converts to true packed integers via
:mod:`repro_torch.core.quant.policy`.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.quant.policy import tree_map


def _scales(x: torch.Tensor, bits: int, axis: Optional[int],
            amax_reduce: Optional[Callable]) -> torch.Tensor:
    qmax = 2.0 ** (bits - 1) - 1.0
    if axis is None:
        amax = x.abs().amax()
    else:
        red = tuple(i for i in range(x.ndim) if i != axis)
        amax = x.abs().amax(dim=red, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    return amax.clamp_min(1e-8) / qmax


def fake_quant(x: torch.Tensor, bits: int, axis: Optional[int] = None, *,
               amax_reduce: Optional[Callable] = None) -> torch.Tensor:
    """Round x to a symmetric b-bit grid, straight-through gradient
    (``x + (q(x) - x).detach()`` — exact pass-through everywhere,
    including the clip boundary; the scale is an observer statistic,
    not a gradient path).

    ``axis`` selects per-channel scales (reduce over all other axes);
    ``None`` = per-tensor. ``amax_reduce`` maps the amax (per tensor or
    per channel) to the one the scale is taken from: the activation
    quantizers of a data-parallel step pass
    ``parallel/data_parallel.all_max_``, the maximum over the data
    group, and a weight or input split over a tensor-parallel model
    group ``parallel/tensor_parallel.all_max_``.
    """
    if bits <= 0 or bits >= 32:
        return x
    dt = x.dtype
    xf = x.float()
    with torch.no_grad():
        s = _scales(xf, bits, axis, amax_reduce)
    qmax = 2.0 ** (bits - 1) - 1.0
    q = torch.clamp(torch.round(xf / s), -qmax - 1, qmax) * s
    return (xf + (q - xf).detach()).to(dt)


def quant_dequant_params(params, bits: int, per_channel: bool = True):
    """Fake-quant every >=2D leaf of a param tree (static quantization —
    same precision everywhere; the paper's Fig. 7/8 sweep)."""
    def one(x):
        if x.ndim >= 2:
            return fake_quant(x, bits, axis=x.ndim - 1 if per_channel
                              else None)
        return x
    return tree_map(one, params)
