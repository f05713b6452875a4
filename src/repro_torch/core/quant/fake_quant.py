"""Symmetric fake-quantization for QAT (straight-through estimator).

Values are rounded to the b-bit grid but kept in float; gradients flow
through unchanged (STE). Serving converts to true packed integers via
:mod:`repro_torch.core.quant.policy`.
"""
from __future__ import annotations

from typing import Optional

import torch


def _scales(x: torch.Tensor, bits: int, axis: Optional[int]) -> torch.Tensor:
    qmax = 2.0 ** (bits - 1) - 1.0
    if axis is None:
        amax = x.abs().amax()
    else:
        red = tuple(i for i in range(x.ndim) if i != axis)
        amax = x.abs().amax(dim=red, keepdim=True)
    return amax.clamp_min(1e-8) / qmax


def fake_quant(x: torch.Tensor, bits: int,
               axis: Optional[int] = None) -> torch.Tensor:
    """Round x to a symmetric b-bit grid, straight-through gradient
    (``x + (q(x) - x).detach()`` — exact pass-through everywhere,
    including the clip boundary; the scale is an observer statistic,
    not a gradient path).

    ``axis`` selects per-channel scales (reduce over all other axes);
    ``None`` = per-tensor.
    """
    if bits <= 0 or bits >= 32:
        return x
    dt = x.dtype
    xf = x.float()
    with torch.no_grad():
        s = _scales(xf, bits, axis)
    qmax = 2.0 ** (bits - 1) - 1.0
    q = torch.clamp(torch.round(xf / s), -qmax - 1, qmax) * s
    return (xf + (q - xf).detach()).to(dt)
