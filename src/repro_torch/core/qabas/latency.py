"""Analytical H100 latency estimator for the QABAS search.

The paper profiles candidate ops on the target device (nn-meter) to
build a latency table. This estimator is the H100's roofline evaluated
per candidate op instead: for a block at (chunk T, channels C) with
kernel k and <w,a> bits,

    flops  = depthwise (2 T k C) + pointwise (2 T C^2)
    bytes  = weights(kC + C^2) * w_bits/8 + acts(2 T C) * a_bits/8
    lat    = max(flops / peak(w,a), bytes / HBM_BW)

Precisions of at most 8 bits run at the int8 tensor-core rate. The
interface is the paper's: an (n_ops x n_quant) table consumed by the
search's expected-latency regularizer; a measured table can be dropped
in unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.roofline import HBM_BW, PEAK_BF16, PEAK_INT8
from repro_torch.core.qabas.space import SearchSpace


def _peak_for_bits(wb: int, ab: int) -> float:
    return PEAK_INT8 if max(wb, ab) <= 8 else PEAK_BF16


def op_latency(kernel: int, wb: int, ab: int, *, chunk: int,
               channels: int) -> float:
    if kernel == 0:      # identity op
        return 0.0
    T, C = chunk, channels
    flops = 2.0 * T * kernel * C + 2.0 * T * C * C
    w_bytes = (kernel * C + C * C) * wb / 8.0
    a_bytes = 2.0 * T * C * ab / 8.0
    return max(flops / _peak_for_bits(wb, ab),
               (w_bytes + a_bytes) / HBM_BW)


def latency_table(space: SearchSpace, *, chunk: int, channels: int
                  ) -> np.ndarray:
    """(n_ops, n_quant) seconds. Identity (if present) is the last op row."""
    ops = list(space.kernel_options) + \
        ([0] if space.include_identity else [])
    tab = np.zeros((len(ops), space.n_quant), np.float64)
    for i, k in enumerate(ops):
        for j, (wb, ab) in enumerate(space.quant_options):
            tab[i, j] = op_latency(k, wb, ab, chunk=chunk, channels=channels)
    return tab


def expected_latency(alpha_probs: torch.Tensor, beta_probs: torch.Tensor,
                     table) -> torch.Tensor:
    """E[latency] = sum_b alpha_b . table . beta_b  (differentiable).

    alpha_probs: (n_blocks, n_ops); beta_probs: (n_blocks, n_quant)."""
    t = torch.as_tensor(table, dtype=torch.float32,
                        device=alpha_probs.device)
    return torch.einsum("bo,oq,bq->b", alpha_probs, t, beta_probs).sum()
