"""Plain PyTorch versions of the port's kernels (the allclose ground
truth): the CPU path of every wrapper in :mod:`repro_torch.kernels.ops`
and the oracle each CUDA kernel is held against on the card."""
from __future__ import annotations

import torch


def qconv1d_block_ref(x, dw_q, pw_q, dw_scale, pw_scale, gamma, beta, *,
                      relu: bool = True):
    """x: (B, T + k - 1, C) pre-padded; int8 dw (k, C) and pw (C, C);
    fp32 (1, C) scales and folded-BN gamma/beta. Returns (B, T, C) in
    x's dtype."""
    k, C = dw_q.shape
    T = x.shape[1] - (k - 1)
    dw = dw_q.float() * dw_scale
    pw = pw_q.float() * pw_scale
    xf = x.float()
    acc = sum(xf[:, i:i + T] * dw[i] for i in range(k))
    y = torch.einsum("btc,cd->btd", acc, pw)
    y = y * gamma + beta
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)
