"""Plain PyTorch versions of the port's kernels (the allclose ground
truth): the CPU path of every wrapper in :mod:`repro_torch.kernels.ops`
and the oracle each CUDA kernel is held against on the card."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention import (NEG_INF, compute_dtype,
                                                 dequantize_kv, take_blocks)


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


def qmatmul_ref(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                *, bits: int = 8) -> torch.Tensor:
    """x (M, K) @ w_q with fp32 accumulation, the per-column scale after
    the K sum, rounded once to x's dtype. int4: packed row r holds rows
    2r (low nibble) and 2r + 1 (high), sign-extended; an odd K drops
    the pad row."""
    if bits == 4:
        from repro_torch.core.quant.policy import unpack_int4
        w = unpack_int4(w_q)[: x.shape[-1]]
    else:
        w = w_q
    return ((x.float() @ w.float()) * scale.float()).to(x.dtype)


def _paged_walk(qf: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                pos: torch.Tensor, tq: torch.Tensor, table: torch.Tensor,
                window: int, k_scale: Optional[torch.Tensor],
                v_scale: Optional[torch.Tensor],
                out_dtype: torch.dtype) -> torch.Tensor:
    """The kernels' block walk over query rows qf (B, Hkv, R, hd) with
    per-row positions tq (B, R): for each table column j, every row
    whose entry is assigned reads arena block ``table[b, j]``, masks,
    and folds it into an fp32 online softmax; a row whose entry is -1
    leaves its state unchanged. Same rounding as the kernels."""
    B, Hkv, R, hd = qf.shape
    bl = k.shape[1]
    T = table.shape[1]
    cdt = compute_dtype(k.dtype)
    q = qf.to(cdt).float()
    m = torch.full((B, Hkv, R, 1), NEG_INF, dtype=torch.float32,
                   device=qf.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, R, hd), dtype=torch.float32,
                      device=qf.device)
    tqe = tq[:, None, :, None]                           # (B, 1, R, 1)
    for j in range(T):
        blk = table[:, j].long()
        idx = blk.clamp(min=0)
        kb, vb = take_blocks(k, idx), take_blocks(v, idx)  # (B, bl, Hkv, hd)
        if k_scale is not None:
            kb = dequantize_kv(kb, k_scale[idx])
            vb = dequantize_kv(vb, v_scale[idx])
        else:
            kb, vb = kb.to(cdt), vb.to(cdt)
        kb = kb.float().permute(0, 2, 1, 3)               # (B, Hkv, bl, hd)
        vb = vb.float().permute(0, 2, 1, 3)
        s = (q @ kb.transpose(-1, -2)) * (hd ** -0.5)     # (B, Hkv, R, bl)
        p_pos = pos[:, j * bl:(j + 1) * bl][:, None, None, :]
        valid = (p_pos >= 0) & (p_pos <= tqe)
        if window > 0:
            valid &= p_pos > tqe - window
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        acc_new = acc * corr + p.to(cdt).float() @ vb
        live = (blk >= 0)[:, None, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    return (acc / torch.clamp_min(l, 1e-30)).to(out_dtype)


def gqa_paged_ref(q, k, v, pos, t, table, *, window: int = 0,
                  k_scale=None, v_scale=None):
    """Plain version of the single-token kernel. q: (B, Hkv, group, hd);
    t: (B,). Returns (B, Hkv, group, hd) in q's dtype."""
    B, Hkv, group, hd = q.shape
    tq = t.reshape(B, 1).expand(B, group)
    return _paged_walk(q, k, v, pos, tq, table, window, k_scale, v_scale,
                       q.dtype)


def gqa_paged_chunk_ref(q, k, v, pos, t, table, *, window: int = 0,
                        k_scale=None, v_scale=None):
    """Plain version of the chunk kernel. q: (B, C, H, hd); t: (B, C).
    The chunk folds into query rows c * group + g, each with its own
    position. Returns (B, C, H*hd) in q's dtype."""
    B, C, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qf = (q.reshape(B, C, Hkv, group, hd).permute(0, 2, 1, 3, 4)
          .reshape(B, Hkv, C * group, hd))
    tq = t.repeat_interleave(group, dim=1)                # (B, C*group)
    o = _paged_walk(qf, k, v, pos, tq, table, window, k_scale, v_scale,
                    q.dtype)
    return (o.reshape(B, Hkv, C, group, hd).permute(0, 2, 1, 3, 4)
            .reshape(B, C, H * hd))
