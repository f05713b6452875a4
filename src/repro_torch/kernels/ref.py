"""Plain PyTorch versions of the port's kernels (the allclose ground
truth): the CPU path of every wrapper in :mod:`repro_torch.kernels.ops`
and the oracle each CUDA kernel is held against on the card.

``flash_attention_ref`` and ``ssd_scan_ref`` are the twins of the
reference's own oracles (heads folded into rows); ``flash_attention_gqa_ref``
and ``ssd_chunked`` take the public layouts of the ``flash_attention``
and ``ssd_scan`` kernels and are their plain versions."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention import (NEG_INF, compute_dtype,
                                                 dequantize_kv,
                                                 mla_compute_dtype,
                                                 put_rows, take_blocks)


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


def scatter_rows_ref(dst: torch.Tensor, i0: torch.Tensor, i1: torch.Tensor,
                     src: torch.Tensor) -> None:
    """In place ``dst[i0[w], i1[w]] = src[w]``, the writes with an index
    outside ``dst``'s first two dims dropped: those in range are
    filtered out (read where ``i0``/``i1`` lie), then one
    ``index_put_``."""
    keep = ((i0 >= 0) & (i0 < dst.shape[0]) & (i1 >= 0)
            & (i1 < dst.shape[1]))
    w = torch.nonzero(keep)[:, 0]
    put_rows(dst, (i0[w], i1[w]), src[w])


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


def _mla_walk(qa: torch.Tensor, qr: torch.Tensor, c: torch.Tensor,
              kr: torch.Tensor, pos: torch.Tensor, tq: torch.Tensor,
              table: torch.Tensor, scale: float,
              c_scale: Optional[torch.Tensor],
              kr_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The MLA kernels' block walk over query rows qa (B, R, kvr), qr
    (B, R, rope) with per-row positions tq (B, R): per table column j,
    rows whose entry is assigned read latent block ``table[b, j]`` (int8
    dequantized to bf16), score ``(qa . c + qr . kr) * scale``, mask and
    fold into an fp32 online softmax; a -1 entry leaves the state
    unchanged. q and p are rounded to the compute dtype as the kernels
    round them. Returns o_lat (B, R, kvr) fp32."""
    B, R, kvr = qa.shape
    bl = c.shape[1]
    T = table.shape[1]
    cdt = mla_compute_dtype(c.dtype)
    q, qrr = qa.to(cdt).float(), qr.to(cdt).float()
    m = torch.full((B, R, 1), NEG_INF, dtype=torch.float32,
                   device=qa.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, R, kvr), dtype=torch.float32, device=qa.device)
    tqe = tq[:, :, None]                                  # (B, R, 1)
    for j in range(T):
        blk = table[:, j].long()
        idx = blk.clamp(min=0)
        cb, krb = take_blocks(c, idx), take_blocks(kr, idx)  # (B, bl, *)
        if c_scale is not None:
            cb = dequantize_kv(cb, c_scale[idx])
            krb = dequantize_kv(krb, kr_scale[idx])
        cb, krb = cb.float(), krb.float()
        s = (q @ cb.transpose(-1, -2) + qrr @ krb.transpose(-1, -2)) * scale
        p_pos = pos[:, j * bl:(j + 1) * bl][:, None, :]
        valid = (p_pos >= 0) & (p_pos <= tqe)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        acc_new = acc * corr + p.to(cdt).float() @ cb
        live = (blk >= 0)[:, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    return acc / torch.clamp_min(l, 1e-30)


def mla_paged_ref(q_abs, q_rope, c, kr, pos, t, table, *, scale: float,
                  c_scale=None, kr_scale=None):
    """Plain version of the single-token MLA kernel. q_abs: (B, H, kvr);
    q_rope: (B, H, rope); t: (B,). Returns o_lat (B, H, kvr) fp32."""
    B, H, _ = q_abs.shape
    tq = t.reshape(B, 1).expand(B, H)
    return _mla_walk(q_abs, q_rope, c, kr, pos, tq, table, scale, c_scale,
                     kr_scale)


def mla_paged_chunk_ref(q_abs, q_rope, c, kr, pos, t, table, *,
                        scale: float, c_scale=None, kr_scale=None):
    """Plain version of the MLA chunk kernel. q_abs: (B, C, H, kvr);
    q_rope: (B, C, H, rope); t: (B, C). The chunk folds into query rows
    c * H + h, each with its own position. Returns o_lat (B, C, H, kvr)
    fp32."""
    B, C, H, kvr = q_abs.shape
    tq = t.repeat_interleave(H, dim=1)                    # (B, C*H)
    o = _mla_walk(q_abs.reshape(B, C * H, kvr),
                  q_rope.reshape(B, C * H, q_rope.shape[-1]), c, kr, pos,
                  tq, table, scale, c_scale, kr_scale)
    return o.reshape(B, C, H, kvr)


# ---------------------------------------------------------------------------
# Whole-prompt prefill: flash attention and the Mamba-2 SSD scan


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q/k/v: (BH, S, d) -> (BH, Sq, d) in q's dtype: dense fp32 softmax
    attention, scale d^-0.5, causal keys ``k <= q`` (index from the start
    of both sequences) with the finite -1e30 mask."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_gqa_ref(q, k, v, *, causal: bool = True):
    """Plain version of the ``flash_attention`` kernel. q: (B, Sq, H, d);
    k/v: (B, Sk, Hkv, d); query head h reads KV head h // (H // Hkv).
    Heads fold into rows and KV heads repeat per group, as the
    reference's ``ops.flash_attention`` does. Returns (B, Sq, H, d)."""
    B, Sq, H, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = q.transpose(1, 2).reshape(B * H, Sq, d)
    kf = k.transpose(1, 2).repeat_interleave(g, dim=1).reshape(B * H, Sk, d)
    vf = v.transpose(1, 2).repeat_interleave(g, dim=1).reshape(B * H, Sk, d)
    o = flash_attention_ref(qf, kf, vf, causal=causal)
    return o.reshape(B, H, Sq, d).transpose(1, 2)


def ssd_scan_ref(x, dt, A, Bm, Cm, D):
    """The exact SSD recurrence, one step at a time. x: (BH, S, hd); dt:
    (BH, S); A/D: (BH,); Bm/Cm: (BH, S, N). Returns y (BH, S, hd) in
    x's dtype."""
    BH, S, hd = x.shape
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    h = torch.zeros((BH, hd, Bm.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A)
        h = decay[:, None, None] * h + dtf[:, t, None, None] * (
            xf[:, t, :, None] * Bf[:, t, None, :])
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]) + D[:, None] *
                  xf[:, t])
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int, init_state=None):
    """The chunked SSD algorithm (the reference model's
    ``ssm.ssd_chunked``), the plain version of the ``ssd_scan`` kernel
    and the training forward's scan. x: (B, S, nh, hd); dt: (B, S, nh);
    A/D: (nh,); Bm/Cm: (B, S, N). The chunk shrinks to the largest
    divisor of S. Returns (y (B, S, nh, hd) in x's dtype, final state
    (B, nh, hd, N) fp32).

    One departure from the reference, in the gradient only: the
    intra-chunk decay ``exp(cum_t - cum_s)`` is masked to the causal
    triangle before the ``exp``. The reference exponentiates the whole
    Q x Q block and masks after; above the diagonal the exponent is
    +sum |A dt|, which overflows fp32 at mamba2-130m's chunk of 256 once
    dt nears its init's 0.1, and its backward then forms 0 * inf (NaN
    gradients for A_log and dt). The entries kept are computed as before
    and the rest are zeroed as before, so the output equals the unmasked
    form's bit for bit."""
    Bsz, S, nh, hd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    T = S // Q
    xr = x.reshape(Bsz, T, Q, nh, hd).float()
    dtr = dt.reshape(Bsz, T, Q, nh).float()
    Br = Bm.reshape(Bsz, T, Q, N).float()
    Cr = Cm.reshape(Bsz, T, Q, N).float()
    cum = torch.cumsum(dtr * A.float(), dim=2)           # (B, T, Q, nh)
    total = cum[:, :, -1]                                 # (B, T, nh)
    # intra-chunk: M[t, s] = C_t.B_s exp(cum_t - cum_s) dt_s, s <= t
    G = torch.einsum("btqn,btsn->btqs", Cr, Br)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.exp(torch.where(causal, diff, -torch.inf))
    M = G[..., None] * decay * dtr[:, :, None, :, :]
    M = torch.where(causal, M, torch.zeros_like(M))
    y_intra = torch.einsum("btqsh,btshd->btqhd", M, xr)
    # each chunk's contribution to the state, then the scan over chunks
    w_state = torch.exp(total[:, :, None, :] - cum) * dtr
    S_chunk = torch.einsum("btqh,btqn,btqhd->bthdn", w_state, Br, xr)
    h = (torch.zeros((Bsz, nh, hd, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_prevs = []
    for i in range(T):
        h_prevs.append(h)
        h = h * torch.exp(total[:, i])[:, :, None, None] + S_chunk[:, i]
    y_inter = torch.einsum("btqn,btqh,bthdn->btqhd", Cr, torch.exp(cum),
                           torch.stack(h_prevs, dim=1))
    y = y_intra + y_inter + D.float()[None, None, None, :, None] * xr
    return y.reshape(Bsz, S, nh, hd).to(x.dtype), h
