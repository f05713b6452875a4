"""Mamba-2 (SSD: state-space duality) block: the whole-prompt forward,
the one-token decode over a contiguous cache and the slot-batched step
over the serving pool (the port's counterpart of
``repro.models.lm.ssm``).

Per head h with scalar decay A_h < 0:
    state_t = exp(dt_t A_h) state_{t-1} + dt_t * B_t (x) x_t
    y_t     = C_t . state_t + D_h x_t

Routing, the port's own: :func:`ssm_forward` runs the scan through
``ops.ssd_chunk_scan``, the hand-written CUDA ``ssd_scan`` kernel on a
card, where the reference model calls its XLA ``ssd_chunked`` and never
its Pallas twin (``ssd_scan_p``). The kernel is the TPU kernel's
counterpart and the prompt's hot spot; it also returns the state after
the last position, which the decode steps continue from, so the scan
runs once. On the CPU the same call runs :func:`ssd_chunked` (the
reference's algorithm, re-exported here), so the CPU path is the
reference's. The kernel has no backward, so a training forward
(``train=True``) calls :func:`ssd_chunked` itself on any device, as the
reference trains through its XLA scan. Decode keeps O(1) state per
layer and runs no kernel: the slot step (:func:`ssm_decode_slots`)
walks a row's C tokens through the recurrence in order, as the
reference scans them.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import EMPTY_POS
from repro_torch.kernels.ref import ssd_chunked
from repro_torch.models.lm.common import (Params, dense, dense_operands,
                                          make_dense_params,
                                          truncated_normal_init)
from repro_torch.parallel import tensor_parallel as tp


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_headdim
    N = cfg.ssm_state
    conv_ch = d_in + 2 * N       # x, B, C go through the causal conv
    return d_in, nh, N, conv_ch


def make_ssm_params(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
                    dtype=torch.float32) -> Params:
    """The reference's init (other random numbers), stacked over
    ``lead``: A_log = log(1..16) over the heads, D = 1, dt_bias the
    inverse softplus of log-uniform [1e-3, 1e-1], conv taps std 0.1."""
    d = cfg.d_model
    d_in, nh, N, conv_ch = ssm_dims(cfg)
    dev = gen.device
    kw = dict(lead=lead, dtype=dtype)
    in_proj = make_dense_params(gen, d, 2 * d_in + 2 * N + nh, **kw)
    conv_w = truncated_normal_init(gen, (*lead, cfg.ssm_conv, conv_ch),
                                   stddev=0.1, dtype=dtype)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt0 = torch.exp(lo + (hi - lo) * torch.rand((*lead, nh), generator=gen,
                                                device=dev))
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=dev))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dtype, device=dev),
        "A_log": a_log.expand(*lead, nh).to(dtype).contiguous(),
        "D": torch.ones((*lead, nh), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(dt0)).to(dtype),
        "out_proj": make_dense_params(gen, d_in, d, **kw),
    }


def ssm_ranks(p: Params, cfg: ModelConfig) -> int:
    """How many ranks of a tensor-parallel model group split the heads
    of ``p`` (1: ``p`` holds every head)."""
    return ssm_dims(cfg)[1] // p["A_log"].shape[-1]


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_in, nh, N, _ = ssm_dims(cfg)
    z = zxbcdt[..., :d_in]
    x = zxbcdt[..., d_in:2 * d_in]
    Bm = zxbcdt[..., 2 * d_in:2 * d_in + N]
    Cm = zxbcdt[..., 2 * d_in + N:2 * d_in + 2 * N]
    dt = zxbcdt[..., 2 * d_in + 2 * N:]
    return z, x, Bm, Cm, dt


def _in_proj(p: Params, x: torch.Tensor, cfg: ModelConfig, m: int):
    """(z, x, B, C, dt) from ``in_proj``. Where ``m`` ranks split the
    heads, ``p`` holds this rank's z, x and dt columns and all of B's
    and C's (``sharding.Segments``): the split columns read
    ``copy_to_model(x)``, and B and C read ``x`` as it is, so ``x``'s
    gradient sums the ranks' parts of the split columns and takes B's
    and C's, whole on every rank, once. The operands are fake-quantized
    once, over the whole leaf, as one product would take them."""
    if m == 1:
        return _split_proj(dense(p, x, cfg=cfg, tag="ssm/in_proj"), cfg)
    d_in, nh, N, _ = ssm_dims(cfg)
    dl = d_in // m
    xq, w = dense_operands(p, x, cfg=cfg, tag="ssm/in_proj", parallel="col")
    xc = tp.copy_to_model(xq)
    zx = xc @ w[..., :2 * dl]
    bc = xq @ w[..., 2 * dl:2 * dl + 2 * N]
    dt = xc @ w[..., 2 * dl + 2 * N:]
    return zx[..., :dl], zx[..., dl:], bc[..., :N], bc[..., N:], dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor = None) -> torch.Tensor:
    """Depthwise causal conv of width K, then SiLU. xbc: (B, S, C); w:
    (K, C); ``state`` the K - 1 positions before xbc (zeros if None)."""
    K = w.shape[0]
    pad = (torch.zeros_like(xbc[:, :K - 1]) if state is None
           else state.to(xbc.dtype))
    xp = torch.cat([pad, xbc], dim=1)
    S = xbc.shape[1]
    out = sum(xp[:, i:i + S] * w[i].to(xbc.dtype) for i in range(K))
    return F.silu(out + b.to(xbc.dtype))


def ssm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                train: bool = False, reduce: bool = True
                ) -> Tuple[torch.Tensor, Dict]:
    """Whole-prompt forward. x: (B, S, d). Returns (y (B, S, d), the
    decode hand-off {"h": (B, nh, hd, N) fp32, "conv": the last K - 1
    pre-conv positions (B, K - 1, conv_ch)}). ``train``: the scan is
    :func:`ssd_chunked` (differentiable); otherwise
    ``ops.ssd_chunk_scan`` (the kernel on a card, which refuses inputs
    that require grad).

    Over a tensor-parallel model group whose size M divides the heads,
    ``p`` holds this rank's ``nh/M`` heads (:func:`_in_proj`; the conv's
    x channels, ``A_log``, ``D``, ``dt_bias`` and ``out_proj``'s rows)
    and B's and C's whole columns and channels (the reference's x and y
    pinned on ``model``). B and C leave the conv whole on every rank and
    pass ``copy_to_model``, since every rank's heads read them; the scan
    runs over this rank's heads, and ``out_proj`` is row-parallel
    (``reduce=False``: its partial sum left to the caller)."""
    B, S, _ = x.shape
    m = ssm_ranks(p, cfg)
    d_in, nh, N, _ = ssm_dims(cfg)
    d_in, nh = d_in // m, nh // m
    z, xs, Bm, Cm, dtr = _in_proj(p["in_proj"], x, cfg, m)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    conv_state = xbc[:, -(cfg.ssm_conv - 1):].clone()  # not a view of xbc
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    bc = tp.copy_to_model(xbc[..., d_in:], m > 1)
    xs, Bm, Cm = xbc[..., :d_in], bc[..., :N], bc[..., N:]
    dtv = F.softplus(dtr.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, S, nh, cfg.ssm_headdim)
    y, h = (ssd_chunked(xh, dtv, A, Bm, Cm, p["D"], cfg.ssm_chunk) if train
            else ops.ssd_chunk_scan(xh, dtv, A, Bm, Cm, p["D"],
                                    chunk=cfg.ssm_chunk))
    y = y.reshape(B, S, d_in) * F.silu(z)
    row = ("row" if reduce else "partial") if m > 1 else ""
    out = dense(p["out_proj"], y, cfg=cfg, tag="ssm/out_proj", parallel=row)
    return out, {"h": h.float(), "conv": conv_state}


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> Dict:
    """Empty contiguous state: h (B, nh, hd, N) fp32, conv (B, K - 1,
    conv_ch) in ``dtype``."""
    d_in, nh, N, conv_ch = ssm_dims(cfg)
    return {"h": torch.zeros((batch, nh, cfg.ssm_headdim, N),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=dtype, device=device)}


def init_ssm_cache_slots(cfg: ModelConfig, batch: int, dtype=torch.float32,
                         *, lead=(), device=None) -> Dict:
    """The serving pool's SSM state, stacked over ``lead``: h (*lead, B,
    nh, hd, N) fp32, conv (*lead, B, K - 1, conv_ch) in ``dtype``, and
    ``pos`` (*lead, B, 1), the highest position a row has written
    (``EMPTY_POS`` while the row is free). Stale recurrent state cannot
    be masked at read time, so a recycled row is zeroed
    (:func:`ssm_cache_reset_spec`); ``pos`` lets the pool see the row."""
    d_in, nh, N, conv_ch = ssm_dims(cfg)
    return {"h": torch.zeros((*lead, batch, nh, cfg.ssm_headdim, N),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=dtype, device=device),
            "pos": torch.full((*lead, batch, 1), EMPTY_POS,
                              dtype=torch.int32, device=device)}


def ssm_cache_slot_axes() -> Dict[str, bool]:
    """Every leaf is per slot: the state is O(1) a row, nothing pages."""
    return {"h": True, "conv": True, "pos": True}


def ssm_cache_reset_spec() -> Dict[str, str]:
    """Per-leaf slot-recycle action: the recurrent state feeds forward
    multiplicatively, so ``h`` and ``conv`` are zeroed; ``pos`` is
    emptied."""
    return {"h": "zero", "conv": "zero", "pos": "empty"}


def _ssm_gates(p: Params, dtr: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dt, decay exp(dt A)) in fp32 from the raw dt (..., nh) of any
    number of steps: elementwise, so a row's C steps at once give each
    step's values bit for bit."""
    dtv = F.softplus(dtr.float() + p["dt_bias"])
    return dtv, torch.exp(dtv * -torch.exp(p["A_log"]))


def _ssm_step(p: Params, cfg: ModelConfig, h: torch.Tensor,
              conv: torch.Tensor, xbc_t: torch.Tensor, dtv: torch.Tensor,
              decay: torch.Tensor, conv_w: torch.Tensor, act_dtype
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One recurrence step. h: (B, nh, hd, N) fp32; conv: (B, K - 1,
    conv_ch); xbc_t: (B, conv_ch) pre-conv; dtv, decay: (B, nh) this
    step's :func:`_ssm_gates`; conv_w: the conv taps in fp32. Returns
    (h_new fp32, window (B, K, conv_ch) whose ``[:, 1:]`` is the next
    conv state, y_t (B, nh, hd) fp32)."""
    d_in, nh, N, _ = ssm_dims(cfg)
    hd = cfg.ssm_headdim
    B = xbc_t.shape[0]
    window = torch.cat([conv.to(xbc_t.dtype), xbc_t[:, None]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.float(), conv_w) + \
        p["conv_b"]
    conv_out = F.silu(conv_out).to(act_dtype)
    xs_t = conv_out[..., :d_in].float().reshape(B, nh, hd)
    Bm_t = conv_out[..., d_in:d_in + N].float()
    Cm_t = conv_out[..., d_in + N:].float()
    h_new = h * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhd->bhdn", dtv, Bm_t, xs_t)
    y_t = torch.einsum("bn,bhdn->bhd", Cm_t, h_new) + \
        p["D"][None, :, None] * xs_t
    return h_new, window, y_t


def ssm_decode(p: Params, x: torch.Tensor, cache: Dict, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode with O(1) state. x: (B, 1, d). Returns (out,
    new cache); the conv window returns in the cache's stored dtype."""
    B = x.shape[0]
    d_in = ssm_dims(cfg)[0]
    zxbcdt = dense(p["in_proj"], x, cfg=cfg, tag="ssm/in_proj")
    z, xs, Bm, Cm, dtr = _split_proj(zxbcdt[:, 0], cfg)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)                  # (B, conv_ch)
    h, window, y = _ssm_step(p, cfg, cache["h"], cache["conv"], xbc,
                             *_ssm_gates(p, dtr), p["conv_w"].float(),
                             x.dtype)
    y = y.reshape(B, 1, d_in).to(x.dtype) * F.silu(z[:, None])
    out = dense(p["out_proj"], y, cfg=cfg, tag="ssm/out_proj")
    return out, {"h": h, "conv": window[:, 1:].to(cache["conv"].dtype)}


def ssm_decode_slots(p: Params, x: torch.Tensor, cache: Dict,
                     t: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Dict]:
    """Slot-batched recurrent step: row b's C tokens sit at positions
    ``t[b]`` (< 0 = pad). x: (B, C, d); t: (B, C) int32 on x's device.

    Walks the C steps in order (a Python loop where the reference
    scans; the elementwise gates of all C steps are computed at once);
    wherever ``t < 0`` the step leaves ``h`` and ``conv`` as
    they were, so a pad step (a decode row padded to C in a mixed tick,
    a free slot) cannot poison the row. ``pos`` advances to the row's
    highest valid position. The pool's ``h``, ``conv`` and ``pos`` are
    updated in place. Returns (out (B, C, d), cache); a pad token's
    output row is garbage the caller ignores."""
    B, C, _ = x.shape
    d_in = ssm_dims(cfg)[0]
    zxbcdt = dense(p["in_proj"], x, cfg=cfg, tag="ssm/in_proj")
    z, xs, Bm, Cm, dtr = _split_proj(zxbcdt, cfg)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)                  # (B, C, conv_ch)
    valid = t >= 0
    h, conv = cache["h"], cache["conv"]
    dtv, decay = _ssm_gates(p, dtr)                        # (B, C, nh)
    conv_w = p["conv_w"].float()
    ys = []
    for c in range(C):
        h_new, window, y_t = _ssm_step(p, cfg, h, conv, xbc[:, c],
                                       dtv[:, c], decay[:, c], conv_w,
                                       x.dtype)
        v = valid[:, c]
        h = torch.where(v[:, None, None, None], h_new, h)
        conv = torch.where(v[:, None, None], window[:, 1:].to(conv.dtype),
                           conv)
        ys.append(y_t)
    y = torch.stack(ys, dim=1).reshape(B, C, d_in).to(x.dtype) * F.silu(z)
    out = dense(p["out_proj"], y, cfg=cfg, tag="ssm/out_proj")
    top = torch.where(valid, t, torch.full_like(t, EMPTY_POS)).amax(
        dim=1, keepdim=True)
    cache["h"].copy_(h)
    cache["conv"].copy_(conv)
    torch.maximum(cache["pos"], top, out=cache["pos"])
    return out, cache
