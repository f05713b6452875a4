"""Public wrappers around the port's kernels.

A wrapper owns the layout glue (the plain versions' halo padding,
PackedTensor unwrapping, GQA head folding) and routes by device: a CPU
tensor runs the plain PyTorch version in :mod:`repro_torch.kernels.ref`,
a CUDA tensor launches the hand-written kernel — or the call raises.
There is no fallback from one to the other.

Whole-prompt prefill has two kernels: :func:`flash_attention` (the
dense family's attention) and :func:`ssd_chunk_scan` (the Mamba-2 SSD
scan).

Decode attention has two backends (:func:`decode_gqa`, and
:func:`decode_mla` for the latent arenas of MLA): ``gather``, the
masked-dense reference over a gathered logical view, and ``cuda``, the
paged kernels reading the block arena in place (``gqa_paged`` /
``mla_paged`` for single-token ticks, ``gqa_paged_chunk`` /
``mla_paged_chunk`` for C > 1 chunks).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant.policy import PackedTensor
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import qconv1d, qmatmul as qmm, ref
from repro_torch.kernels import ssd_scan as ssd


def _no_kernel(name: str, device) -> ValueError:
    return ValueError(f"{name}: no kernel for device {device}")


def qconv1d_block(x: torch.Tensor, dw, pw, gamma: torch.Tensor,
                  beta: torch.Tensor, *, relu: bool = True) -> torch.Tensor:
    """x: (B, T, C); dw/pw: int8 PackedTensor (dw packed (k, C), pw
    (C, C)); gamma/beta: (C,) folded BatchNorm. Fused RUBICALL block:
    non-causal ``(k-1)//2`` left / ``k-1-pad`` right zero halo, which the
    kernel makes itself; the plain version takes the padded window."""
    k = dw.orig_shape[0]
    w = (dw.data.reshape(k, -1), pw.data,
         dw.scale.float().reshape(1, -1).contiguous(),
         pw.scale.float().reshape(1, -1).contiguous(),
         gamma.float().reshape(1, -1).contiguous(),
         beta.float().reshape(1, -1).contiguous())
    if x.is_cuda:
        return qconv1d.qconv1d_block_cuda(x.contiguous(), *w, relu=relu)
    if x.device.type == "cpu":
        pad = (k - 1) // 2
        return ref.qconv1d_block_ref(F.pad(x, (0, 0, pad, k - 1 - pad)), *w,
                                     relu=relu)
    raise _no_kernel("qconv1d_block", x.device)


def qmatmul(x: torch.Tensor, w, scale=None, *, bits: int = 8
            ) -> torch.Tensor:
    """x: (..., K) @ quantized w -> (..., N) in x's dtype. ``w`` is a 2-D
    PackedTensor or raw int8 data with its ``scale``."""
    if isinstance(w, PackedTensor):
        bits, scale, w = w.bits, w.scale, w.data
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    s2 = scale.float().reshape(1, -1).contiguous()
    if x.is_cuda:
        out = qmm.qmatmul_cuda(x2, w, s2, bits=bits)
    elif x.device.type == "cpu":
        out = ref.qmatmul_ref(x2, w, s2, bits=bits)
    else:
        raise _no_kernel("qmatmul", x.device)
    return out.reshape(lead + (out.shape[-1],))


# ---------------------------------------------------------------------------
# Whole-prompt prefill


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, d); k/v: (B, Sk, Hkv, d) -> (B, Sq, H, d) in q's
    dtype. Query head h reads KV head h // (H // Hkv); any Sq, Sk."""
    if q.is_cuda:
        return fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=causal)
    if q.device.type == "cpu":
        return ref.flash_attention_gqa_ref(q, k, v, causal=causal)
    raise _no_kernel("flash_attention", q.device)


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
                   chunk: int = 256):
    """x: (B, S, nh, hd); dt: (B, S, nh); A/D: (nh,); Bm/Cm: (B, S, N),
    shared by every head. Returns (y (B, S, nh, hd) in x's dtype, the
    state after the last position (B, nh, hd, N) fp32). On the card dt,
    A and D go to the kernel in fp32 (exact widenings) and B/C in x's
    dtype."""
    if x.is_cuda:
        return ssd.ssd_scan_cuda(
            x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
            Bm.to(x.dtype).contiguous(), Cm.to(x.dtype).contiguous(),
            D.float().contiguous(), chunk=chunk)
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk)
    raise _no_kernel("ssd_chunk_scan", x.device)


# ---------------------------------------------------------------------------
# Decode-attention backend dispatch

ATTN_BACKENDS = ("auto", "gather", "cuda")


def resolve_attn_backend(name: Optional[str] = None,
                         device=None) -> str:
    """``auto`` (or None) -> ``cuda`` on a CUDA device, ``gather`` on the
    CPU. Forcing ``cuda`` on the CPU runs the kernels' plain versions
    (they walk the arena exactly as the kernels do)."""
    name = name or "auto"
    if name not in ATTN_BACKENDS:
        raise ValueError(f"attn backend {name!r} not in {ATTN_BACKENDS}")
    if name == "auto":
        return "cuda" if torch.device(device or "cpu").type == "cuda" \
            else "gather"
    return name


def _paged(q, *args, chunk: bool, **kw):
    """Kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if q.is_cuda:
        fn = pa.gqa_paged_chunk_cuda if chunk else pa.gqa_paged_cuda
    elif q.device.type == "cpu":
        fn = ref.gqa_paged_chunk_ref if chunk else ref.gqa_paged_ref
    else:
        raise _no_kernel("gqa_paged", q.device)
    return fn(q, *args, **kw)


def decode_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pos: torch.Tensor, t: torch.Tensor, *, table: torch.Tensor,
               window: int = 0, backend: Optional[str] = None,
               k_scale: Optional[torch.Tensor] = None,
               v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention over the paged pool. q: (B, C, H, hd); k/v: arenas
    (n_blocks, block_len, Hkv, hd); pos: (B, T*block_len); t: (B, C)
    (< 0 = pad row); table: (B, T) (-1 = unassigned). Returns
    (B, C, H*hd).

    ``backend`` ``gather``/None: the reference over the gathered logical
    view. ``cuda``: single-token steps (C == 1) run ``gqa_paged``,
    C > 1 chunks ``gqa_paged_chunk``. ``k_scale``/``v_scale``: int8
    arena scales (n_blocks, block_len, Hkv)."""
    B, C, H, hd = q.shape
    Hkv, bl = k.shape[2], k.shape[1]
    if backend == "cuda":
        kw = dict(window=window, k_scale=k_scale, v_scale=v_scale)
        tbl = table.to(torch.int32).contiguous()
        pos, tq = pos.contiguous(), t.to(torch.int32)
        if C == 1:
            qh = q.reshape(B, Hkv, H // Hkv, hd).contiguous()
            o = _paged(qh, k, v, pos, tq[:, 0].contiguous(), tbl,
                       chunk=False, **kw)
            return o.reshape(B, 1, H * hd)
        return _paged(q.contiguous(), k, v, pos, tq.contiguous(), tbl,
                      chunk=True, **kw)
    gidx = torch.clamp(table.long(), min=0)
    Leff = table.shape[1] * bl
    k_read = pa.take_blocks(k, gidx).reshape(B, Leff, Hkv, hd)
    v_read = pa.take_blocks(v, gidx).reshape(B, Leff, Hkv, hd)
    if k_scale is not None:
        k_read = pa.dequantize_kv(k_read, k_scale[gidx].reshape(B, Leff, Hkv))
        v_read = pa.dequantize_kv(v_read, v_scale[gidx].reshape(B, Leff, Hkv))
    return pa.gqa_reference(q, k_read, v_read, pos, t, window=window)


def _mla_paged(q_abs, *args, chunk: bool, **kw):
    """MLA kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if q_abs.is_cuda:
        fn = pa.mla_paged_chunk_cuda if chunk else pa.mla_paged_cuda
    elif q_abs.device.type == "cpu":
        fn = ref.mla_paged_chunk_ref if chunk else ref.mla_paged_ref
    else:
        raise _no_kernel("mla_paged", q_abs.device)
    return fn(q_abs, *args, **kw)


def decode_mla(q_abs: torch.Tensor, q_rope: torch.Tensor, c: torch.Tensor,
               k_rope: torch.Tensor, pos: torch.Tensor, t: torch.Tensor, *,
               scale: float, table: torch.Tensor,
               backend: Optional[str] = None,
               c_scale: Optional[torch.Tensor] = None,
               kr_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Absorbed-form MLA decode over the paged latent pool. q_abs: (B, C,
    H, kvr); q_rope: (B, C, H, rope); c/k_rope: latent arenas (n_blocks,
    block_len, kvr|rope); pos: (B, T*block_len); t: (B, C) (< 0 = pad
    row); table: (B, T) (-1 = unassigned). Returns o_lat (B, C, H, kvr)
    fp32; the caller applies the absorbed value projection.

    ``backend`` ``gather``/None: the reference over the gathered logical
    view. ``cuda``: single-token steps (C == 1) run ``mla_paged``, C > 1
    chunks ``mla_paged_chunk``. ``c_scale``/``kr_scale``: int8 arena
    scales (n_blocks, block_len)."""
    B, C, H, kvr = q_abs.shape
    if backend == "cuda":
        if q_rope.dtype != q_abs.dtype:
            # the kernel reads both in one dtype; widening is exact and it
            # rounds each to the compute dtype itself
            q_abs, q_rope = q_abs.float(), q_rope.float()
        kw = dict(scale=scale, c_scale=c_scale, kr_scale=kr_scale)
        tbl = table.to(torch.int32).contiguous()
        pos, tq = pos.contiguous(), t.to(torch.int32)
        if C == 1:
            o = _mla_paged(q_abs[:, 0].contiguous(),
                           q_rope[:, 0].contiguous(), c, k_rope, pos,
                           tq[:, 0].contiguous(), tbl, chunk=False, **kw)
            return o[:, None]
        return _mla_paged(q_abs.contiguous(), q_rope.contiguous(), c,
                          k_rope, pos, tq.contiguous(), tbl, chunk=True,
                          **kw)
    gidx = torch.clamp(table.long(), min=0)
    Leff = table.shape[1] * c.shape[1]
    c_read = pa.take_blocks(c, gidx).reshape(B, Leff, kvr)
    kr_read = pa.take_blocks(k_rope, gidx).reshape(B, Leff,
                                                   k_rope.shape[-1])
    if c_scale is not None:
        c_read = pa.dequantize_kv(c_read, c_scale[gidx].reshape(B, Leff))
        kr_read = pa.dequantize_kv(kr_read, kr_scale[gidx].reshape(B, Leff))
    return pa.mla_reference(q_abs, q_rope, c_read, kr_read, pos, t,
                            scale=scale)


# ---------------------------------------------------------------------------
# Launch counters

_COUNTED = {"qconv1d_block": qconv1d.qconv1d_block_cuda,
            "qmatmul": qmm.qmatmul_cuda,
            "gqa_paged": pa.gqa_paged_cuda,
            "gqa_paged_chunk": pa.gqa_paged_chunk_cuda,
            "mla_paged": pa.mla_paged_cuda,
            "mla_paged_chunk": pa.mla_paged_chunk_cuda,
            "flash_attention": fa.flash_attention_cuda,
            "ssd_scan": ssd.ssd_scan_cuda}


def launch_counts(routes: bool = False) -> dict:
    """Kernel launches so far, by kernel (CPU calls launch nothing).
    ``routes``: by kernel and route instead, ``{"tensor_core": n,
    "cuda_core": m}``."""
    if not routes:
        return {name: fn.launches for name, fn in _COUNTED.items()}
    return {name: dict(fn.routes) for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
        for route in fn.routes:
            fn.routes[route] = 0
