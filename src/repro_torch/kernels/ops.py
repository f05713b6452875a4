"""Public wrappers around the port's kernels.

A wrapper owns the layout glue (the plain versions' halo padding,
PackedTensor unwrapping, GQA head folding) and routes by device: a CPU
tensor runs the plain PyTorch version in :mod:`repro_torch.kernels.ref`,
a CUDA tensor launches the hand-written kernel — or the call raises.
There is no fallback from one to the other. The kernels have no
backward, so on a card an input that requires grad (with grad enabled)
raises rather than getting no gradient.

Whole-prompt prefill has two kernels: :func:`flash_attention` (the
dense family's attention) and :func:`ssd_chunk_scan` (the Mamba-2 SSD
scan).

Decode attention has two backends (:func:`decode_gqa`, and
:func:`decode_mla` for the latent arenas of MLA): ``gather``, the
masked-dense reference over a gathered logical view, and ``cuda``, the
paged kernels reading the block arena in place (``gqa_paged`` /
``mla_paged`` for single-token ticks, ``gqa_paged_chunk`` /
``mla_paged_chunk`` for C > 1 chunks). Both also take contiguous rows
(no table), which the ``cuda`` backend views as an arena of blocks.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.compat import is_fake
from repro_torch.core.quant.policy import PackedTensor
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import qconv1d, qmatmul as qmm, ref
from repro_torch.kernels import scatter_rows as sr
from repro_torch.kernels import ssd_scan as ssd


def _no_kernel(name: str, device) -> ValueError:
    return ValueError(f"{name}: no kernel for device {device}")


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """``a`` contiguous and 16-byte aligned, as the kernels read it: a
    layer's slice of a stacked leaf (hymba's D, 50 fp32 values a layer)
    starts wherever the previous layers end, so it is copied."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _no_backward(name: str, *inputs: torch.Tensor) -> None:
    """The CUDA kernels write their outputs through ctypes, so autograd
    records nothing: an input that requires grad would silently get no
    gradient from the kernel. Every wrapper raises instead, on a card
    (training has its own differentiable paths)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            f"requires grad; train through the model's train=True path")


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
        _no_backward("qconv1d_block", x, gamma, beta)
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
        _no_backward("qmatmul", x)
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
    dtype. Query head h reads KV head h // (H // Hkv); any Sq, Sk. On a
    card, inputs that require grad (with grad enabled) raise."""
    if q.is_cuda:
        _no_backward("flash_attention", q, k, v)
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
    dtype; inputs that require grad (with grad enabled) raise there."""
    if x.is_cuda:
        _no_backward("ssd_chunk_scan", x, dt, A, Bm, Cm, D)
        return ssd.ssd_scan_cuda(
            *(_aligned(a) for a in (
                x, dt.float(), A.float(), Bm.to(x.dtype), Cm.to(x.dtype),
                D.float())), chunk=chunk)
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
        _no_backward("gqa_paged", q, *args[:2])
        fn = pa.gqa_paged_chunk_cuda if chunk else pa.gqa_paged_cuda
    elif q.device.type == "cpu":
        fn = ref.gqa_paged_chunk_ref if chunk else ref.gqa_paged_ref
    else:
        raise _no_kernel("gqa_paged", q.device)
    return fn(q, *args, **kw)


def _block_len(L: int, cap: int) -> int:
    """Of the lengths up to ``min(L, cap)``, the largest divisor of L, so
    rows of L positions reshape in place; where that divisor is under
    half the longest (a prime L), the longest, and the rows are padded
    with masked positions (:func:`_rows_as_arena`)."""
    cap = min(L, cap)
    bl = next(b for b in range(cap, 0, -1) if L % b == 0)
    return bl if 2 * bl >= cap else cap


@functools.lru_cache(maxsize=None)
def contiguous_block_len(L: int, hd: int) -> int:
    """The block length a contiguous GQA row of ``L`` positions at head
    dim ``hd`` is viewed in on the card. The CUDA-core kernel stages a
    whole block in shared memory, so a block is at most
    ``pa.cuda_core_max_block(hd)`` long (Whisper's 1500 encoder frames
    in one block would take ~786 KB at hd 64); :func:`_block_len` picks
    among those (375 at 1500 and hd 64)."""
    return _block_len(L, pa.cuda_core_max_block(hd))


@functools.lru_cache(maxsize=None)
def mla_contiguous_block_len(L: int) -> int:
    """The block length a contiguous latent row of ``L`` positions is
    viewed in on the card: at most the MLA CUDA-core kernel's longest
    block, ``pa.MLA_CORE_MAX_BLOCK`` (64), so either route takes it
    (34 at 544; 64 at a prime L, padded)."""
    return _block_len(L, pa.MLA_CORE_MAX_BLOCK)


def _rows_as_arena(rows, pos: torch.Tensor, bl: int):
    """Contiguous rows ``(B, L, ...)`` and their positions (B, L) as an
    arena of blocks of ``bl`` positions: row b's blocks in table row b,
    in order, each row padded with masked positions (``EMPTY_POS``)
    where ``bl`` does not divide L. Returns (arenas, pos, table)."""
    B, L = pos.shape
    pad = -L % bl
    if pad:
        rows = [torch.cat([a, a.new_zeros(B, pad, *a.shape[2:])], dim=1)
                for a in rows]
        pos = torch.cat([pos, pos.new_full((B, pad), pa.EMPTY_POS)], dim=1)
    n = (L + pad) // bl
    rows = [a.reshape(B * n, bl, *a.shape[2:]) for a in rows]
    table = torch.arange(B * n, dtype=torch.int32,
                         device=pos.device).reshape(B, n)
    return rows, pos, table


def decode_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pos: torch.Tensor, t: torch.Tensor, *,
               table: Optional[torch.Tensor] = None,
               window: int = 0, backend: Optional[str] = None,
               k_scale: Optional[torch.Tensor] = None,
               v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention over slot-pool KV. q: (B, C, H, hd); pos: (B,
    L); t: (B, C) (< 0 = pad row). Returns (B, C, H*hd).

    ``table`` (B, T) (-1 = unassigned): k/v are shared arenas
    (n_blocks, block_len, Hkv, hd) with L = T * block_len. ``table``
    None: k/v are contiguous rows (B, L, Hkv, hd), as the audio
    family's encoder buffer.

    ``backend`` ``gather``/None: the reference over the gathered logical
    view (the rows themselves when contiguous). ``cuda``: single-token
    steps (C == 1) run ``gqa_paged``, C > 1 chunks ``gqa_paged_chunk``;
    contiguous rows go as an arena of :func:`contiguous_block_len`
    blocks (padded with masked positions where that length does not
    divide L), row b's in table row b, in order. ``k_scale``/``v_scale``:
    int8 arena scales (n_blocks, block_len, Hkv), paged layout only."""
    B, C, H, hd = q.shape
    Hkv = k.shape[2]
    if table is None:
        if k_scale is not None or v_scale is not None:
            raise ValueError("decode_gqa: int8 KV scales need the paged "
                             "layout (contiguous rows store bf16, fp8 or "
                             "fp32 directly)")
        if backend != "cuda":
            return pa.gqa_reference(q, k, v, pos, t, window=window)
        (k, v), pos, table = _rows_as_arena(
            (k, v), pos, contiguous_block_len(k.shape[1], hd))
    bl = k.shape[1]
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
        _no_backward("mla_paged", q_abs, *args[:3])
        fn = pa.mla_paged_chunk_cuda if chunk else pa.mla_paged_cuda
    elif q_abs.device.type == "cpu":
        fn = ref.mla_paged_chunk_ref if chunk else ref.mla_paged_ref
    else:
        raise _no_kernel("mla_paged", q_abs.device)
    return fn(q_abs, *args, **kw)


def decode_mla(q_abs: torch.Tensor, q_rope: torch.Tensor, c: torch.Tensor,
               k_rope: torch.Tensor, pos: torch.Tensor, t: torch.Tensor, *,
               scale: float, table: Optional[torch.Tensor] = None,
               backend: Optional[str] = None,
               c_scale: Optional[torch.Tensor] = None,
               kr_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Absorbed-form MLA decode over the latent cache. q_abs: (B, C, H,
    kvr); q_rope: (B, C, H, rope); pos: (B, L); t: (B, C) (< 0 = pad
    row). Returns o_lat (B, C, H, kvr) fp32; the caller applies the
    absorbed value projection.

    ``table`` (B, T) (-1 = unassigned): c/k_rope are the paged pool's
    latent arenas (n_blocks, block_len, kvr|rope), L = T * block_len.
    ``table`` None: c/k_rope are contiguous rows (B, L, kvr|rope), the
    static path's cache.

    ``backend`` ``gather``/None: the reference over the gathered logical
    view (the rows themselves when contiguous). ``cuda``: single-token
    steps (C == 1) run ``mla_paged``, C > 1 chunks ``mla_paged_chunk``;
    contiguous rows go as an arena of :func:`mla_contiguous_block_len`
    blocks (padded with masked positions where that length does not
    divide L), row b's in table row b, in order. ``c_scale``/
    ``kr_scale``: int8 arena scales (n_blocks, block_len), paged layout
    only."""
    B, C, H, kvr = q_abs.shape
    if table is None:
        if c_scale is not None or kr_scale is not None:
            raise ValueError("decode_mla: int8 latent scales need the "
                             "paged layout (contiguous rows store bf16, "
                             "fp8 or fp32 directly)")
        if backend != "cuda":
            return pa.mla_reference(q_abs, q_rope, c, k_rope, pos, t,
                                    scale=scale)
        (c, k_rope), pos, table = _rows_as_arena(
            (c, k_rope), pos, mla_contiguous_block_len(c.shape[1]))
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


def scatter_rows(dst: torch.Tensor, i0: torch.Tensor, i1: torch.Tensor,
                 src: torch.Tensor) -> None:
    """In place ``dst[i0[w], i1[w]] = src[w]`` (cast to dst's dtype):
    ``dst`` (n0, n1, ...); ``i0``, ``i1`` (n,) int64; ``src`` n rows of
    dst's row shape. A write with an index outside ``[0, n0)`` or ``[0,
    n1)`` is dropped, as the reference's ``mode="drop"`` scatter: the
    tick's fixed-shape KV, scale and position writes
    (:func:`repro_torch.kernels.paged_attention.paged_writes`). On fake
    tensors (the dry run's counter), which hold no index to filter by,
    every write lands at its index clamped into range: the same
    ``index_put_`` of all n rows."""
    vals = src.to(dst.dtype).reshape(i0.numel(), *dst.shape[2:])
    if dst.is_cuda:
        _no_backward("scatter_rows", vals)
        return sr.scatter_rows_cuda(dst, i0.contiguous(), i1.contiguous(),
                                    vals.contiguous())
    if is_fake(dst):
        return pa.put_rows(dst, (i0.clamp(0, dst.shape[0] - 1),
                                 i1.clamp(0, dst.shape[1] - 1)), vals)
    if dst.device.type == "cpu":
        return ref.scatter_rows_ref(dst, i0, i1, vals)
    raise _no_kernel("scatter_rows", dst.device)


# ---------------------------------------------------------------------------
# Launch counters

_COUNTED = {"qconv1d_block": qconv1d.qconv1d_block_cuda,
            "qmatmul": qmm.qmatmul_cuda,
            "gqa_paged": pa.gqa_paged_cuda,
            "gqa_paged_chunk": pa.gqa_paged_chunk_cuda,
            "mla_paged": pa.mla_paged_cuda,
            "mla_paged_chunk": pa.mla_paged_chunk_cuda,
            "flash_attention": fa.flash_attention_cuda,
            "ssd_scan": ssd.ssd_scan_cuda,
            "scatter_rows": sr.scatter_rows_cuda}


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
