"""Paged-KV decode attention: the index math shared by every read path,
the gather reference, and the hand-written CUDA kernels
(``csrc/paged_attention.cu``) behind checked wrappers.

The port's counterpart of ``repro.kernels.paged_attention``. The serving
pool keeps K/V in shared block arenas ``(n_blocks, block_len, Hkv, hd)``
per layer and a block table ``(B, T)`` per slot (-1 = unassigned). A
cached position participates iff ``pos >= 0 and pos <= t`` and, for ring
groups, ``pos > t - window``; a recycled block is invisible to its new
owner until written, because that owner's ``pos`` row is empty.

Two read paths (``repro_torch.kernels.ops.decode_gqa`` picks one):

``gather``  :func:`gqa_reference` over each row's T blocks gathered into
            a ``(B, T*block_len)`` logical view — the reference.
``cuda``    :func:`gqa_paged_cuda` (decode, C == 1) and
            :func:`gqa_paged_chunk_cuda` (chunked prefill, C > 1) read the
            arena in place, one CUDA launch each; on a CPU tensor the
            same call runs their plain versions in
            :mod:`repro_torch.kernels.ref`, which walk the table exactly
            as the kernels do.

Rows with no valid position (pad rows, ``t < 0``) are garbage in every
path; callers ignore them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

# "no token cached here" — also what pads per-row positions of idle slots
EMPTY_POS = -(10 ** 9)

QSCALE_MIN = 1e-8      # int8 scale floor: an all-zero vector stays 0


# ---------------------------------------------------------------------------
# Shared index math (paged scatter/gather)


def paged_indices(table: torch.Tensor, t: torch.Tensor, n_blocks: int,
                  block_len: int):
    """table: (B, T) int32 (-1 = unassigned); t: (B, C) positions (< 0 =
    pad). Returns ``(wblk, off, lw, gidx, Leff)`` as the reference does:
    arena block and in-block offset of each token's KV write (``wblk ==
    n_blocks`` marks a dropped write: pad token or unassigned block),
    the pos write column ``lw`` in lockstep (``Leff`` = dropped), the
    clamped (B, T) gather indices and ``Leff = T * block_len``."""
    B, T = table.shape
    Leff = T * block_len
    t = t.long()
    l = torch.where(t >= 0, t % Leff, torch.full_like(t, Leff))
    col = torch.clamp(torch.div(l, block_len, rounding_mode="floor"),
                      max=T - 1)
    blk = torch.gather(table.long(), 1, col)
    wblk = torch.where((t >= 0) & (blk >= 0), blk,
                       torch.full_like(blk, n_blocks))
    lw = torch.where(wblk < n_blocks, l, torch.full_like(l, Leff))
    return wblk, l % block_len, lw, torch.clamp(table.long(), min=0), Leff


class PagedWrites(NamedTuple):
    """The KV/pos writes of one tick that land (dropped ones filtered
    out): the token's batch row ``b`` and column ``c``, its arena block
    ``blk`` and offset ``off``, and its pos column ``lw``."""
    b: torch.Tensor
    c: torch.Tensor
    blk: torch.Tensor
    off: torch.Tensor
    lw: torch.Tensor

    def to(self, device) -> "PagedWrites":
        return PagedWrites(*(a.to(device, non_blocking=True) for a in self))


def paged_writes(table: torch.Tensor, t: torch.Tensor, n_blocks: int,
                 block_len: int) -> PagedWrites:
    """:func:`paged_indices` with the dropped writes (``wblk ==
    n_blocks``, ``lw == Leff``) filtered out, so ``index_put_`` never
    sees an out-of-range index (a device assert on CUDA). Boolean
    filtering reads the mask on the host: called with host (CPU)
    ``table``/``t``, as the serving runner does once per tick and
    group, it costs no device synchronisation."""
    wblk, off, lw, _, _ = paged_indices(table, t, n_blocks, block_len)
    b, c = torch.nonzero(wblk < n_blocks, as_tuple=True)
    return PagedWrites(b, c, wblk[b, c], off[b, c], lw[b, c])


def valid_mask(pos: torch.Tensor, t: torch.Tensor,
               window: int = 0) -> torch.Tensor:
    """(B, C, L) participation mask of cached ``pos`` (B, L) for query
    positions ``t`` (B, C)."""
    p, tq = pos[:, None, :], t[:, :, None]
    valid = (p >= 0) & (p <= tq)
    if window > 0:
        valid &= p > tq - window
    return valid


# ---------------------------------------------------------------------------
# int8 arena quantization (one rounding rule for the write path, the
# kernels and the reference)


def quantize_kv(x: torch.Tensor, axis: int = -1):
    """Symmetric per-vector int8 over ``axis``: ``(q int8, scale fp32)``
    with ``axis`` dropped from the scale's shape."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=axis) / 127.0, QSCALE_MIN)
    q = torch.clamp(torch.round(xf / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: fp32 multiply, then the cast to
    the compute dtype (bf16 for 1-byte arenas). Every path dequantizes
    through this expression."""
    return (q.float() * scale.float().unsqueeze(axis)).to(dtype)


def _bytes_view(a: torch.Tensor) -> torch.Tensor:
    """fp8 tensors as their raw bytes: indexing kernels cover the integer
    types on every device, fp8 not everywhere."""
    return a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a


def take_blocks(arena: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arena[idx]`` (a gather of whole arena blocks) for any dtype."""
    return _bytes_view(arena)[idx].view(arena.dtype)


def put_rows(arena: torch.Tensor, idx, vals: torch.Tensor) -> None:
    """In place ``arena[idx] = vals`` (cast to the arena's dtype)."""
    _bytes_view(arena).index_put_(idx, _bytes_view(vals.to(arena.dtype)))


def compute_dtype(arena_dtype: torch.dtype) -> torch.dtype:
    """QK/PV input dtype: bf16 for 1-byte arenas (fp8, int8), else the
    arena's own dtype."""
    return torch.bfloat16 if arena_dtype.itemsize == 1 else arena_dtype


# ---------------------------------------------------------------------------
# Gather reference


def gqa_reference(q: torch.Tensor, k_read: torch.Tensor,
                  v_read: torch.Tensor, pos: torch.Tensor, t: torch.Tensor,
                  *, window: int = 0) -> torch.Tensor:
    """Masked-dense GQA over a logical (B, L, Hkv, hd) view. q: (B, C, H,
    hd); pos: (B, L); t: (B, C). Returns (B, C, H*hd) in q's dtype.
    Inputs in the compute dtype, fp32 scores and products."""
    B, C, H, hd = q.shape
    Hkv = k_read.shape[2]
    group = H // Hkv
    cdt = compute_dtype(k_read.dtype)
    qg = q.reshape(B, C, Hkv, group, hd).to(cdt).float()
    s = torch.einsum("bckgd,blkd->bckgl", qg,
                     k_read.to(cdt).float()) * (hd ** -0.5)
    valid = valid_mask(pos, t, window)
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bckgl,blkd->bckgd", prob.to(cdt).float(),
                     v_read.to(cdt).float()).to(q.dtype)
    return o.reshape(B, C, H * hd)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/paged_attention.cu)

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
              torch.int8: 3}
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gqa_paged_launch.argtypes = ([vp] * 9 + [ci] * 8 + [ctypes.c_float]
                                     + [ci, ci, vp])
    lib.gqa_paged_launch.restype = ci
    lib.gqa_paged_smem_bytes.argtypes = [ci, ci, ci]
    lib.gqa_paged_smem_bytes.restype = ctypes.c_size_t
    lib.gqa_paged_max_head_dim.argtypes = []
    lib.gqa_paged_max_head_dim.restype = ci
    return lib


def _check(name, t, dtype, shape, device):
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"gqa_paged: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"gqa_paged: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"gqa_paged: {name} is on {t.device}, q on "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"gqa_paged: {name} must be contiguous")


def _launch(q: torch.Tensor, k, v, pos, t, table, window, k_scale,
            v_scale) -> torch.Tensor:
    """One launch over q (B, C, H, hd); t (B, C). Returns (B, C, H, hd)."""
    if not q.is_cuda:
        raise ValueError("gqa_paged: the CUDA kernel needs CUDA tensors")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"gqa_paged: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.ndim != 4 or not q.is_contiguous():
        raise ValueError("gqa_paged: q must be a contiguous (B, C, H, hd)")
    B, C, H, hd = q.shape
    if k.ndim != 4 or k.dtype not in _KV_DTYPES:
        raise TypeError(f"gqa_paged: arena must be (n_blocks, block_len, "
                        f"Hkv, hd) in {list(_KV_DTYPES)}, got "
                        f"{k.dtype} {tuple(k.shape)}")
    nb, bl, Hkv = k.shape[:3]
    if H % Hkv:
        raise ValueError(f"gqa_paged: {H} query heads over {Hkv} KV heads")
    T = table.shape[-1]
    dev = q.device
    _check("k", k, None, (nb, bl, Hkv, hd), dev)
    _check("v", v, k.dtype, (nb, bl, Hkv, hd), dev)
    _check("pos", pos, torch.int32, (B, T * bl), dev)
    _check("t", t, torch.int32, (B, C), dev)
    _check("table", table, torch.int32, (B, T), dev)
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != \
            (v_scale is None):
        raise ValueError("gqa_paged: int8 arenas need k_scale and v_scale, "
                         "float arenas neither")
    if quantized:
        _check("k_scale", k_scale, torch.float32, (nb, bl, Hkv), dev)
        _check("v_scale", v_scale, torch.float32, (nb, bl, Hkv), dev)
    lib = _lib()
    if hd > lib.gqa_paged_max_head_dim():
        raise ValueError(f"gqa_paged: head_dim {hd} > "
                         f"{lib.gqa_paged_max_head_dim()}")
    smem = lib.gqa_paged_smem_bytes(C * (H // Hkv), bl, hd)
    if smem > SMEM_LIMIT:
        raise ValueError(f"gqa_paged: block_len {bl}, head_dim {hd} need "
                         f"{smem} bytes of shared memory (> {SMEM_LIMIT})")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gqa_paged_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None, pos.data_ptr(),
            t.data_ptr(), table.data_ptr(), out.data_ptr(), B, C, H, Hkv,
            hd, bl, T, int(window), float(hd ** -0.5), _Q_DTYPES[q.dtype],
            _KV_DTYPES[k.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"gqa_paged launch failed: CUDA error {rc}")
    return out


def gqa_paged_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pos: torch.Tensor, t: torch.Tensor, table: torch.Tensor,
                   *, window: int = 0,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token paged decode (replaces ``gqa_paged_p``). q: (B, Hkv,
    group, hd); k/v: arenas (n_blocks, block_len, Hkv, hd) fp32/bf16/
    fp8/int8 (+ fp32 scale arenas (n_blocks, block_len, Hkv) for int8);
    pos: (B, T*block_len) int32; t: (B,) int32; table: (B, T) int32.
    Returns (B, Hkv, group, hd) in q's dtype. Launches on the current
    stream without synchronising; counts one launch."""
    B, Hkv, group, hd = q.shape
    out = _launch(q.reshape(B, 1, Hkv * group, hd), k, v, pos,
                  t.reshape(B, 1), table, window, k_scale, v_scale)
    gqa_paged_cuda.launches += 1
    return out.reshape(B, Hkv, group, hd)


def gqa_paged_chunk_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor, t: torch.Tensor,
                         table: torch.Tensor, *, window: int = 0,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """C > 1 chunked prefill over the arena (replaces
    ``gqa_paged_chunk_p``). q: (B, C, H, hd); t: (B, C) per-query
    positions (< 0 = pad); the rest as :func:`gqa_paged_cuda`. Returns
    (B, C, H*hd) in q's dtype; counts one launch."""
    B, C, H, hd = q.shape
    out = _launch(q, k, v, pos, t, table, window, k_scale, v_scale)
    gqa_paged_chunk_cuda.launches += 1
    return out.reshape(B, C, H * hd)


gqa_paged_cuda.launches = 0
gqa_paged_chunk_cuda.launches = 0
