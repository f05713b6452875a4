"""Paged-KV decode attention: the index math shared by every read path,
the gather reference, and the hand-written CUDA kernels
(``csrc/paged_attention.cu``) behind checked wrappers.

The port's counterpart of ``repro.kernels.paged_attention``. The serving
pool keeps K/V in shared block arenas ``(n_blocks, block_len, Hkv, hd)``
per layer and a block table ``(B, T)`` per slot (-1 = unassigned). A
cached position participates iff ``pos >= 0 and pos <= t`` and, for ring
groups, ``pos > t - window``; a recycled block is invisible to its new
owner until written, because that owner's ``pos`` row is empty.

Two read paths (``repro_torch.kernels.ops.decode_gqa`` and
``decode_mla`` pick one):

``gather``  :func:`gqa_reference` / :func:`mla_reference` over each
            row's T blocks gathered into a ``(B, T*block_len)`` logical
            view — the reference.
``cuda``    :func:`gqa_paged_cuda` / :func:`mla_paged_cuda` (decode,
            C == 1) and :func:`gqa_paged_chunk_cuda` /
            :func:`mla_paged_chunk_cuda` (chunked prefill, C > 1) read
            the arena in place, one counted launch each; on a CPU tensor
            the same call runs their plain versions in
            :mod:`repro_torch.kernels.ref`, which walk the table exactly
            as the kernels do.

``gqa_paged_cuda`` and ``gqa_paged_chunk_cuda`` each have two kernels,
chosen by dtype and shape (:func:`decode_route`, :func:`chunk_route`):
over bf16, fp8 and int8 arenas (bf16 compute) and fp16 arenas (fp16
compute) a tensor-core kernel that splits the KV walk across warps and
CTAs as :func:`chunk_split_plan` says; over fp32 arenas a CUDA-core
kernel. Each wrapper counts its launches in ``.launches`` and by route
in ``.routes``.

MLA (DeepSeek-V3's latent attention, absorbed form) keeps one latent
``c (n_blocks, block_len, kvr)`` and one rope key ``k_rope (n_blocks,
block_len, rope)`` per cached position, shared by every head.
``mla_paged_cuda`` and ``mla_paged_chunk_cuda`` likewise have two
kernels (``csrc/mla_paged_attention.cu``), chosen by :func:`mla_route`:
over bf16, fp16, fp8 and int8 latent arenas a tensor-core kernel that
splits the decode's walk across a cluster as :func:`mla_split_plan`
says; over fp32 arenas a CUDA-core kernel.

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


def mla_compute_dtype(arena_dtype: torch.dtype) -> torch.dtype:
    """The latent kernels' QK/PV input dtype (``_mla_kernel``): the
    arena's own dtype, fp8 included; bf16 for int8, which dequantizes
    to bf16."""
    return torch.bfloat16 if arena_dtype == torch.int8 else arena_dtype


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


def mla_reference(q_abs: torch.Tensor, q_rope: torch.Tensor,
                  c_read: torch.Tensor, kr_read: torch.Tensor,
                  pos: torch.Tensor, t: torch.Tensor, *,
                  scale: float) -> torch.Tensor:
    """Masked-dense absorbed MLA over a logical latent view. q_abs: (B, C,
    H, kvr); q_rope: (B, C, H, rope); c_read: (B, L, kvr); kr_read: (B,
    L, rope) (int8 already dequantized to bf16); pos: (B, L); t: (B,
    C). Returns o_lat (B, C, H, kvr) fp32. As the reference's einsums:
    q_rope and the probabilities rounded to the latent views' dtypes,
    q_abs taken as it comes, fp32 scores and products."""
    s = torch.einsum("bchr,blr->bchl", q_abs.float(), c_read.float())
    s = s + torch.einsum("bchp,blp->bchl",
                         q_rope.to(kr_read.dtype).float(), kr_read.float())
    s = s * scale
    valid = valid_mask(pos, t)
    s = torch.where(valid[:, :, None, :], s, torch.full_like(s, NEG_INF))
    prob = torch.softmax(s, dim=-1)
    return torch.einsum("bchl,blr->bchr", prob.to(c_read.dtype).float(),
                        c_read.float())


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/paged_attention.cu)

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
              torch.int8: 3, torch.float16: 4}
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


def _check(name, t, dtype, shape, device, kernel="gqa_paged"):
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, q on "
                         f"{device}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def _checked(q: torch.Tensor, k, v, pos, t, table, k_scale, v_scale):
    """Validate one launch's operands; returns (B, C, H, hd, bl, Hkv,
    T, quantized)."""
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
    return B, C, H, hd, bl, Hkv, T, quantized


def _launch(q: torch.Tensor, k, v, pos, t, table, window, k_scale,
            v_scale) -> torch.Tensor:
    """One launch of the CUDA-core kernel over q (B, C, H, hd); t (B,
    C). Returns (B, C, H, hd)."""
    B, C, H, hd, bl, Hkv, T, quantized = _checked(q, k, v, pos, t, table,
                                                  k_scale, v_scale)
    lib = _lib()
    if hd > lib.gqa_paged_max_head_dim():
        raise ValueError(f"gqa_paged: head_dim {hd} > "
                         f"{lib.gqa_paged_max_head_dim()}")
    smem = lib.gqa_paged_smem_bytes(C * (H // Hkv), bl, hd)
    if smem > SMEM_LIMIT:
        raise ValueError(f"gqa_paged: block_len {bl}, head_dim {hd} need "
                         f"{smem} bytes of shared memory (> {SMEM_LIMIT})")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
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


# ---------------------------------------------------------------------------
# The tensor-core kernel (decode and chunk) and its split plan

CHUNK_STEP = 16        # cached positions per mma step
CHUNK_WARPS = 4        # warps of a CTA, each walking every 4th step
CHUNK_MAX_STEPS = 64   # steps a CTA stages the positions of (1024)
CHUNK_MAX_STAGES = 4   # cp.async ring depth a warp (head dim <= 128)
SMS = 132              # H100 SXM streaming multiprocessors


class ChunkPlan(NamedTuple):
    """How the tensor-core kernel (decode and chunk) cuts its work:
    ``row_tiles`` of 16 query rows, ``steps`` of 16 logical positions
    over the table, ``splits`` CTAs per (batch row, KV head, row tile),
    each walking ``per`` consecutive steps, each warp with a ring of
    ``stages`` steps' copies in flight."""
    row_tiles: int
    steps: int
    splits: int
    per: int
    stages: int


def chunk_split_plan(B: int, Hkv: int, R: int, T: int, block_len: int,
                     *, hd: int = 128) -> ChunkPlan:
    """The split of the KV walk that the card runs, from shapes alone.
    A table short enough that every warp's steps fit its ring at once
    (head dim up to 128) is walked by one CTA per row tile with all its
    copies in flight, and needs no combine across CTAs. Otherwise, where
    B * Hkv * row_tiles CTAs leave the card's SMs short (fewer than two
    CTAs each), the steps are split across CTAs too, as long as every
    warp of a CTA keeps a step, with a 2-stage ring; no CTA takes more
    than ``CHUNK_MAX_STEPS``; no split is empty."""
    row_tiles = -(-R // 16)
    steps = max(1, -(-(T * block_len) // CHUNK_STEP))
    per_warp = -(-steps // CHUNK_WARPS)
    if per_warp <= CHUNK_MAX_STAGES and hd <= 128:
        return ChunkPlan(row_tiles, steps, 1, steps, per_warp)
    base = B * Hkv * row_tiles
    splits = max(1, min(-(-2 * SMS // base), steps // CHUNK_WARPS))
    splits = max(splits, -(-steps // CHUNK_MAX_STEPS))
    per = -(-steps // splits)
    return ChunkPlan(row_tiles, steps, -(-steps // per), per, 2)


def chunk_shares(plan: ChunkPlan, split: int, warp: int) -> range:
    """The steps that warp ``warp`` of split ``split`` walks: every
    ``CHUNK_WARPS``-th of the split's range, from its own offset."""
    start = split * plan.per
    return range(start + warp, min(plan.steps, start + plan.per),
                 CHUNK_WARPS)


def decode_route(kv_dtype: torch.dtype, hd: int) -> str:
    """Which kernel ``gqa_paged_cuda`` (C == 1) launches, by dtype and
    shape: ``tensor_core`` over an arena whose compute dtype is bf16
    (bf16, fp8, int8) or fp16 at a head dim that is a multiple of 16 up
    to 256; ``cuda_core`` otherwise (fp32 arenas, other head dims)."""
    if compute_dtype(kv_dtype) in (torch.bfloat16, torch.float16) and \
            hd % 16 == 0 and 16 <= hd <= 256:
        return "tensor_core"
    return "cuda_core"


def chunk_route(kv_dtype: torch.dtype, C: int, hd: int) -> str:
    """Which kernel ``gqa_paged_chunk_cuda`` launches: :func:`decode_route`
    for C > 1; ``cuda_core`` for a chunk of one token."""
    return decode_route(kv_dtype, hd) if C > 1 else "cuda_core"


@functools.cache
def _tc_lib() -> ctypes.CDLL:
    lib = _lib()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gqa_paged_chunk_tc_launch.argtypes = (
        [vp] * 10 + [ci] * 8 + [ctypes.c_float] + [ci] * 5 + [vp])
    lib.gqa_paged_chunk_tc_launch.restype = ci
    lib.gqa_paged_chunk_tc_smem_bytes.argtypes = [ci, ci, ci, ci]
    lib.gqa_paged_chunk_tc_smem_bytes.restype = ctypes.c_size_t
    lib.gqa_paged_chunk_tc_max_steps.argtypes = []
    lib.gqa_paged_chunk_tc_max_steps.restype = ci
    return lib


def _launch_tc(q: torch.Tensor, k, v, pos, t, table, window, k_scale,
               v_scale) -> torch.Tensor:
    """One launch of the tensor-core kernel (and, when the plan splits
    the walk across CTAs, its combine) over q (B, C, H, hd), C >= 1.
    Returns (B, C, H, hd)."""
    B, C, H, hd, bl, Hkv, T, quantized = _checked(q, k, v, pos, t, table,
                                                  k_scale, v_scale)
    kernel = "gqa_paged" if C == 1 else "gqa_paged_chunk"
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")
    lib = _tc_lib()
    plan = chunk_split_plan(B, Hkv, C * (H // Hkv), T, bl, hd=hd)
    if plan.per > lib.gqa_paged_chunk_tc_max_steps():
        raise ValueError(f"{kernel}: plan {plan} exceeds the kernel's "
                         f"steps per CTA")
    smem = lib.gqa_paged_chunk_tc_smem_bytes(hd, k.element_size(), plan.per,
                                             plan.stages)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{kernel}: head_dim {hd} needs {smem} bytes of "
                         f"shared memory (> {SMEM_LIMIT})")
    out = torch.empty_like(q)
    ws = (torch.empty(B * Hkv * plan.row_tiles * plan.splits * 16
                      * (hd + 2), dtype=torch.float32, device=q.device)
          if plan.splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gqa_paged_chunk_tc_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None, pos.data_ptr(),
            t.data_ptr(), table.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, B, C, H, Hkv, hd, bl,
            T, int(window), float(hd ** -0.5), _Q_DTYPES[q.dtype],
            _KV_DTYPES[k.dtype], plan.splits, plan.per, plan.stages, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")
    return out


def gqa_paged_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pos: torch.Tensor, t: torch.Tensor, table: torch.Tensor,
                   *, window: int = 0,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token paged decode (replaces ``gqa_paged_p``). q: (B, Hkv,
    group, hd); k/v: arenas (n_blocks, block_len, Hkv, hd) fp32/bf16/
    fp16/fp8/int8 (+ fp32 scale arenas (n_blocks, block_len, Hkv) for
    int8); pos: (B, T*block_len) int32; t: (B,) int32; table: (B, T)
    int32. Returns (B, Hkv, group, hd) in q's dtype. Launches the kernel
    that :func:`decode_route` names (no fallback between them) on the
    current stream without synchronising; counts one launch and one on
    that route."""
    B, Hkv, group, hd = q.shape
    route = decode_route(k.dtype, hd)
    fn = _launch_tc if route == "tensor_core" else _launch
    out = fn(q.reshape(B, 1, Hkv * group, hd), k, v, pos, t.reshape(B, 1),
             table, window, k_scale, v_scale)
    gqa_paged_cuda.launches += 1
    gqa_paged_cuda.routes[route] += 1
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
    (B, C, H*hd) in q's dtype. Launches the kernel that
    :func:`chunk_route` names for the arena's dtype and the shape (no
    fallback between them); counts one launch and one on that route."""
    B, C, H, hd = q.shape
    route = chunk_route(k.dtype, C, hd)
    fn = _launch_tc if route == "tensor_core" else _launch
    out = fn(q, k, v, pos, t, table, window, k_scale, v_scale)
    gqa_paged_chunk_cuda.launches += 1
    gqa_paged_chunk_cuda.routes[route] += 1
    return out.reshape(B, C, H * hd)


ROUTES = ("tensor_core", "cuda_core")
gqa_paged_cuda.launches = 0
gqa_paged_chunk_cuda.launches = 0
gqa_paged_cuda.routes = dict.fromkeys(ROUTES, 0)
gqa_paged_chunk_cuda.routes = dict.fromkeys(ROUTES, 0)


# ---------------------------------------------------------------------------
# MLA CUDA kernels (csrc/mla_paged_attention.cu): the tensor-core kernel
# (decode and chunk) and its split plan; the CUDA-core kernel for fp32

MLA_STEP = 32          # cached positions per mma step
MLA_GROUP = 16         # query rows of a row group (4 warps)
MLA_MAX_STEPS = 64     # steps a CTA stages the positions of (2048)
MLA_MAX_SPLITS = 8     # CTAs of a split walk: one cluster (portable size)
MLA_SPLIT_CTAS = 80    # CTAs of a split walk's grid (clusters at once)


class MlaPlan(NamedTuple):
    """How the MLA tensor-core kernel cuts its work: CTAs of ``groups``
    row groups (16 query rows each), ``steps`` of 32 logical positions
    over the table, ``splits`` CTAs (one cluster) a row tile of 16 *
    groups rows, split s walking steps [s * per, (s + 1) * per) through
    a ring of ``stages``, one online-softmax update every ``sub``
    positions."""
    groups: int
    steps: int
    splits: int
    per: int
    stages: int
    sub: int


def mla_split_plan(B: int, R: int, T: int, block_len: int, *,
                   exact: bool = False) -> MlaPlan:
    """The split of the MLA walk that the card runs, from shapes alone.
    Where B * row_tiles CTAs of 64 query rows (4 row groups) fill half
    the card, as the chunk's do (R = C * H = 2048 at deepseek-v3's
    widths: 128 CTAs), the walk is not split (its partials would be
    fp32 o_lat-sized) unless the table outgrows ``MLA_MAX_STEPS``.
    Otherwise (the decode, R = H) the walk splits over up to
    ``MLA_MAX_SPLITS`` CTAs of one cluster, at most ``MLA_SPLIT_CTAS``
    CTAs in all (more clusters of 8 do not run at once), in CTAs of 32
    or 64 rows, whichever leaves a CTA fewer steps (32 on a tie); no
    split is empty. A 3-stage ring where a CTA walks 3 or more steps
    and its positions' rows fit beside it (at most 16 steps of 64
    rows), else 2 stages. One softmax update a step; ``exact`` (fp8
    arenas: block_len 16 or 32) keeps the reference's walk instead, one
    update an arena block and no split, because p rounded to e4m3 (3
    mantissa bits) depends on the running max it is taken against."""
    steps = max(1, -(-(T * block_len) // MLA_STEP))
    need = -(-steps // MLA_MAX_STEPS)
    if exact and (need > 1 or block_len not in (16, MLA_STEP)):
        raise ValueError(f"mla_paged: the reference's walk over "
                         f"{T} blocks of {block_len} does not fit one CTA "
                         f"of {MLA_MAX_STEPS} steps of {MLA_STEP}")
    if need > MLA_MAX_SPLITS:
        raise ValueError(f"mla_paged: {T * block_len} positions need "
                         f"{need} splits of {MLA_MAX_STEPS} steps "
                         f"(> {MLA_MAX_SPLITS})")

    def tiles(g):
        return -(-R // (MLA_GROUP * g))

    def splits_for(g):
        if exact:
            return 1
        cap = max(1, MLA_SPLIT_CTAS // (B * tiles(g)))
        return max(need, min(MLA_MAX_SPLITS, steps, cap))
    if B * tiles(4) >= SMS // 2:
        groups, splits = 4, need
    else:
        groups = min((2, 4), key=lambda g: -(-steps // splits_for(g)))
        splits = splits_for(groups)
    per = -(-steps // splits)
    stages = 3 if 3 <= per and (groups == 2 or per <= 16) else 2
    return MlaPlan(groups, steps, -(-steps // per), per, stages,
                   block_len if exact else MLA_STEP)


def mla_route(kv_dtype: torch.dtype, kvr: int, rope: int,
              block_len: int = 16, positions: int = 0) -> str:
    """Which kernel ``mla_paged_cuda`` and ``mla_paged_chunk_cuda``
    launch, by dtype and shape: ``tensor_core`` over bf16, fp16, fp8 and
    int8 arenas at a latent width that is a multiple of 64 and a rope
    width that is a multiple of 16 from 16, together at most 576 (what
    a CTA's shared memory holds; deepseek-v3: 512 and 64), for tables of
    up to ``MLA_MAX_SPLITS * MLA_MAX_STEPS`` steps of positions; fp8 at
    block_len 16 or 32 and up to ``MLA_MAX_STEPS`` steps (the kernel
    then keeps the reference's per-block softmax in one CTA,
    :func:`mla_split_plan`); ``cuda_core`` otherwise (fp32 arenas, other
    widths, longer tables)."""
    fp8 = kv_dtype == torch.float8_e4m3fn
    steps = MLA_MAX_STEPS * (1 if fp8 else MLA_MAX_SPLITS)
    if kv_dtype in (torch.bfloat16, torch.float16, torch.float8_e4m3fn,
                    torch.int8) and kvr % 64 == 0 and 64 <= kvr \
            and rope % 16 == 0 and 16 <= rope and kvr + rope <= 576 \
            and positions <= steps * MLA_STEP \
            and (not fp8 or block_len in (16, 32)):
        return "tensor_core"
    return "cuda_core"


@functools.cache
def _mla_lib() -> ctypes.CDLL:
    lib = _build.load("mla_paged_attention")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mla_paged_launch.argtypes = ([vp] * 10 + [ci] * 7 + [ctypes.c_float]
                                     + [ci, ci, vp])
    lib.mla_paged_launch.restype = ci
    lib.mla_paged_smem_bytes.argtypes = [ci, ci, ci]
    lib.mla_paged_smem_bytes.restype = ctypes.c_size_t
    lib.mla_paged_tc_launch.argtypes = ([vp] * 10 + [ci] * 7
                                        + [ctypes.c_float] + [ci] * 7 + [vp])
    lib.mla_paged_tc_launch.restype = ci
    lib.mla_paged_tc_smem_bytes.argtypes = [ci] * 6
    lib.mla_paged_tc_smem_bytes.restype = ctypes.c_size_t
    for name in ("mla_paged_max_kvr", "mla_paged_max_rope",
                 "mla_paged_max_block_len"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ci
    return lib


def _mla_launch(q_abs: torch.Tensor, q_rope, c, kr, pos, t, table, scale,
                c_scale, kr_scale, path: Optional[str],
                name: str) -> tuple:
    """One launch over q_abs (B, C, H, kvr), q_rope (B, C, H, rope); t
    (B, C), on the kernel ``path`` names (default :func:`mla_route`'s).
    Returns (o_lat (B, C, H, kvr) fp32, the route taken)."""
    if not q_abs.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors")
    if q_abs.dtype not in _Q_DTYPES:
        raise TypeError(f"{name}: q_abs must be float32 or bfloat16, got "
                        f"{q_abs.dtype}")
    if q_abs.ndim != 4 or not q_abs.is_contiguous():
        raise ValueError(f"{name}: q_abs must be a contiguous (B, C, H, kvr)")
    B, C, H, kvr = q_abs.shape
    if c.ndim != 3 or c.dtype not in _KV_DTYPES:
        raise TypeError(f"{name}: latent arena must be (n_blocks, "
                        f"block_len, kvr) in {list(_KV_DTYPES)}, got "
                        f"{c.dtype} {tuple(c.shape)}")
    nb, bl = c.shape[:2]
    rd = kr.shape[-1] if kr.ndim == 3 else -1
    T = table.shape[-1]
    dev = q_abs.device
    _check("q_rope", q_rope, q_abs.dtype, (B, C, H, rd), dev, name)
    _check("c", c, None, (nb, bl, kvr), dev, name)
    _check("k_rope", kr, c.dtype, (nb, bl, rd), dev, name)
    _check("pos", pos, torch.int32, (B, T * bl), dev, name)
    _check("t", t, torch.int32, (B, C), dev, name)
    _check("table", table, torch.int32, (B, T), dev, name)
    quantized = c.dtype == torch.int8
    if quantized != (c_scale is not None) or (c_scale is None) != \
            (kr_scale is None):
        raise ValueError(f"{name}: int8 arenas need c_scale and kr_scale, "
                         f"float arenas neither")
    if quantized:
        _check("c_scale", c_scale, torch.float32, (nb, bl), dev, name)
        _check("kr_scale", kr_scale, torch.float32, (nb, bl), dev, name)
    path = path or mla_route(c.dtype, kvr, rd, bl, T * bl)
    if path not in ROUTES:
        raise ValueError(f"{name}: route {path!r} not in {ROUTES}")
    lib = _mla_lib()
    if path == "tensor_core":
        if mla_route(c.dtype, kvr, rd, bl, T * bl) != "tensor_core":
            raise ValueError(f"{name}: the tensor-core kernel does not take "
                             f"a {c.dtype} arena at kvr {kvr}, rope {rd}, "
                             f"{T} blocks of {bl}")
        for n, a in (("q_abs", q_abs), ("q_rope", q_rope), ("c", c),
                     ("k_rope", kr)):
            if a.data_ptr() % 16:
                raise ValueError(f"{name}: {n} must be 16-byte aligned")
        plan = mla_split_plan(B, C * H, T, bl,
                              exact=c.dtype == torch.float8_e4m3fn)
        smem = lib.mla_paged_tc_smem_bytes(plan.groups, kvr, rd,
                                           c.element_size(), plan.per,
                                           plan.stages)
    else:
        limits = (lib.mla_paged_max_kvr(), lib.mla_paged_max_rope(),
                  lib.mla_paged_max_block_len())
        if kvr > limits[0] or rd > limits[1] or bl > limits[2] or kvr % 4 \
                or rd % 4:
            raise ValueError(f"{name}: kvr {kvr}, rope {rd}, block_len "
                             f"{bl} exceed the kernel's {limits} or are not "
                             f"multiples of 4")
        smem = lib.mla_paged_smem_bytes(bl, kvr, rd)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: needs {smem} bytes of shared memory "
                         f"(> {SMEM_LIMIT})")
    out = torch.empty((B, C, H, kvr), dtype=torch.float32, device=dev)
    args = (q_abs.data_ptr(), q_rope.data_ptr(), c.data_ptr(), kr.data_ptr(),
            c_scale.data_ptr() if quantized else None,
            kr_scale.data_ptr() if quantized else None, pos.data_ptr(),
            t.data_ptr(), table.data_ptr(), out.data_ptr(), B, C, H, kvr,
            rd, bl, T, float(scale), _Q_DTYPES[q_abs.dtype],
            _KV_DTYPES[c.dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "tensor_core":
            rc = lib.mla_paged_tc_launch(*args, plan.groups, plan.splits,
                                         plan.per, plan.stages, plan.sub,
                                         stream)
        else:
            rc = lib.mla_paged_launch(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out, path


def mla_paged_cuda(q_abs: torch.Tensor, q_rope: torch.Tensor,
                   c: torch.Tensor, kr: torch.Tensor, pos: torch.Tensor,
                   t: torch.Tensor, table: torch.Tensor, *, scale: float,
                   c_scale: Optional[torch.Tensor] = None,
                   kr_scale: Optional[torch.Tensor] = None,
                   path: Optional[str] = None) -> torch.Tensor:
    """Single-token paged absorbed-MLA decode (replaces ``mla_paged_p``).
    q_abs: (B, H, kvr); q_rope: (B, H, rope), fp32 or bf16 (one dtype);
    c/kr: latent arenas (n_blocks, block_len, kvr|rope) fp32/bf16/fp16/
    fp8/int8 (+ fp32 per-token scale arenas (n_blocks, block_len) for
    int8); pos: (B, T*block_len) int32; t: (B,) int32; table: (B, T)
    int32. Returns o_lat (B, H, kvr) fp32. Launches the kernel that
    ``path`` names, by default the one :func:`mla_route` picks (no
    fallback between them; ``path`` is for timing), on the current
    stream without synchronising; counts one launch in ``.launches``
    and one on that route in ``.routes``."""
    B, H, kvr = q_abs.shape
    out, route = _mla_launch(q_abs.reshape(B, 1, H, kvr),
                             q_rope.reshape(B, 1, H, q_rope.shape[-1]), c,
                             kr, pos, t.reshape(B, 1), table, scale, c_scale,
                             kr_scale, path, "mla_paged")
    mla_paged_cuda.launches += 1
    mla_paged_cuda.routes[route] += 1
    return out.reshape(B, H, kvr)


def mla_paged_chunk_cuda(q_abs: torch.Tensor, q_rope: torch.Tensor,
                         c: torch.Tensor, kr: torch.Tensor,
                         pos: torch.Tensor, t: torch.Tensor,
                         table: torch.Tensor, *, scale: float,
                         c_scale: Optional[torch.Tensor] = None,
                         kr_scale: Optional[torch.Tensor] = None,
                         path: Optional[str] = None) -> torch.Tensor:
    """C > 1 chunked prefill over the latent arena (replaces
    ``mla_paged_chunk_p``). q_abs: (B, C, H, kvr); q_rope: (B, C, H,
    rope); t: (B, C) per-query positions (< 0 = pad); the rest as
    :func:`mla_paged_cuda`. Returns o_lat (B, C, H, kvr) fp32; counts
    one launch and one on its route."""
    out, route = _mla_launch(q_abs, q_rope, c, kr, pos, t, table, scale,
                             c_scale, kr_scale, path, "mla_paged_chunk")
    mla_paged_chunk_cuda.launches += 1
    mla_paged_chunk_cuda.routes[route] += 1
    return out


mla_paged_cuda.launches = 0
mla_paged_chunk_cuda.launches = 0
mla_paged_cuda.routes = dict.fromkeys(ROUTES, 0)
mla_paged_chunk_cuda.routes = dict.fromkeys(ROUTES, 0)
