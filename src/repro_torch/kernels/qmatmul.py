"""Weight-only quantized matmul: the hand-written CUDA kernels
(``csrc/qmatmul.cu``) behind a checked wrapper.

Replaces ``repro/kernels/qmatmul.py:qmatmul_p`` (the Pallas TPU kernel):
``x (M, K) @ w_q (K, N)`` with int8 weights, or int4 packed two per byte
along K, a per-output-column fp32 scale applied after the K sum, fp32
accumulation, output in x's dtype. Two kernels, chosen by :func:`route`:
a tensor-core kernel for bf16 x (the served path; its K splits are the
CTAs of one cluster, planned by :func:`tc_plan`) and a CUDA-core kernel
for fp32 x (planned by :func:`split_k`). The source's header says how
each tiles and what bounds it on the card; the plain version is
:func:`repro_torch.kernels.ref.qmatmul_ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)
SMS = 132                     # H100 SXM streaming multiprocessors
ROUTES = ("tensor_core", "cuda_core")

# the CUDA-core kernel's tiling
MAX_KR = 512                  # x columns per K split, at most
BN = 128                      # columns per thread block

# the tensor-core kernel's tiling (csrc/qmatmul.cu)
TC_BN = 128                   # columns per CTA
TC_KS = 64                    # K splits hold whole multiples of this
TC_MMAX = 64                  # x rows per CTA (more rows: more CTAs)
TC_MAX_SPLITS = 8             # K splits = CTAs of one cluster


def route(dtype: torch.dtype, M: int) -> str:
    """Which kernel ``qmatmul_cuda`` launches: ``tensor_core`` for bf16 x
    at any M (every served projection; M = 4 pads to the mma's 8 rows),
    ``cuda_core`` for fp32 x (the reference's fp32 sum over fp32 x, which
    TF32 would not keep). M does not move the choice: on the card the
    tensor-core kernel is the faster one at M = 4 and at M = 64 alike
    (chip_smoke.py times both)."""
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


def tc_plan(M: int, K: int, N: int) -> tuple:
    """``(kr, splits)`` of the tensor-core kernel: x columns per K split
    (a multiple of 64) and the number of splits (at most 8, one
    cluster), chosen so the (N/128 x M/64 x splits) grid fills at most
    two CTAs per SM (one wave)."""
    tiles = -(-N // TC_BN) * -(-M // TC_MMAX)
    want = max(1, min(TC_MAX_SPLITS, -(-K // TC_KS), 2 * SMS // tiles))
    kr = -(-(-(-K // want)) // TC_KS) * TC_KS
    return kr, -(-K // kr)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("qmatmul")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.qmatmul_launch.argtypes = [vp] * 5 + [ci] * 8 + [vp]
    lib.qmatmul_launch.restype = ci
    lib.qmatmul_smem_bytes.argtypes = [ci, ci]
    lib.qmatmul_smem_bytes.restype = ctypes.c_size_t
    lib.qmatmul_tc_launch.argtypes = [vp] * 4 + [ci] * 7 + [vp]
    lib.qmatmul_tc_launch.restype = ci
    lib.qmatmul_tc_smem_bytes.argtypes = [ci, ci]
    lib.qmatmul_tc_smem_bytes.restype = ctypes.c_size_t
    return lib


def split_k(K: int, N: int) -> tuple:
    """``(kr, splits)`` of the CUDA-core kernel: x columns per K split
    (even, at most ``MAX_KR``) and the number of splits, chosen so the
    (N/128 x splits) grid holds about two thread blocks per SM."""
    tiles = -(-N // BN)
    want = max(1, min(-(-K // 16), -(-2 * SMS // tiles)))
    per = -(-K // want)
    kr = min(MAX_KR, -(-per // 16) * 16)
    return kr, -(-K // kr)


def qmatmul_cuda(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 *, bits: int = 8, path: Optional[str] = None
                 ) -> torch.Tensor:
    """x: (M, K) fp32/bf16 CUDA tensor; w_q: (K, N) int8 (bits=8) or
    (ceil(K/2), N) packed int4 (bits=4); scale: (1, N) fp32. Returns
    (M, N) in x's dtype.

    Launches the kernel that ``path`` names, by default the one
    :func:`route` picks (no fallback between them; the tensor-core
    kernel takes bf16 x only), on the current stream without
    synchronising; counts one launch in ``.launches`` and one on that
    route in ``.routes``."""
    if not x.is_cuda:
        raise ValueError("qmatmul_cuda needs a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise TypeError(f"qmatmul: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if bits not in (4, 8):
        raise ValueError(f"qmatmul: bits must be 4 or 8, got {bits}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError("qmatmul: x must be a contiguous (M, K)")
    M, K = x.shape
    if w_q.ndim != 2 or w_q.dtype != torch.int8 or not w_q.is_contiguous():
        raise ValueError(f"qmatmul: w_q must be a contiguous 2-D int8, got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    N = w_q.shape[1]
    rows = K if bits == 8 else (K + 1) // 2
    if w_q.shape[0] != rows:
        raise ValueError(f"qmatmul: int{bits} w_q for K={K} must have "
                         f"{rows} rows, got {w_q.shape[0]}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (1, N) or \
            not scale.is_contiguous():
        raise ValueError(f"qmatmul: scale must be a contiguous (1, {N}) "
                         f"float32, got {scale.dtype} {tuple(scale.shape)}")
    for name, t in (("w_q", w_q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"qmatmul: {name} is on {t.device}, x on "
                             f"{x.device}")
    path = path or route(x.dtype, M)
    if path not in ROUTES:
        raise ValueError(f"qmatmul: route {path!r} not in {ROUTES}")
    if path == "tensor_core" and x.dtype != torch.bfloat16:
        raise TypeError(f"qmatmul: the tensor-core kernel takes bf16 x, "
                        f"got {x.dtype}")
    if M == 0 or N == 0 or K == 0:      # nothing to launch
        return torch.zeros((M, N), dtype=x.dtype, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _lib()
    if path == "tensor_core":
        kr, splits = tc_plan(M, K, N)
        smem = lib.qmatmul_tc_smem_bytes(bits, min(M, TC_MMAX))
    else:
        kr, splits = split_k(K, N)
        smem = lib.qmatmul_smem_bytes(kr, bits)
    if smem > SMEM_LIMIT:
        raise ValueError(f"qmatmul: {smem} bytes of shared memory "
                         f"(> {SMEM_LIMIT})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "tensor_core":
            vec = int(N % 16 == 0 and K % 8 == 0 and w_q.data_ptr() % 16 == 0
                      and x.data_ptr() % 16 == 0)
            rc = lib.qmatmul_tc_launch(
                x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                out.data_ptr(), M, N, K, bits, kr, splits, vec, stream)
        else:
            part = (torch.empty((splits, M, N), dtype=torch.float32,
                                device=x.device) if splits > 1 else None)
            vec = int(N % 16 == 0 and w_q.data_ptr() % 16 == 0)
            rc = lib.qmatmul_launch(
                x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                out.data_ptr(), part.data_ptr() if part is not None
                else None, M, N, K, bits, kr, splits, vec, _DTYPES[x.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"qmatmul launch failed: CUDA error {rc}")
    _build.count_launch(qmatmul_cuda, "qmatmul", path)
    return out


qmatmul_cuda.launches = 0
qmatmul_cuda.routes = dict.fromkeys(ROUTES, 0)
