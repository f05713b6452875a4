"""Quantized separable conv-1D block: the hand-written CUDA kernels
(``csrc/qconv1d.cu``) behind a checked wrapper.

Replaces ``repro/kernels/qconv1d.py:qconv1d_block_p`` (the Pallas TPU
kernel): depthwise(k) -> pointwise(CxC) -> folded-BN scale+shift ->
optional ReLU over int8 weights, fp32 sums, output in x's dtype. The
kernels take the window unpadded and make the non-causal halo
themselves. Two of them, chosen by :func:`route`: a tensor-core kernel
for bf16 (the served path) and a CUDA-core kernel for fp32 and the bf16
shapes the first does not take. The source's header says how each tiles
and what bounds it on the card; the plain version is
:func:`repro_torch.kernels.ref.qconv1d_block_ref` (over the padded
window, the JAX kernel's signature).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)
ROUTES = ("tensor_core", "cuda_core")

# the tensor-core kernel's tiling (csrc/qconv1d.cu)
TC_TILE = 32                  # output frames per tile
TC_SLAB = 64                  # channels per depthwise slab
TC_CMAX = 352                 # widest C it takes
TC_KMAX = 96                  # most taps it takes


def tc_smem_bytes(C: int, k: int) -> int:
    """Shared memory of the tensor-core kernel (``tc_smem_bytes`` in the
    source): int8 pw (C rounded to 16 rows of C), the A tile's two bf16
    terms (rows padded by 8), the slab's fp32 taps, a two-slab cp.async
    ring of x rows (bf16), and pw_s, gamma, beta (fp32)."""
    kp = -(-C // 16) * 16
    slab = (TC_TILE + k - 1) * TC_SLAB * 2
    return (kp * C + 2 * TC_TILE * (kp + 8) * 2 + k * TC_SLAB * 4
            + 2 * slab + 3 * C * 4)


def route(dtype: torch.dtype, C: int, k: int) -> str:
    """Which kernel ``qconv1d_block_cuda`` launches, by dtype and shape:
    ``tensor_core`` for bf16 at C a multiple of 8 up to 352 and k up to
    96 whose tiles fit in shared memory (every RUBICALL block);
    ``cuda_core`` otherwise (fp32, other widths)."""
    if dtype == torch.bfloat16 and C % 8 == 0 and 8 <= C <= TC_CMAX and \
            k <= TC_KMAX and tc_smem_bytes(C, k) <= SMEM_LIMIT:
        return "tensor_core"
    return "cuda_core"


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("qconv1d")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.qconv1d_block_launch.argtypes = [vp] * 8 + [ci] * 7 + [vp]
    lib.qconv1d_block_launch.restype = ci
    lib.qconv1d_tc_launch.argtypes = [vp] * 8 + [ci] * 7 + [vp]
    lib.qconv1d_tc_launch.restype = ci
    for name in ("qconv1d_smem_bytes", "qconv1d_tc_smem_bytes"):
        getattr(lib, name).argtypes = [ci, ci]
        getattr(lib, name).restype = ctypes.c_size_t
    return lib


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"qconv1d_block: {name} must be {dtype}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"qconv1d_block: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"qconv1d_block: {name} is on {t.device}, "
                         f"x on {device}")
    if not t.is_contiguous():
        raise ValueError(f"qconv1d_block: {name} must be contiguous")


def qconv1d_block_cuda(x: torch.Tensor, dw_q: torch.Tensor,
                       pw_q: torch.Tensor, dw_scale: torch.Tensor,
                       pw_scale: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, *, relu: bool = True
                       ) -> torch.Tensor:
    """x: (B, T, C) fp32/bf16 CUDA tensor, unpadded (the kernel reads
    frames outside [0, T) as zero: ``(k-1)//2`` on the left, the rest on
    the right); dw_q (k, C) / pw_q (C, C) int8; dw_scale, pw_scale,
    gamma, beta (1, C) fp32. Returns (B, T, C) in x.dtype.

    Launches the kernel that :func:`route` names (no fallback between
    them) on the current stream without synchronising; counts one
    launch in ``.launches`` and one on that route in ``.routes``."""
    if not x.is_cuda:
        raise ValueError("qconv1d_block_cuda needs a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise TypeError(f"qconv1d_block: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("qconv1d_block: x must be a contiguous (B, T, C)")
    B, T, C = x.shape
    k = dw_q.shape[0]
    if T < 1:
        raise ValueError("qconv1d_block: empty window")
    _check("dw_q", dw_q, torch.int8, (k, C), x.device)
    _check("pw_q", pw_q, torch.int8, (C, C), x.device)
    for name, v in (("dw_scale", dw_scale), ("pw_scale", pw_scale),
                    ("gamma", gamma), ("beta", beta)):
        _check(name, v, torch.float32, (1, C), x.device)
    lib = _lib()
    path = route(x.dtype, C, k)
    if path == "tensor_core":
        smem = lib.qconv1d_tc_smem_bytes(C, k)
        for name, a, align in (("x", x, 16), ("dw_q", dw_q, 4),
                               ("pw_q", pw_q, 16), ("dw_scale", dw_scale, 16),
                               ("pw_scale", pw_scale, 16), ("gamma", gamma, 16),
                               ("beta", beta, 16)):
            if a.data_ptr() % align:
                raise ValueError(f"qconv1d_block: {name} must be "
                                 f"{align}-byte aligned")
    else:
        smem = lib.qconv1d_smem_bytes(C, k)
    if smem > SMEM_LIMIT:
        raise ValueError(f"qconv1d_block: C={C}, k={k} needs {smem} bytes "
                         f"of shared memory (> {SMEM_LIMIT})")
    out = torch.empty((B, T, C), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), dw_q.data_ptr(), pw_q.data_ptr(),
            dw_scale.data_ptr(), pw_scale.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "tensor_core":
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            rc = lib.qconv1d_tc_launch(*ptrs, B, T, C, k, (k - 1) // 2,
                                       int(relu), sms, stream)
        else:
            rc = lib.qconv1d_block_launch(*ptrs, B, T, C, k, (k - 1) // 2,
                                          int(relu), _DTYPES[x.dtype],
                                          stream)
    if rc != 0:
        raise RuntimeError(f"qconv1d_block launch failed: CUDA error {rc}")
    _build.count_launch(qconv1d_block_cuda, "qconv1d_block", path)
    return out


qconv1d_block_cuda.launches = 0
qconv1d_block_cuda.routes = dict.fromkeys(ROUTES, 0)
