"""Quantized separable conv-1D block: the hand-written CUDA kernel
(``csrc/qconv1d.cu``) behind a checked wrapper.

Replaces ``repro/kernels/qconv1d.py:qconv1d_block_p`` (the Pallas TPU
kernel): depthwise(k) -> pointwise(CxC) -> folded-BN scale+shift ->
optional ReLU over int8 weights, fp32 math, output in x's dtype. The
source's header says how it tiles and what bounds it on the card; its
plain version is :func:`repro_torch.kernels.ref.qconv1d_block_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("qconv1d")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.qconv1d_block_launch.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.qconv1d_block_launch.restype = ci
    lib.qconv1d_smem_bytes.argtypes = [ci, ci]
    lib.qconv1d_smem_bytes.restype = ctypes.c_size_t
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
    """x: (B, T + k - 1, C) fp32/bf16 CUDA tensor, time axis pre-padded
    with the (k-1) halo; dw_q (k, C) / pw_q (C, C) int8; dw_scale,
    pw_scale, gamma, beta (1, C) fp32. Returns (B, T, C) in x.dtype.

    Launches on the current stream without synchronising; counts one
    launch in ``qconv1d_block_cuda.launches``."""
    if not x.is_cuda:
        raise ValueError("qconv1d_block_cuda needs a CUDA tensor")
    if x.dtype not in _DTYPES:
        raise TypeError(f"qconv1d_block: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("qconv1d_block: x must be a contiguous (B, T+k-1, C)")
    B, Tp, C = x.shape
    k = dw_q.shape[0]
    T = Tp - (k - 1)
    if T < 1:
        raise ValueError(f"qconv1d_block: {Tp} padded frames < k={k}")
    _check("dw_q", dw_q, torch.int8, (k, C), x.device)
    _check("pw_q", pw_q, torch.int8, (C, C), x.device)
    for name, v in (("dw_scale", dw_scale), ("pw_scale", pw_scale),
                    ("gamma", gamma), ("beta", beta)):
        _check(name, v, torch.float32, (1, C), x.device)
    lib = _lib()
    smem = lib.qconv1d_smem_bytes(C, k)
    if smem > SMEM_LIMIT:
        raise ValueError(f"qconv1d_block: C={C}, k={k} needs {smem} bytes "
                         f"of shared memory (> {SMEM_LIMIT})")
    out = torch.empty((B, T, C), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qconv1d_block_launch(
            x.data_ptr(), dw_q.data_ptr(), pw_q.data_ptr(),
            dw_scale.data_ptr(), pw_scale.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(), B, T, C, k, int(relu),
            _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"qconv1d_block launch failed: CUDA error {rc}")
    qconv1d_block_cuda.launches += 1
    return out


qconv1d_block_cuda.launches = 0
