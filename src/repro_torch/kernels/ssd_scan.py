"""The Mamba-2 SSD chunked scan over a whole prompt: the hand-written
CUDA kernel (``csrc/ssd_scan.cu``) behind a checked wrapper.

Replaces ``repro/kernels/ssd_scan.py:ssd_scan_p`` (the Pallas TPU
kernel): the intra-chunk causal term, the inter-chunk ``exp(cum) C.h``
term and ``D x``, with the state carried across chunks, all in fp32.
The public layout is the reference ``ops.ssd_chunk_scan``'s: x (B, S,
nh, hd), dt (B, S, nh), A/D (nh,), B/C (B, S, N), read by batch row and
never repeated per head. Unlike the Pallas kernel it takes any S and
also returns the state after the last position, (B, nh, hd, N) fp32,
which the decode steps continue from. The kernel takes head dims in
multiples of 32 and state widths in multiples of 4; the wrapper
zero-pads x (and B, C) up to them (a zero state row or column adds
nothing and decays nothing) and slices the pads off. The source's
header says how it tiles and what bounds it on the card; its plain
version is :func:`repro_torch.kernels.ref.ssd_chunked`.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.ssd_scan_launch.restype = ci
    lib.ssd_scan_smem_bytes.argtypes = [ci]
    lib.ssd_scan_smem_bytes.restype = ctypes.c_size_t
    for name in ("ssd_scan_state_rows", "ssd_scan_max_state"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ci
    return lib


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"ssd_scan: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ssd_scan: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"ssd_scan: {name} is on {t.device}, x on {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"ssd_scan: {name} must be contiguous and 16-byte "
                         f"aligned")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
                  chunk: int = 256):
    """x: (B, S, nh, hd) fp32 or bf16; dt: (B, S, nh) fp32; A/D: (nh,)
    fp32; Bm/Cm: (B, S, N) in x's dtype; contiguous CUDA tensors; N up
    to 128, any hd and S. Returns (y (B, S, nh, hd) in x's dtype, final
    state (B, nh, hd, N) fp32).
    ``chunk`` is the plain version's chunk length; the kernel's own (64)
    regroups the same exact recurrence. Launches on the current stream
    without synchronising; counts one launch in
    ``ssd_scan_cuda.launches``."""
    if not x.is_cuda:
        raise ValueError("ssd_scan: the CUDA kernel needs CUDA tensors")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.ndim != 4 or Bm.ndim != 3:
        raise ValueError(f"ssd_scan: x must be (B, S, nh, hd) and B/C (B, "
                         f"S, N), got {tuple(x.shape)} and "
                         f"{tuple(Bm.shape)}")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be positive, got {chunk}")
    Bsz, S, nh, hd = x.shape
    N = Bm.shape[-1]
    dev = x.device
    _check("x", x, x.dtype, (Bsz, S, nh, hd), dev)
    _check("dt", dt, torch.float32, (Bsz, S, nh), dev)
    _check("A", A, torch.float32, (nh,), dev)
    _check("D", D, torch.float32, (nh,), dev)
    _check("Bm", Bm, x.dtype, (Bsz, S, N), dev)
    _check("Cm", Cm, x.dtype, (Bsz, S, N), dev)
    lib = _lib()
    rows, max_n = lib.ssd_scan_state_rows(), lib.ssd_scan_max_state()
    if not 0 < N <= max_n or hd < 1:
        raise ValueError(f"ssd_scan: state {N} not in 1..{max_n} or "
                         f"head_dim {hd} < 1")
    if Bsz == 0 or S == 0:
        return (torch.empty_like(x),
                torch.zeros((Bsz, nh, hd, N), dtype=torch.float32,
                            device=dev))
    hp, npad = -(-hd // rows) * rows, -(-N // 4) * 4
    if hp != hd:
        x = F.pad(x, (0, hp - hd))
    if npad != N:
        Bm, Cm = F.pad(Bm, (0, npad - N)), F.pad(Cm, (0, npad - N))
    if lib.ssd_scan_smem_bytes(npad) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: state {npad} needs more than "
                         f"{SMEM_LIMIT} bytes of shared memory")
    y = torch.empty_like(x)
    h = torch.empty((Bsz, nh, hp, npad), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(), Bsz, S,
            nh, hp, npad, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    ssd_scan_cuda.launches += 1
    if hp != hd or npad != N:
        y, h = y[..., :hd].contiguous(), h[:, :, :hd, :N].contiguous()
    return y, h


ssd_scan_cuda.launches = 0
