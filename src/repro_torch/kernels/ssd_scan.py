"""The Mamba-2 SSD chunked scan over a whole prompt: the hand-written
CUDA kernel (``csrc/ssd_scan.cu``) behind a checked wrapper.

Replaces ``repro/kernels/ssd_scan.py:ssd_scan_p`` (the Pallas TPU
kernel): the intra-chunk causal term, the inter-chunk ``exp(cum) C.h``
term and ``D x``, with the state carried across chunks, all in fp32.
The public layout is the reference ``ops.ssd_chunk_scan``'s: x (B, S,
nh, hd), dt (B, S, nh), A/D (nh,), B/C (B, S, N), read by batch row and
never repeated per head. Unlike the Pallas kernel it takes any S and
also returns the state after the last position, (B, nh, hd, N) fp32,
which the decode steps continue from.

Two routes, chosen by :func:`route`: a tensor-core route for bf16 (a
state pass and a chunk pass, two kernels; head dims up to 64 and state
widths up to 128, zero-padded to 64 and to 64 or 128) and a CUDA-core
kernel for fp32 and the shapes the first does not take (head dims
zero-padded to multiples of 32, state widths to multiples of 4). A zero
state row or column adds nothing and decays nothing; the wrapper slices
the pads off. The source's header says how each tiles and what bounds
it on the card; the plain version is
:func:`repro_torch.kernels.ref.ssd_chunked`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)
ROUTES = ("tensor_core", "cuda_core")
TC_CHUNK = 128                # the tensor-core route's chunk (csrc/ssd_scan.cu)
TC_HEAD_DIM = 64              # its head dim, and its largest
TC_MAX_STATE = 128            # its largest state width


def route(dtype: torch.dtype, hd: int, N: int) -> str:
    """Which route ``ssd_scan_cuda`` takes: ``tensor_core`` for bf16 at
    head dims up to 64 and state widths up to 128 (mamba2-130m: 64 and
    128), ``cuda_core`` otherwise (fp32, wider shapes)."""
    if dtype == torch.bfloat16 and hd <= TC_HEAD_DIM and N <= TC_MAX_STATE:
        return "tensor_core"
    return "cuda_core"


def tc_state_width(N: int) -> int:
    """The state width the tensor-core route runs at: 64 or 128."""
    return 64 if N <= 64 else TC_MAX_STATE


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.ssd_scan_launch.restype = ci
    lib.ssd_scan_smem_bytes.argtypes = [ci]
    lib.ssd_scan_smem_bytes.restype = ctypes.c_size_t
    lib.ssd_scan_tc_launch.argtypes = [vp] * 10 + [ci] * 4 + [vp]
    lib.ssd_scan_tc_launch.restype = ci
    lib.ssd_scan_tc_smem_bytes.argtypes = [ci]
    lib.ssd_scan_tc_smem_bytes.restype = ctypes.c_size_t
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
                  chunk: int = 256, path: Optional[str] = None):
    """x: (B, S, nh, hd) fp32 or bf16; dt: (B, S, nh) fp32; A/D: (nh,)
    fp32; Bm/Cm: (B, S, N) in x's dtype; contiguous CUDA tensors; N up
    to 128, any hd and S. Returns (y (B, S, nh, hd) in x's dtype, final
    state (B, nh, hd, N) fp32).
    ``chunk`` is the plain version's chunk length; the kernels' own (128
    on the tensor-core route, 64 on the CUDA-core one) regroup the same
    exact recurrence. Launches the route that ``path`` names, by default
    the one :func:`route` picks (no fallback between them; the
    tensor-core route is two kernels and takes only the shapes
    :func:`route` gives it), on the current stream without
    synchronising; counts one launch in ``.launches`` and one on that
    route in ``.routes``."""
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
    if path is None:
        path = route(x.dtype, hd, N)
    elif path not in ROUTES:
        raise ValueError(f"ssd_scan: route {path!r} not in {ROUTES}")
    elif path == "tensor_core" and route(x.dtype, hd, N) != path:
        raise ValueError(f"ssd_scan: the tensor-core route takes bf16 "
                         f"with hd <= {TC_HEAD_DIM} and N <= "
                         f"{TC_MAX_STATE}, got {x.dtype}, {hd}, {N}")
    if path == "tensor_core":
        hp, npad = TC_HEAD_DIM, tc_state_width(N)
        smem = lib.ssd_scan_tc_smem_bytes(npad)
    else:
        hp, npad = -(-hd // rows) * rows, -(-N // 4) * 4
        smem = lib.ssd_scan_smem_bytes(npad)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: state {npad} needs more than "
                         f"{SMEM_LIMIT} bytes of shared memory")
    if hp != hd:
        x = F.pad(x, (0, hp - hd))
    if npad != N:
        Bm, Cm = F.pad(Bm, (0, npad - N)), F.pad(Cm, (0, npad - N))
    y = torch.empty_like(x)
    h = torch.empty((Bsz, nh, hp, npad), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "tensor_core":
            nch = -(-S // TC_CHUNK)
            # the state before each chunk, as bf16 hi + lo terms
            hp_hi, hp_lo = torch.empty((2, Bsz, nch, nh, hp, npad),
                                       dtype=torch.bfloat16, device=dev)
            rc = lib.ssd_scan_tc_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(),
                hp_hi.data_ptr(), hp_lo.data_ptr(), Bsz, S, nh, npad,
                stream)
        else:
            rc = lib.ssd_scan_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(),
                Bsz, S, nh, hp, npad, _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    _build.count_launch(ssd_scan_cuda, "ssd_scan", path)
    if hp != hd or npad != N:
        y, h = y[..., :hd].contiguous(), h[:, :, :hd, :N].contiguous()
    return y, h


ssd_scan_cuda.launches = 0
ssd_scan_cuda.routes = dict.fromkeys(ROUTES, 0)
