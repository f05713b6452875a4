"""Flash attention over a whole prompt: the hand-written CUDA kernels
(``csrc/flash_attention.cu``) behind a checked wrapper: bf16 on Hopper's
tensor cores (wgmma fed by TMA), fp32 on the CUDA cores (:func:`route`).

Replaces ``repro/kernels/flash_attention.py:flash_attention_p`` (the
Pallas TPU kernel): softmax attention, causal or not, fp32 online
softmax, output in q's dtype. The public layout is the reference
``ops.flash_attention``'s, q (B, Sq, H, d) and k/v (B, Sk, Hkv, d); the
kernel reads KV head h // group for query head h by index and takes any
Sq and Sk. It is built for head dims 64 and 128; the wrapper zero-pads
any other d up to 128 to the next of them (zero dims add nothing to a
score, the scale stays d^-0.5, and the padded output dims are sliced
off). The source's header says how it tiles and what bounds it on
the card; its plain version is
:func:`repro_torch.kernels.ref.flash_attention_gqa_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
SMEM_LIMIT = 232448           # dynamic shared memory a block may use (H100)


def route(dtype: torch.dtype) -> str:
    """The kernel a dtype takes: bf16 the tensor-core kernel (wgmma, TMA),
    fp32 the CUDA-core one (fp32 does not fit bf16 tensor cores)."""
    return "tensor_core" if dtype == torch.bfloat16 else "cuda_core"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = ([vp] * 4 + [ci] * 6
                                           + [ctypes.c_float, ci, ci, vp])
    lib.flash_attention_launch.restype = ci
    lib.flash_attention_smem_bytes.argtypes = [ci, ci]
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, d); k/v: (B, Sk, Hkv, d); one dtype, fp32 or bf16,
    contiguous CUDA tensors; d up to 128; H a multiple of Hkv. Returns
    (B, Sq, H, d) in q's dtype. Launches on the current stream without
    synchronising; counts one launch in ``flash_attention_cuda.launches``
    and one in ``.routes`` under :func:`route`."""
    if not q.is_cuda:
        raise ValueError("flash_attention: the CUDA kernel needs CUDA "
                         "tensors")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"flash_attention: q must be (B, Sq, H, d) and k/v "
                         f"(B, Sk, Hkv, d), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    B, Sq, H, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if not 0 < d <= HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention: head_dim {d} not in 1.."
                         f"{HEAD_DIMS[-1]}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads over {Hkv} KV "
                         f"heads")
    if tuple(k.shape) != (B, Sk, Hkv, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: k/v must both be ({B}, Sk, Hkv, "
                         f"{d}), got {tuple(k.shape)} and {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q "
                            f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"and 16-byte aligned")
    if B == 0 or Sq == 0:
        return torch.empty_like(q)
    if Sk == 0:
        raise ValueError("flash_attention: no keys")
    dk = next(n for n in HEAD_DIMS if n >= d)
    if dk != d:
        q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    out = torch.empty_like(q)
    lib = _lib()
    if lib.flash_attention_smem_bytes(dk, _DTYPES[q.dtype]) > SMEM_LIMIT:
        raise ValueError(f"flash_attention: head_dim {dk} needs more than "
                         f"{SMEM_LIMIT} bytes of shared memory")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, Hkv, dk, float(d ** -0.5), int(causal), _DTYPES[q.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    _build.count_launch(flash_attention_cuda, "flash_attention",
                        route(q.dtype))
    return out[..., :d].contiguous() if dk != d else out


flash_attention_cuda.launches = 0
flash_attention_cuda.routes = {"tensor_core": 0, "cuda_core": 0}
