"""Public wrappers around the port's kernels.

A wrapper owns the layout glue (halo padding, PackedTensor unwrapping,
GQA head folding) and routes by device: a CPU tensor runs the plain
PyTorch version in :mod:`repro_torch.kernels.ref`, a CUDA tensor
launches the hand-written kernel — or the call raises. There is no
fallback from one to the other.

Decode attention has two backends (:func:`decode_gqa`): ``gather``, the
masked-dense reference over a gathered logical view, and ``cuda``, the
paged kernels reading the block arena in place (``gqa_paged`` for
single-token ticks, ``gqa_paged_chunk`` for C > 1 chunks).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant.policy import PackedTensor
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import qconv1d, qmatmul as qmm, ref


def _no_kernel(name: str, device) -> ValueError:
    return ValueError(f"{name}: no kernel for device {device}")


def qconv1d_block(x: torch.Tensor, dw, pw, gamma: torch.Tensor,
                  beta: torch.Tensor, *, relu: bool = True) -> torch.Tensor:
    """x: (B, T, C); dw/pw: int8 PackedTensor (dw packed (k, C), pw
    (C, C)); gamma/beta: (C,) folded BatchNorm. Fused RUBICALL block:
    non-causal ``(k-1)//2`` left / ``k-1-pad`` right zero halo."""
    k = dw.orig_shape[0]
    pad = (k - 1) // 2
    xp = F.pad(x, (0, 0, pad, k - 1 - pad))
    args = (xp, dw.data.reshape(k, -1), pw.data,
            dw.scale.float().reshape(1, -1).contiguous(),
            pw.scale.float().reshape(1, -1).contiguous(),
            gamma.float().reshape(1, -1).contiguous(),
            beta.float().reshape(1, -1).contiguous())
    if x.is_cuda:
        return qconv1d.qconv1d_block_cuda(*args, relu=relu)
    if x.device.type == "cpu":
        return ref.qconv1d_block_ref(*args, relu=relu)
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


# ---------------------------------------------------------------------------
# Launch counters

_COUNTED = {"qconv1d_block": qconv1d.qconv1d_block_cuda,
            "qmatmul": qmm.qmatmul_cuda,
            "gqa_paged": pa.gqa_paged_cuda,
            "gqa_paged_chunk": pa.gqa_paged_chunk_cuda}


def launch_counts() -> dict:
    """Kernel launches so far, by kernel (CPU calls launch nothing)."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
