"""Serving-time quantization: true integer storage + per-channel scales.

``quantize_tree`` walks a nested-dict param tree with a
:class:`repro_torch.config.QuantPolicy` and converts matmul/conv
weights into :class:`PackedTensor` (int8, or int4 packed two-per-byte).
The CUDA ``qconv1d`` kernel consumes packed conv weights directly; the
plain path dequantizes on read.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.config import QuantPolicy


@dataclasses.dataclass
class PackedTensor:
    """Quantized weight: int data + fp32 per-channel scales.

    int4 packs two values per int8 byte along axis -2 (that axis
    halves); ``unpack_int4`` restores.
    """
    data: torch.Tensor           # int8
    scale: torch.Tensor          # (1, cols) fp32
    bits: int
    orig_shape: Tuple[int, ...]

    @property
    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size() \
            + self.scale.numel() * 4


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., 2K, C) int8 in [-8,7] -> (..., K, C) int8, two nibbles/byte."""
    lo = q[..., 0::2, :] & 0xF
    hi = (q[..., 1::2, :] & 0xF) << 4
    return (lo | hi).to(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    lo = (p << 4).to(torch.int8) >> 4            # sign-extend low nibble
    hi = p >> 4                                   # arithmetic shift (int8)
    out = torch.stack([lo, hi], dim=-2)          # (..., K, 2, C)
    return out.reshape(p.shape[:-2] + (2 * p.shape[-2],) + p.shape[-1:])


def quantize_tensor(w: torch.Tensor, bits: int,
                    per_channel: bool = True) -> PackedTensor:
    """Per-output-channel scales reduce over axis -2 only, so stacked
    layer weights (L, K, N) get (L, 1, N) scales."""
    qmax = 2.0 ** (bits - 1) - 1.0
    wf = w.float()
    if per_channel and w.ndim >= 2:
        amax = wf.abs().amax(dim=-2, keepdim=True)
    else:
        amax = wf.abs().amax()
    scale = amax.clamp_min(1e-8) / qmax
    q = torch.clamp(torch.round(wf / scale), -qmax - 1, qmax).to(torch.int8)
    if bits == 4:
        if q.shape[-2] % 2:
            pad = q.new_zeros(q.shape[:-2] + (1,) + q.shape[-1:])
            q = torch.cat([q, pad], dim=-2)
        q = pack_int4(q)
    return PackedTensor(q, scale, bits, tuple(w.shape))


def dequantize(p: PackedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Shape comes from the data (``orig_shape``'s trailing dims only)."""
    q = p.data
    if p.bits == 4:
        q = unpack_int4(q)
        if q.shape[-2] != p.orig_shape[-2]:      # drop pad row
            q = q[..., : p.orig_shape[-2], :]
    return (q.float() * p.scale).to(dtype)


def _walk(tree: Dict[str, Any], fn: Callable[[str, Any], Any],
          prefix: str = "") -> Dict[str, Any]:
    """Rebuild a nested dict, mapping every non-dict leaf through
    ``fn(tag, leaf)`` where ``tag`` is the '/'-joined key path."""
    return {k: (_walk(v, fn, prefix + k + "/") if isinstance(v, dict)
                else fn(prefix + k, v))
            for k, v in tree.items()}


def quantize_tree(params: Dict[str, Any], policy: QuantPolicy,
                  min_size: int = 4096) -> Dict[str, Any]:
    """Quantize matmul/conv kernels per the policy; leave the rest."""
    def one(tag: str, leaf):
        wb, _ = policy.bits_for(tag)
        quantizable = ("kernel" in tag or tag.endswith("/dw")
                       or tag.endswith("/pw") or "head_pw" in tag
                       or tag.endswith(("/wi", "/wg", "/wo")))
        if not (wb in (4, 8) and isinstance(leaf, torch.Tensor)
                and leaf.ndim >= 2 and leaf.numel() >= min_size
                and quantizable):
            return leaf
        conv = (tag.endswith("/dw") or tag.endswith("/pw")
                or "head_pw" in tag or "skip_pw" in tag)
        if conv and leaf.ndim == 3:
            # Conv weights pack in the 2-D layouts the fused qconv1d
            # kernel consumes — depthwise (k, 1, C) -> (k, C), pointwise
            # (1, Cin, Cout) -> (Cin, Cout) — with ``orig_shape`` keeping
            # the conv layout for the dequant-on-read path. int4's
            # nibble packing does not apply to convs: they clamp to int8.
            w2 = leaf.reshape((leaf.shape[0], leaf.shape[2])
                              if leaf.shape[1] == 1 and leaf.shape[0] > 1
                              else leaf.shape[1:])
            pt = quantize_tensor(w2, 8)
            return PackedTensor(pt.data, pt.scale, pt.bits,
                                tuple(leaf.shape))
        return quantize_tensor(leaf, wb)
    return _walk(params, one)


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor],
             tree: Dict[str, Any]) -> Dict[str, Any]:
    """Apply ``fn`` to every tensor of a nested dict, PackedTensor
    children included (e.g. ``lambda t: t.to(device)``)."""
    def one(_, leaf):
        if isinstance(leaf, PackedTensor):
            return PackedTensor(fn(leaf.data), fn(leaf.scale), leaf.bits,
                                leaf.orig_shape)
        return fn(leaf)
    return _walk(tree, one)


def tree_size_bytes(params: Dict[str, Any]) -> int:
    """Model size in bytes honouring PackedTensor compression."""
    total = 0

    def one(_, leaf):
        nonlocal total
        total += (leaf.nbytes if isinstance(leaf, PackedTensor)
                  else leaf.numel() * leaf.element_size())
    _walk(params, one)
    return total
