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
    # one pass: the integers times the fp32 scale in fp32, rounded once
    # to ``dtype`` as they are stored, the bits of
    # ``(q.float() * scale).to(dtype)`` without its two fp32 temporaries
    out = torch.empty(torch.broadcast_shapes(q.shape, p.scale.shape),
                      dtype=dtype, device=q.device)
    return torch.mul(q, p.scale, out=out)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree,
                       prefix: str = ""):
    """Rebuild a tree of dicts and lists, mapping every other leaf
    through ``fn(path, leaf)`` where ``path`` is ``prefix`` + the
    '/'-joined keys (a list element's key is its index)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return fn(prefix[:-1], tree)
    out = {k: tree_map_with_path(fn, v, prefix + k + "/") for k, v in items}
    return out if isinstance(tree, dict) else list(out.values())


@dataclasses.dataclass(frozen=True)
class Packer:
    """``quantize_tree``'s rule for one leaf: which leaves pack (matmul
    and conv kernels with 4 or 8 weight bits under ``policy`` and at
    least ``min_size`` values) and how. Calling it on ``(tag, leaf)``
    packs a leaf, so a model can pack each leaf as it is drawn instead
    of holding the whole float tree first."""
    policy: QuantPolicy
    min_size: int = 4096

    def bits(self, tag: str, shape) -> int:
        """Weight bits a leaf of this tag and shape packs with; 0 if it
        stays as it is."""
        wb, _ = self.policy.bits_for(tag)
        quantizable = ("kernel" in tag or tag.endswith("/dw")
                       or tag.endswith("/pw") or "head_pw" in tag
                       or tag.endswith(("/wi", "/wg", "/wo")))
        numel = 1
        for n in shape:
            numel *= n
        ok = (wb in (4, 8) and len(shape) >= 2 and numel >= self.min_size
              and quantizable)
        return wb if ok else 0

    def __call__(self, tag: str, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        wb = self.bits(tag, leaf.shape)
        if not wb:
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

    def tree(self, tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
        """Pack every leaf of ``tree`` whose tag (``prefix`` + key path)
        packs; PackedTensor leaves pass through."""
        return tree_map_with_path(self, tree, prefix)


def quantize_tree(params: Dict[str, Any], policy: QuantPolicy,
                  min_size: int = 4096) -> Dict[str, Any]:
    """Quantize matmul/conv kernels per the policy; leave the rest."""
    return Packer(policy, min_size).tree(params)


def tree_map(fn: Callable[..., Any], tree, *rest):
    """Apply ``fn`` to every leaf of a tree of dicts and lists (e.g.
    ``lambda t: t.to(device)``); with one tree, PackedTensor children
    are mapped too. ``rest`` are trees of the same structure, matched by
    key: ``fn(leaf, *their leaves)``, whose result may be a tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if isinstance(tree, PackedTensor) and not rest:
        return PackedTensor(fn(tree.data), fn(tree.scale), tree.bits,
                            tree.orig_shape)
    return fn(tree, *rest)


def tree_items(tree) -> list:
    """``(path, leaf)`` of every leaf of a tree of dicts and lists, in
    walk order."""
    out: list = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in walk order."""
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(like, leaves):
    """``like``'s structure holding ``leaves`` (in :func:`tree_leaves`
    order)."""
    it = iter(leaves)
    return tree_map_with_path(lambda _, __: next(it), like)


def tree_size_bytes(params: Dict[str, Any]) -> int:
    """Model size in bytes honouring PackedTensor compression."""
    total = 0

    def one(_, leaf):
        nonlocal total
        total += (leaf.nbytes if isinstance(leaf, PackedTensor)
                  else leaf.numel() * leaf.element_size())
    tree_map_with_path(one, params)
    return total
