"""Rotary position embeddings: standard (llama-style, interleaved
pairs) and 2d/half-dim (chatglm-style: rotary on the first half of
head_dim only). The port's counterpart of ``repro.models.lm.rope``."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """Inverse frequencies for ``head_dim // 2`` rotation planes."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, positions: torch.Tensor,
            inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate the leading ``2 * len(inv_freq)`` features of x (..., S,
    head_dim) as pairs (x[2i], x[2i+1]); positions broadcast to
    (..., S)."""
    rot = 2 * inv_freq.shape[0]
    xr, xp = x[..., :rot], x[..., rot:]
    ang = positions[..., None].float() * inv_freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = xr[..., 0::2].float()
    x2 = xr[..., 1::2].float()
    y = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    y = y.reshape(xr.shape).to(x.dtype)
    return torch.cat([y, xp], dim=-1) if xp.shape[-1] else y


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, head_dim: int,
               theta: float = 10000.0, two_d: bool = False) -> torch.Tensor:
    """x: (B, S, H, hd) or (B, S, hd); positions: (B, S) or (S,).
    ``two_d`` rotates only the first half of head_dim (chatglm3)."""
    rot_dim = head_dim // 2 if two_d else head_dim
    inv = rope_freqs(rot_dim, theta, device=x.device)
    if x.ndim == 4:          # positions broadcast over heads
        pos = (positions[:, :, None] if positions.ndim == 2
               else positions[None, :, None])
    else:
        pos = positions if positions.ndim == 2 else positions[None, :]
    return _rotate(x, pos, inv)
