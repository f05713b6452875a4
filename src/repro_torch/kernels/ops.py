"""Public wrappers around the port's kernels.

A wrapper owns the layout glue (halo padding, PackedTensor unwrapping)
and routes by device: a CPU tensor runs the plain PyTorch version in
:mod:`repro_torch.kernels.ref`, a CUDA tensor launches the hand-written
kernel — or the call raises. There is no fallback from one to the
other.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import qconv1d, ref


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
    raise ValueError(f"qconv1d_block: no kernel for device {x.device}")


def launch_counts() -> dict:
    """Kernel launches so far, by kernel (CPU calls launch nothing)."""
    return {"qconv1d_block": qconv1d.qconv1d_block_cuda.launches}


def reset_launch_counts() -> None:
    qconv1d.qconv1d_block_cuda.launches = 0
