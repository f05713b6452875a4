"""Where the port runs: CUDA unless the caller asks for the CPU.

Low in the package (it imports only torch), so every entry point, the
serving pool included, resolves its device through the same rule."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> CUDA. Raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' (the launchers: "
            "--device cpu) to run on the CPU")
    return dev
