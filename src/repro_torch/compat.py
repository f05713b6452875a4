"""PyTorch version compatibility shims (the port's twin of
``repro/compat.py``).

The port pins ``torch>=2.4`` (``requirements-torch.txt``) but uses a few
surfaces whose home moved between releases or is private. Every such
name routes through here, so the rest of the package stays clean of
version probes, and the ``compat`` rule of ``python -m
repro_torch.analysis`` flags a raw use anywhere else:

- the DTensor API (``DTensor``, ``Replicate``, ``Shard``,
  ``distribute_tensor``): public as ``torch.distributed.tensor`` in the
  releases this repo runs on; older ones kept it in
  ``torch.distributed._tensor``, which newer ones keep only as a
  deprecated alias ("DTensor has moved to torch.distributed.tensor").
  Imported on first use (the module takes about a second to import),
  so only the dry run and sharded training pay for it.
- ``FakeTensorMode`` and ``is_fake`` from the private
  ``torch._subclasses.fake_tensor``: the dry run's shape-only
  execution, and the model code's test for it.
"""
from __future__ import annotations

from torch._subclasses.fake_tensor import FakeTensorMode, is_fake

DTENSOR_NAMES = ("DTensor", "Replicate", "Shard", "distribute_tensor")

__all__ = ["FakeTensorMode", "is_fake", *DTENSOR_NAMES]


def _dtensor():
    try:
        import torch.distributed.tensor as mod
    except ImportError:                       # releases before the move
        import torch.distributed._tensor as mod
    return mod


def __getattr__(name: str):
    if name in DTENSOR_NAMES:
        return getattr(_dtensor(), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
