"""Weights across frameworks: nested dicts of numpy arrays -> the port's
tree of torch tensors.

A JAX params/state tree becomes such a tree with
``jax.tree.map(np.asarray, tree)``, which keeps its ``PackedTensor``
nodes with numpy children; those are recognised by their ``data``,
``scale``, ``bits`` and ``orig_shape`` attributes, so this module needs
nothing from the JAX package. Dtypes are kept (int8 stays int8).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.quant.policy import PackedTensor
from repro_torch.models.api import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch twin in numpy
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_numpy_tree(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dicts of numpy arrays (and PackedTensor-like nodes) ->
    the same structure of torch tensors / :class:`PackedTensor` on
    ``device``: CUDA unless the caller asks for the CPU, raising
    without a card (:func:`repro_torch.models.api.resolve_device`)."""
    device = resolve_device(device)
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = from_numpy_tree(v, device)
        elif isinstance(v, (np.ndarray, np.generic)):
            out[k] = _tensor(v, device)
        else:                           # a PackedTensor node, duck-typed
            out[k] = PackedTensor(_tensor(v.data, device),
                                  _tensor(v.scale, device), int(v.bits),
                                  tuple(int(d) for d in v.orig_shape))
    return out
