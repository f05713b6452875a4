"""Weights across frameworks: nested dicts and lists of numpy arrays ->
the port's tree of torch tensors.

A JAX params/state tree becomes such a tree with
``jax.tree.map(np.asarray, tree)``, which keeps its ``PackedTensor``
nodes with numpy children; those are recognised by their ``data``,
``scale``, ``bits`` and ``orig_shape`` attributes, so this module needs
nothing from the JAX package. Dtypes are kept (int8 stays int8).
"""
from __future__ import annotations

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


def from_numpy_tree(tree, device=None):
    """Nested dicts and lists of numpy arrays (and PackedTensor-like
    nodes) -> the same structure of torch tensors / :class:`PackedTensor`
    on ``device``: CUDA unless the caller asks for the CPU, raising
    without a card (:func:`repro_torch.models.api.resolve_device`)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [from_numpy_tree(v, device) for v in tree]
    if isinstance(tree, (np.ndarray, np.generic)):
        return _tensor(tree, device)
    # a PackedTensor node, duck-typed
    return PackedTensor(_tensor(tree.data, device), _tensor(tree.scale, device),
                        int(tree.bits), tuple(int(d) for d in tree.orig_shape))
