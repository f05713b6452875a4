"""Elastic scaling and failure handling (the port's counterpart of
``repro.training.elastic``).

Policy (for the many-host posture; simulated in tests):

1. A step-heartbeat watchdog marks a host dead after ``patience``
   missed beats (:class:`Watchdog`, launcher side).
2. On failure the launcher rebuilds the largest *valid* mesh from the
   surviving ranks (:func:`best_mesh_shape`): the 'model' axis stays
   whole (the TP degree is a property of the checkpointed layout) and
   the data axis shrinks; stragglers are excluded the same way.
3. Parameters and optimizer state are restored from the latest valid
   checkpoint (one file per leaf, layout-free: whole leaves) and
   **resharded** onto the new mesh (:func:`reshard`: ``distribute_tensor``
   with the new placements, or, given a config and a model size, this
   rank's shard of each whole leaf, as a tensor-parallel train step
   holds it).
4. Training resumes with the grad-accumulation count re-derived so the
   global batch is kept (synchronous data-parallel semantics unchanged,
   so loss curves reproduce across restarts).
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.compat import distribute_tensor
from repro_torch.parallel.sharding import zip_map


def best_mesh_shape(n_devices: int, model_parallel: int
                    ) -> Tuple[int, int]:
    """Largest (data, model) grid with the fixed TP degree that fits the
    surviving device count."""
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot hold model-parallel degree "
            f"{model_parallel}; restore needs a TP-degree-preserving mesh")
    return n_devices // model_parallel, model_parallel


def rebuild_mesh(ranks: Sequence[int], model_parallel: int) -> DeviceMesh:
    """A ``(data, model)`` mesh over the surviving ``ranks`` of the
    default process group (CUDA devices under NCCL, else the CPU)."""
    data, mp = best_mesh_shape(len(ranks), model_parallel)
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.tensor(list(ranks[: data * mp]), dtype=torch.int).reshape(
        data, mp)
    return DeviceMesh(dev, grid, mesh_dim_names=("data", "model"))


def reshard(tree: Any, shardings: Any = None, *, cfg=None,
            model: int = 1, index: int = 0) -> Any:
    """Move a host (or differently placed) tree onto new shardings
    (:class:`repro_torch.parallel.sharding.Sharding` leaves): each leaf
    becomes a DTensor on the sharding's mesh with its placements.

    Without ``shardings``: part ``index`` of ``model`` of each whole
    leaf of a parameter tree of ``cfg``, the shard that rank ``index``
    of a model axis of ``model`` keeps in training
    (``tensor_parallel.split_dims``); whole leaves stay whole."""
    if shardings is None:
        from repro_torch.parallel import tensor_parallel as tp
        return tp.shard_tree(tree, tp.split_dims(tree, cfg, model), index,
                             model)

    def one(x, sh):
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x)
        return distribute_tensor(t.to(sh.mesh.device_type), sh.mesh,
                                 list(sh.placements))
    return zip_map(one, tree, shardings)


class Watchdog:
    """Step-heartbeat straggler/failure detector (launcher side)."""

    def __init__(self, n_hosts: int, patience: int = 3):
        self.beats = np.zeros(n_hosts, np.int64)
        self.patience = patience
        self.step = 0

    def beat(self, host: int, step: int) -> None:
        self.beats[host] = step

    def advance(self, step: int) -> None:
        self.step = step

    def suspects(self) -> list:
        """Hosts lagging more than ``patience`` steps (stragglers/dead)."""
        return [int(h) for h in np.where(
            self.step - self.beats > self.patience)[0]]
