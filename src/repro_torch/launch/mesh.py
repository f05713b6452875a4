"""Device meshes (the port's counterpart of ``repro.launch.mesh``).

Functions, not module-level constants, so importing starts no process
group. The production meshes keep the reference's shapes and axis
names, so a dry-run cell compares one to one with the reference's:
single pod ``(data=16, model=16)`` = 256 chips, multi-pod ``(pod=2,
data=16, model=16)`` = 512 chips, where ``pod`` is a pure data-parallel
axis.

The production mesh stands on stand-in ranks: a ``DeviceMesh`` needs a
process group to place itself (its coordinate, its per-axis groups),
and the ``fake`` backend of ``torch.testing._internal.distributed``
answers every collective without moving a byte, so 256 or 512 ranks
live in one process, this one being rank 0. A mesh built without a
backend would avoid the group, but only through private constructor
arguments that change between PyTorch releases; the fake group is
what ``FakeTensorMode`` programs are traced against upstream. It is
made only where a production mesh is asked for (the dry run's own
process), and a real group already in place is never replaced.
:func:`make_host_mesh` spans the caller's real process group instead.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _fake_world(n: int) -> None:
    """Make the default process group a ``fake`` one of ``n`` ranks
    (this process rank 0), replacing a fake group of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is in place: the "
                f"production mesh stands on stand-in ranks of its own")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production mesh on stand-in ranks (CPU device
    type: nothing is placed on a card)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _fake_world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1) -> DeviceMesh:
    """``(data, model)`` over the ranks of the caller's process group
    (one device each: CUDA under an NCCL group, else the CPU); the
    model axis falls back to 1 where ``model_parallel`` does not divide
    the world."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh spans the caller's process group: call "
            "torch.distributed.init_process_group first (e.g. "
            "init_method='tcp://localhost:<port>', its rank and world "
            "size)")
    n = dist.get_world_size()
    mp = model_parallel if n % model_parallel == 0 else 1
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev, (n // mp, mp),
                            mesh_dim_names=("data", "model"))


def mesh_devices(mesh: DeviceMesh) -> int:
    return int(mesh.size())
