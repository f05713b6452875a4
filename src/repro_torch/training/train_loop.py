"""Training loop: train step + checkpoint/restart + optional int8
gradient compression, for every family the port trains: the basecaller
(its BatchNorm state threads through TrainCarry) and the LMs (every
block kind; ``model_state`` is ``{}``).

On one device, or over a ``(data=n, model=M)`` mesh
(``launch/mesh.make_host_mesh``, one process a device).

Data-parallel over ``data``: each data rank takes its own rows of the
same global batch (its share of every microbatch), the gradients are
averaged over the data group (before the int8 round trip, which acts
on the reduced gradient as the reference's acts on the global one), and
every rank applies the same update. The statistics that read the batch
(BatchNorm's mean and variance, per-tensor activation fake-quant's
amax) reduce over the data group while the gradients are taken
(``parallel/data_parallel.py``), and the losses average exactly
because every rank's rows are as many.

Tensor-parallel over ``model`` (M > 1; ``parallel/tensor_parallel.py``):
the model ranks of one data rank take the same rows, every rank draws
the whole tree from the same seed and keeps its shard of each leaf
that a unit splits (attention and MLA heads, cross-attention heads,
SSM heads with the B and C segments of their leaves whole, the MLP's
hidden width, the vocabulary, the experts), and the model code sums the
split units over the model group where the reference pins activations
on ``model``; the optimizer's norm and the int8 round trip's scales
read the whole leaves through the same group. Every LM block kind
splits. The basecaller, which the reference keeps whole on ``model``,
replicates over it.

Either way the step equals the one-process step on the global batch,
up to the order of fp32 sums. Checkpoints hold whole leaves.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.parallel import data_parallel
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.training import grad_compress
from repro_torch.training.checkpoint import CheckpointManager, snapshot
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    n_micro: int = 1
    grad_compress_bits: int = 0    # 0 = off; 8 = int8 + error feedback
    resume: bool = True


def step_grads(loss_fn: Callable, params, mstate, batch: Dict,
               n_micro: int, group=None):
    """(gradients, loss, model state) of one step on this rank's rows
    (``api.microbatch_grads``), averaged over the data group ``group``
    (``None``: one process), which the batch statistics reduce over.
    Under ``tensor_parallel.over_model`` the gradients are this rank's
    shards'."""
    with data_parallel.batch_stats_over(group):
        grads, loss, mstate = api.microbatch_grads(loss_fn, params, mstate,
                                                   batch, n_micro)
    if group is not None:
        grads, loss = data_parallel.mean_over(group, grads, loss)
    return grads, loss, mstate


def make_compressed_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                               n_micro: int, *, group=None, model_group=None,
                               split=None, compress: bool = True
                               ) -> Callable:
    """The loop's train step, ``(carry, err_state, batch) -> (carry,
    err_state, metrics)``: ``api.make_train_step``'s (the averaged
    gradients of ``n_micro`` microbatches, one AdamW update), with the
    gradients round-tripped through int8 with error feedback before the
    optimizer; ``compress=False`` leaves the round trip out
    (``err_state`` passes through).

    ``group``: the data group of a data-parallel step, over which the
    batch statistics reduce and the gradients and loss are averaged
    before the round trip (``batch`` is this rank's rows).
    ``model_group``: the model group of a tensor-parallel step, whose
    split units (``split``: the carry's split dims,
    ``tensor_parallel.split_dims``) reduce over it."""
    loss_fn = api.make_loss_fn(cfg)

    def train_step(carry, err_state, batch):
        params, opt_state, mstate = carry
        with tp.over_model(model_group):
            grads, loss, mstate = step_grads(loss_fn, params, mstate,
                                             batch, n_micro, group)
            if compress:
                grads, err_state = grad_compress.roundtrip_tree(
                    grads, err_state, split)
            new_params, new_opt, om = adamw_update(
                params, grads, opt_state, opt_cfg, split=split)
        return (api.TrainCarry(new_params, new_opt, mstate), err_state,
                {"loss": loss, **om})

    return train_step


def _mesh_group(mesh, cfg: ModelConfig):
    """(the data group, this rank's index on ``data``, its size; the
    model group, this rank's index on ``model``, its size) of a
    ``(data, model)`` mesh. The model group is None where nothing
    splits over it: a model axis of 1, or the basecaller, which
    replicates over it. Any other mesh raises."""
    from repro_torch.parallel.sharding import axis_sizes, model_coordinate
    group = mesh.get_group("data")
    data = (mesh.get_local_rank("data"), axis_sizes(mesh)["data"])
    mrank, m = model_coordinate(mesh)
    if m == 1 or cfg.family == "basecaller":
        return group, *data, None, mrank, m
    if set(mesh.mesh_dim_names) != {"data", "model"}:
        raise NotImplementedError(
            f"the loop trains on a (data, model) mesh "
            f"(launch/mesh.make_host_mesh), not {mesh.mesh_dim_names}")
    return group, *data, mesh.get_group("model"), mrank, m


def _rows(batch: Dict, rank: int, n: int, n_micro: int = 1) -> Dict:
    """This rank's rows of a global batch (numpy or torch leaves): its
    share of each of the ``n_micro`` microbatches, in order. The
    one-process step cuts the global batch into contiguous microbatches
    (``api.microbatch_grads``), so global microbatch ``i`` is every
    rank's ``i``-th piece, and the statistics a microbatch takes over
    the data group are that microbatch's."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % (n * n_micro):
            raise ValueError(
                f"a global batch of {v.shape[0]} rows ({k!r}) does not "
                f"split into {n_micro} microbatches over {n} "
                f"data-parallel ranks")
        b = v.shape[0] // (n * n_micro)
        out[k] = v.reshape((n_micro, n, b) + v.shape[1:])[:, rank].reshape(
            (n_micro * b,) + v.shape[1:])
    return out


def run(cfg: ModelConfig, opt_cfg: AdamWConfig, loop: TrainLoopConfig,
        data_iter: Iterator[Dict], gen: Optional[torch.Generator] = None,
        *, device=None, mesh=None) -> Dict[str, Any]:
    """Train for ``loop.steps`` on ``device`` (CUDA unless the caller
    asks for the CPU); returns the final carry, the metric history and
    the checkpoint manager. Params are drawn in fp32 (the master leaves
    AdamW updates; an LM computes in ``cfg.dtype``) from ``gen``, seed 0
    by default: the basecaller draws on the CPU (``gen`` a CPU
    generator), an LM on ``gen``'s device, by default ``device``, so a
    full-width tree is drawn on the card; the params then move to
    ``device``. The run resumes from the
    latest valid checkpoint in ``loop.ckpt_dir``. Batches move to the
    device as they are taken; metrics are read back (``float``) only on
    logged steps: rows of ``loss``, ``grad_norm``, ``lr``, ``step`` and
    ``wall_s``.

    ``mesh``: a ``(data=n, model=M)`` mesh over the caller's process
    group (``launch/mesh.make_host_mesh``): the step is data-parallel
    over ``data`` and tensor-parallel over ``model`` (module
    docstring); ``data_iter`` yields the same global batch on every
    rank, whose rows ``n * loop.n_micro`` must divide, and each data
    rank takes its share of every microbatch (:func:`_rows`); ``device``
    defaults to the mesh's (the current CUDA device under NCCL; a gloo
    group's ranks may share one card, ``device="cuda"``). Every rank
    draws the same whole tree from the same seed, keeps its shards
    (``carry`` holds them) and restores its shards of the same whole
    checkpoint; the model group of data rank 0 gathers whole leaves and
    rank 0 alone writes them, and no rank returns before its writes
    have landed (barriers after the last)."""
    group, drank, n, mgroup, mrank, m = None, 0, 1, None, 0, 1
    if mesh is not None:
        group, drank, n, mgroup, mrank, m = _mesh_group(mesh, cfg)
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if mesh.device_type == "cuda" else mesh.device_type)
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device="cpu" if cfg.family == "basecaller"
                              else dev).manual_seed(0)
    params = tree_map(lambda t: t.to(dev),
                      api.init_params(gen, cfg, dtype=torch.float32))
    dims = None
    if mgroup is not None:
        dims = tp.split_dims(params, cfg, m)
        params = tp.shard_tree(params, dims, mrank, m)
    key_dim = tp.carry_key_dims(dims) if dims is not None else None
    mstate = tree_map(lambda t: t.to(dev), api.init_model_state(cfg))
    carry = api.TrainCarry(params, init_opt_state(params, opt_cfg), mstate)
    err_state = (grad_compress.init_error_state(params)
                 if loop.grad_compress_bits == 8 else None)

    ckpt = CheckpointManager(loop.ckpt_dir)
    start_step = 0
    if loop.resume and ckpt.latest_valid() is not None:
        start_step, carry = ckpt.restore(carry, shard=None if dims is None
                                         else lambda k, t: tp.shard(
                                             t, key_dim(k), mrank, m))

    step_fn = make_compressed_train_step(
        cfg, opt_cfg, loop.n_micro, group=group, model_group=mgroup,
        split=dims, compress=loop.grad_compress_bits == 8)

    history = []
    t0 = time.time()
    for step in range(start_step, loop.steps):
        batch = next(data_iter)
        if group is not None:
            batch = _rows(batch, drank, n, loop.n_micro)
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                 for k, v in batch.items()}
        carry, err_state, metrics = step_fn(carry, err_state, batch)
        if (step + 1) % loop.log_every == 0 or step == loop.steps - 1:
            row = {k: float(v) for k, v in metrics.items()}   # sync: logged
            row["step"] = step + 1
            row["wall_s"] = round(time.time() - t0, 2)
            history.append(row)
        if (step + 1) % loop.ckpt_every == 0 and drank == 0:
            if mgroup is None:
                if mrank == 0:
                    ckpt.save_async(step + 1, carry)
            else:
                # every rank of data rank 0's model group gathers; the
                # first writes
                flat = {k: tp.whole(t, key_dim(k), mgroup)
                        for k, t in snapshot(carry).items()}
                if mrank == 0:
                    ckpt.save_flat_async(step + 1, flat)
    ckpt.wait()
    if group is not None:
        # no rank returns (and may restore) before rank 0's writes land:
        # its model group waits for it, then each data group for those
        nccl = dist.get_backend(group) == "nccl"
        for g in (mesh.get_group("model"), group):
            dist.barrier(g, device_ids=[dev.index] if nccl else None)
    return {"carry": carry, "history": history, "ckpt": ckpt}
