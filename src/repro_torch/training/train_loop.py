"""Training loop: train step + checkpoint/restart + optional int8
gradient compression, for every family the port trains: the basecaller
(its BatchNorm state threads through TrainCarry) and the LMs
(``dense``, ``moe``, ``ssm``; ``model_state`` is ``{}``). One device;
meshes are not ported.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.training import grad_compress
from repro_torch.training.checkpoint import CheckpointManager
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


def make_compressed_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                               n_micro: int) -> Callable:
    """train_step variant that round-trips the averaged gradients
    through int8 with error feedback before the optimizer:
    ``(carry, err_state, batch) -> (carry, err_state, metrics)``."""
    loss_fn = api.make_loss_fn(cfg)

    def train_step(carry, err_state, batch):
        params, opt_state, mstate = carry
        grads, loss, mstate = api.microbatch_grads(loss_fn, params, mstate,
                                                   batch, n_micro)
        grads, err_state = grad_compress.roundtrip_tree(grads, err_state)
        new_params, new_opt, om = adamw_update(params, grads, opt_state,
                                               opt_cfg)
        return (api.TrainCarry(new_params, new_opt, mstate), err_state,
                {"loss": loss, **om})

    return train_step


def run(cfg: ModelConfig, opt_cfg: AdamWConfig, loop: TrainLoopConfig,
        data_iter: Iterator[Dict], gen: Optional[torch.Generator] = None,
        *, device=None) -> Dict[str, Any]:
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
    ``wall_s``."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device="cpu" if cfg.family == "basecaller"
                              else dev).manual_seed(0)
    params = tree_map(lambda t: t.to(dev),
                      api.init_params(gen, cfg, dtype=torch.float32))
    mstate = tree_map(lambda t: t.to(dev), api.init_model_state(cfg))
    carry = api.TrainCarry(params, init_opt_state(params, opt_cfg), mstate)
    err_state = (grad_compress.init_error_state(params)
                 if loop.grad_compress_bits == 8 else None)

    ckpt = CheckpointManager(loop.ckpt_dir)
    start_step = 0
    if loop.resume and ckpt.latest_valid() is not None:
        start_step, carry = ckpt.restore(carry)

    if loop.grad_compress_bits == 8:
        step_fn = make_compressed_train_step(cfg, opt_cfg, loop.n_micro)
    else:
        base = api.make_train_step(cfg, opt_cfg, loop.n_micro)

        def step_fn(c, e, b):
            c2, m = base(c, b)
            return c2, e, m

    history = []
    t0 = time.time()
    for step in range(start_step, loop.steps):
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                 for k, v in next(data_iter).items()}
        carry, err_state, metrics = step_fn(carry, err_state, batch)
        if (step + 1) % loop.log_every == 0 or step == loop.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}   # sync: logged
            m["step"] = step + 1
            m["wall_s"] = round(time.time() - t0, 2)
            history.append(m)
        if (step + 1) % loop.ckpt_every == 0:
            ckpt.save_async(step + 1, carry)
    ckpt.wait()
    return {"carry": carry, "history": history, "ckpt": ckpt}
