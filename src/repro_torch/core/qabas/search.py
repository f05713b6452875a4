"""QABAS bilevel search loop.

Alternates:
  1. weight step  — minimise CTC loss on D_train at sampled paths;
  2. arch step    — minimise CTC(D_eval) + lambda * (E[lat] - L_tar)/L_tar
                    wrt alpha/beta (paper's L_QABAS, lambda = 0.6).

``derive_config`` takes the argmax op / quant per block and emits a
:class:`ModelConfig` of the basecaller family — the RUBICALL candidate
that is then retrained to convergence (with SkipClip/KD).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, QuantPolicy
from repro_torch.core.qabas.latency import expected_latency, latency_table
from repro_torch.core.qabas.space import SearchSpace
from repro_torch.core.qabas.supernet import (init_arch_params, init_supernet,
                                             sample_paths, supernet_forward)
from repro_torch.core.quant.policy import tree_map
from repro_torch.device import resolve_device
from repro_torch.models.api import value_and_grad
from repro_torch.models.basecaller.ctc import ctc_loss
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)


@dataclasses.dataclass(frozen=True)
class QABASConfig:
    lam: float = 0.6              # paper's lambda
    target_latency: float = 5e-4  # L_tar (s), the reference's default
    lr_w: float = 2e-3            # paper's AdamW settings
    lr_arch: float = 3e-3
    channels: int = 64
    chunk: int = 512
    steps: int = 40
    batch: int = 8


def run_search(gen: Optional[torch.Generator], space: SearchSpace,
               qc: QABASConfig, data_iter: Iterator[Dict], *,
               device=None) -> Tuple[Dict, Dict, Dict]:
    """Returns (supernet_params, arch_params, history) on ``device``
    (CUDA unless the caller asks for the CPU). ``gen`` (a CPU
    ``torch.Generator``, seed 0 by default) draws the supernet and every
    step's path samples. Each step reads its sampled paths and its three
    history values back to the host."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0) if gen is None else gen
    params = tree_map(lambda t: t.to(dev),
                      init_supernet(gen, space, channels=qc.channels))
    arch = tree_map(lambda t: t.to(dev), init_arch_params(space))
    opt_w_cfg = AdamWConfig(lr=qc.lr_w, total_steps=qc.steps, warmup_steps=0,
                            schedule="const")
    opt_a_cfg = AdamWConfig(lr=qc.lr_arch, total_steps=qc.steps,
                            warmup_steps=0, schedule="const",
                            weight_decay=0.0)
    opt_w = init_opt_state(params, opt_w_cfg)
    opt_a = init_opt_state(arch, opt_a_cfg)
    table = latency_table(space, chunk=qc.chunk, channels=qc.channels)

    def ctc_of(params_, arch_, batch, op_idx, q_idx):
        logp = supernet_forward(params_, arch_, batch["signal"], op_idx,
                                q_idx, space)
        return ctc_loss(logp, batch["labels"], batch["label_lengths"])

    def w_obj(params_, arch_, batch, op_idx, q_idx):
        return ctc_of(params_, arch_, batch, op_idx, q_idx), ()

    def arch_obj(arch_, params_, batch, op_idx, q_idx):
        l_train = ctc_of(params_, arch_, batch, op_idx, q_idx)
        lat = expected_latency(torch.softmax(arch_["alpha"], dim=-1),
                               torch.softmax(arch_["beta"], dim=-1), table)
        l_reg = (lat - qc.target_latency) / qc.target_latency
        return l_train + qc.lam * l_reg, (l_train, lat)

    def on_dev(batch):
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    hist = {"w_loss": [], "a_loss": [], "latency": []}
    for _ in range(qc.steps):
        batch = on_dev(next(data_iter))
        op_idx, q_idx = sample_paths(gen, arch, space)
        (lw, _), g = value_and_grad(w_obj, params, arch, batch, op_idx, q_idx)
        params, opt_w, _ = adamw_update(params, g, opt_w, opt_w_cfg)
        ev = on_dev(next(data_iter))
        op_idx, q_idx = sample_paths(gen, arch, space)
        (la, (_, lat)), g = value_and_grad(arch_obj, arch, params, ev,
                                           op_idx, q_idx)
        arch, opt_a, _ = adamw_update(arch, g, opt_a, opt_a_cfg)
        hist["w_loss"].append(float(lw))
        hist["a_loss"].append(float(la))
        hist["latency"].append(float(lat))
    return params, arch, hist


def derive_config(arch: Dict, space: SearchSpace, *, channels: int,
                  name: str = "qabas-derived") -> ModelConfig:
    """argmax over alpha/beta -> concrete basecaller ModelConfig."""
    ops = arch["alpha"].argmax(dim=-1).tolist()
    quants = arch["beta"].argmax(dim=-1).tolist()
    kernels, overrides = [], []
    b_out = 0
    for b in range(space.n_blocks):
        oi = ops[b]
        if space.include_identity and oi == len(space.kernel_options):
            continue      # identity: layer removed
        kernels.append(space.kernel_options[oi])
        overrides.append((f"block{b_out:02d}", tuple(
            int(v) for v in space.quant_options[quants[b]])))
        b_out += 1
    n = len(kernels)
    if n == 0:            # degenerate search — keep one block
        kernels, overrides, n = [space.kernel_options[0]], \
            [("block00", space.quant_options[0])], 1
    return ModelConfig(
        name=name, family="basecaller", n_layers=n, d_model=channels,
        n_blocks=n, channels=(channels,) * n, kernel_sizes=tuple(kernels),
        strides=(3,) + (1,) * (n - 1), repeats=(1,) * n, use_skips=False,
        n_bases=5, vocab_size=5,
        quant=QuantPolicy(weight_bits=8, act_bits=8,
                          overrides=tuple(overrides)),
        source="QABAS search output")
