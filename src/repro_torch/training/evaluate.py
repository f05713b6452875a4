"""Training and evaluation harness: short basecaller training on the
squiggle simulator + read-identity evaluation (the offline stand-in for
the paper's ONT accuracy metric; relative orderings are the target).
The port's twin of the JAX repository's ``benchmarks/common.py``.

``eval_identity`` takes float or packed params: packed int8 weights
basecall through ``qconv1d_block`` wherever ``sep_conv``'s gate holds.
Everything runs on the device the params lie on.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import tree_leaves, tree_map
from repro_torch.data.align import identity
from repro_torch.data.squiggle import SquiggleConfig, batches
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.basecaller import model as bc
from repro_torch.models.basecaller.ctc import ctc_loss, greedy_decode
from repro_torch.training.optimizer import AdamWConfig, init_opt_state

CHUNK = 512
BATCH = 8

# Benchmark-scale simulator: 3-mer pore model, fixed dwell, low noise —
# chosen so smoke-scale models reach non-trivial read identity in a
# short run. Relative orderings (quant/prune/skipclip deltas) are the
# validation target, not ONT-absolute accuracy.
SIM = dict(chunk_len=CHUNK, k=3, dwell_jitter=False, mean_dwell=8.0,
           noise=0.08, drift=0.0)


def data_iter(seed: int = 0) -> Iterator[dict]:
    """Numpy batches of :data:`BATCH` simulated chunks (the reference
    harness's, batch for batch)."""
    yield from batches(SquiggleConfig(seed=1234 + seed, **SIM), BATCH)


def _on(batch: dict, dev) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _device_of(params) -> torch.device:
    leaf = tree_leaves(params)[0]
    return getattr(leaf, "data", leaf).device


def train_model(cfg: ModelConfig, steps: int = 300, lr: float = 5e-3,
                seed: int = 0, *, device=None) -> Tuple[dict, dict, float]:
    """AdamW (warmup 3, cosine over ``steps``) on :func:`data_iter` on
    ``device`` (CUDA unless the caller asks for the CPU), from params
    drawn by ``torch.Generator().manual_seed(seed)``. Returns (params,
    BatchNorm state, final loss)."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), api.init_params(
        torch.Generator().manual_seed(seed), cfg))
    state = tree_map(lambda t: t.to(dev), api.init_model_state(cfg))
    opt = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=3)
    step = api.make_train_step(cfg, opt, n_micro=1)
    carry = api.TrainCarry(params, init_opt_state(params, opt), state)
    it = data_iter(seed)
    m = {"loss": torch.tensor(float("nan"))}
    for _ in range(steps):
        carry, m = step(carry, _on(next(it), dev))
    return carry.params, carry.model_state, float(m["loss"])


def basecall(cfg: ModelConfig, params, state, n_batches: int = 4,
             seed: int = 77) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(greedy call, truth) of every read in ``n_batches`` held-out
    batches, eval-mode forward on the params' device."""
    dev = _device_of(params)
    it = data_iter(seed)
    out = []
    for _ in range(n_batches):
        b = next(it)
        with torch.inference_mode():
            lp, _ = bc.forward(params, state, torch.from_numpy(
                b["signal"]).to(dev), cfg, train=False)
        calls = greedy_decode(lp.cpu().numpy())
        out += [(call, lab[:ln]) for call, lab, ln in
                zip(calls, b["labels"], b["label_lengths"])]
    return out


def eval_identity(cfg: ModelConfig, params, state, n_batches: int = 4,
                  seed: int = 77) -> float:
    """Mean read identity of greedy-decoded calls vs truth."""
    return float(np.mean([identity(call, truth) for call, truth in
                          basecall(cfg, params, state, n_batches, seed)]))


def eval_ctc_loss(cfg: ModelConfig, params, state, n_batches: int = 4,
                  seed: int = 77) -> float:
    """Mean eval-mode CTC loss over ``n_batches`` held-out batches."""
    dev = _device_of(params)
    it = data_iter(seed)
    tot = []
    for _ in range(n_batches):
        b = _on(next(it), dev)
        with torch.inference_mode():
            lp, _ = bc.forward(params, state, b["signal"], cfg, train=False)
            tot.append(float(ctc_loss(lp, b["labels"], b["label_lengths"])))
    return float(np.mean(tot))
