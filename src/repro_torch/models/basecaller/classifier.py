"""Read-until start-of-read classifier: a small strided CNN that scores
whether a read's early squiggle looks on-target (the port's twin of
``repro.models.basecaller.classifier``).

Selective sequencing ("read-until") wants to reject off-target reads
after the first chunks, before the basecaller wastes compute on the
whole read. This head is deliberately tiny — two strided convs, a
global mean pool, and a linear logit — so the serving runner runs it
in the basecall tick, on the same device and the same ``(B, W, 1)``
windows the basecaller already materialized. The mean pool makes it
window-length independent: the same params score any chunk geometry
(core/halo/stride).

Positive logits mean on-target. Training is a few hundred full-batch
SGD steps of sigmoid cross-entropy on labeled windows (:func:`fit`, the
slice's only autograd); :func:`make_training_set` builds the synthetic
set — pore-model reads (label 1) vs med/MAD-normalized white noise
(label 0), separable by local signal statistics (pore dwell makes
squiggle step-wise constant; amplitude alone cannot separate them after
normalization).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.models.basecaller import blocks as bl

Params = Dict[str, torch.Tensor]


def init_params(gen: torch.Generator, channels: Tuple[int, int] = (8, 16),
                kernel: int = 5) -> Params:
    """Classifier head params (window-length independent), fp32 on the
    CPU, drawn from ``gen`` (a CPU ``torch.Generator``)."""
    c0, c1 = channels
    return {
        "conv0": bl.make_conv_params(gen, kernel, 1, c0),
        "conv1": bl.make_conv_params(gen, kernel, c0, c1),
        "head_w": bl.truncated_normal_init(gen, (c1, 1)),
        "head_b": torch.zeros((1,), dtype=torch.float32),
    }


def forward(params: Params, window: torch.Tensor) -> torch.Tensor:
    """``window``: (B, W, 1) squiggle -> (B,) on-target logits."""
    h = torch.relu(bl.conv1d(window.float(), params["conv0"], stride=4))
    h = torch.relu(bl.conv1d(h, params["conv1"], stride=4))
    g = h.mean(dim=1)                             # length-free pooling
    return (g @ params["head_w"])[:, 0] + params["head_b"][0]


def fit(params: Params, windows, labels, *, steps: int = 200,
        lr: float = 0.1) -> Tuple[Params, float]:
    """Full-batch SGD on sigmoid cross-entropy, on the device the params
    lie on. ``windows``: (N, W, 1) float32, ``labels``: (N,) in {0, 1}.
    Returns (params, final loss)."""
    dev = params["head_b"].device
    x = torch.as_tensor(np.asarray(windows, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(labels, np.float32), device=dev)
    params = {k: v.detach().clone() for k, v in params.items()}
    loss = float("nan")
    for _ in range(int(steps)):
        for v in params.values():
            v.requires_grad_(True)
        z = forward(params, x)
        l = torch.mean(torch.logaddexp(z.new_zeros(()), z) - y * z)
        grads = torch.autograd.grad(l, list(params.values()))
        with torch.no_grad():
            params = {k: v - lr * g
                      for (k, v), g in zip(params.items(), grads)}
        # sync: the reference returns the final loss as a host float
        loss = float(l.detach())
    return params, loss


def make_training_set(rs: np.random.RandomState, window_len: int,
                      n_per_class: int = 48, noise: float = 0.1
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Labeled windows: pore-model squiggle (on-target, label 1) vs
    white noise (off-target, label 0), both med/MAD normalized."""
    from repro_torch.data.squiggle import (SquiggleConfig, normalize,
                                           pore_table, simulate_read)
    sim = SquiggleConfig(noise=noise, drift=0.0)
    table = pore_table()
    xs, ys = [], []
    for _ in range(int(n_per_class)):
        n_bases = max(window_len // 6, 8)     # dwell ~9 => >= window_len
        sig, _ = simulate_read(rs, sim, table, n_bases)
        sig = normalize(sig)
        if sig.shape[0] < window_len:
            sig = np.pad(sig, (0, window_len - sig.shape[0]))
        off = int(rs.randint(0, sig.shape[0] - window_len + 1))
        xs.append(sig[off:off + window_len])
        ys.append(1.0)
        xs.append(normalize(rs.randn(window_len).astype(np.float32)))
        ys.append(0.0)
    x = np.stack(xs)[:, :, None].astype(np.float32)
    return x, np.asarray(ys, np.float32)
