"""AdamW by hand + schedules + optional 8-bit optimizer-state
quantization (the paper's quantization theme applied to training state).

Written out rather than taken from ``torch.optim.AdamW``, which has no
int8 state and applies the decay in another order: this update is
``p - lr * (u + wd * p)`` with ``u = (m / b1c) / (sqrt(v / b2c) + eps)``,
as the reference's. State mirrors the param tree (nested dicts and
lists); every value stays on the params' device, the step and the
metrics as 0-d tensors, so an update reads nothing back to the host.

Over a tensor-parallel model group (``parallel/tensor_parallel``) a
rank holds its shards of the split leaves: ``split`` names them (a
split dim, or the segments of a leaf split in part), and the two
reductions that read a whole leaf (the global norm's sum of squares, an
int8 moment's scale) take the group's sum or maximum, so every rank's
update is its shard of the one-process update.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.quant.policy import tree_leaves, tree_map
from repro_torch.parallel import tensor_parallel as tp


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 2e-3              # paper's QABAS setting
    b1: float = 0.9
    b2: float = 0.999             # paper's beta
    eps: float = 1e-8             # paper's epsilon
    weight_decay: float = 0.01    # paper's weight decay
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"      # "cosine" | "linear" | "const"
    state_bits: int = 0           # 0 = fp32 m/v; 8 = int8-quantized m/v


class OptState(NamedTuple):
    step: torch.Tensor            # 0-d int32
    m: Any
    v: Any
    m_scale: Any                  # per-leaf scales when state_bits == 8
    v_scale: Any


def _q8(x: torch.Tensor, split=None) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = x.abs().amax()
    if split is not None:
        tp.all_max_(amax)
    s = amax.clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(x / s), -128, 127).to(torch.int8), s


def _dq8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup, then cosine, linear or constant; fp32 0-d tensor."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule in ("cosine", "linear"):
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        decay = (0.5 * (1 + torch.cos(math.pi * frac))
                 if cfg.schedule == "cosine" else 1.0 - frac)
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def init_opt_state(params, cfg: AdamWConfig) -> OptState:
    """Zero m and v (independent tensors) on each param's device."""
    dev = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.state_bits == 8:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.int8, device=p.device)

        def ones(p):
            return torch.ones((), dtype=torch.float32, device=p.device)
        return OptState(step, tree_map(zeros, params),
                        tree_map(zeros, params), tree_map(ones, params),
                        tree_map(ones, params))

    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(step, tree_map(zeros32, params),
                    tree_map(zeros32, params), None, None)


def clip_by_global_norm(grads, max_norm: float, split=None):
    """``(grads * min(1, max_norm / |grads|), |grads|)``: the global L2
    norm over every leaf, in fp32. ``split``: how a tensor-parallel
    rank's leaves split over the model group
    (``tensor_parallel.split_dims``; None: nothing split): the sums of
    squares of split leaves and split segments are summed over the
    group, and whole leaves' and whole segments' counted once."""
    leaves = tree_leaves(grads)
    splits = ([None] * len(leaves) if split is None
              else tree_leaves(split))
    total, parts = 0, []
    for g, s in zip(leaves, splits):
        mine, whole = tp.split_parts(g, s)
        total = total + sum(w.float().square().sum() for w in whole)
        parts += [p.float().square().sum() for p in mine]
    if parts:
        total = total + tp.all_reduce_(sum(parts))
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / gn.clamp_min(1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def adamw_update(params, grads, state: OptState, cfg: AdamWConfig, *,
                 split=None):
    """Returns (new_params, new_state, metrics). Params may be bf16 — the
    update math runs in fp32 and casts back. New tensors throughout (no
    in-place update), so a snapshot of the old carry stays valid.
    ``split``: the split dims of a tensor-parallel rank's leaves (module
    docstring)."""
    if split is None:
        split = tree_map(lambda _: None, params)
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, split)
        step = state.step + 1
        lr = schedule_lr(cfg, step)
        sf = step.float()
        b1c = 1 - torch.pow(torch.full_like(sf, cfg.b1), sf)
        b2c = 1 - torch.pow(torch.full_like(sf, cfg.b2), sf)

        def moments(g, m, v):
            gf = g.float()
            return (cfg.b1 * m + (1 - cfg.b1) * gf,
                    cfg.b2 * v + (1 - cfg.b2) * gf * gf)

        def apply(p, m, v):
            u = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            pf = p.float()
            return (pf - lr * (u + cfg.weight_decay * pf)).to(p.dtype)

        def pick(tree, i):
            return tree_map(lambda t: t[i], tree)

        if cfg.state_bits == 8:
            def upd(p, g, mq, vq, ms, vs, dim):
                m, v = moments(g, _dq8(mq, ms), _dq8(vq, vs))
                return (apply(p, m, v),) + _q8(m, dim) + _q8(v, dim)
            out = tree_map(upd, params, grads, state.m, state.v,
                           state.m_scale, state.v_scale, split)
            new_state = OptState(step, pick(out, 1), pick(out, 3),
                                 pick(out, 2), pick(out, 4))
        else:
            def upd(p, g, m, v):
                m, v = moments(g, m, v)
                return apply(p, m, v), m, v
            out = tree_map(upd, params, grads, state.m, state.v)
            new_state = OptState(step, pick(out, 1), pick(out, 2), None,
                                 None)
    return pick(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}
