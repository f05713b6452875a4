"""Basecaller model family: RUBICALL (skip-free, mixed-precision), the
Bonito-style teacher (skips, FP), and the Causalcall-style TCN — one
parametric implementation driven by :class:`ModelConfig`.

Input: normalized squiggle chunks (B, S, 1). Output: CTC log-probs
(B, S/stem_stride, 5).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.basecaller import blocks as bl
from repro_torch.models.basecaller.blocks import Params, State


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """fp32 CPU parameters drawn from ``gen`` (a CPU ``torch.Generator``)."""
    p: Params = {}
    c_in = 1
    for i in range(cfg.n_blocks):
        p[f"block{i:02d}"] = bl.make_block_params(gen, cfg, i, c_in)
        c_in = cfg.channels[i]
    p["head_pw"] = bl.truncated_normal_init(gen, (1, c_in, cfg.n_bases))
    return p


def init_state(cfg: ModelConfig) -> State:
    return {f"block{i:02d}": bl.block_state(cfg, i)
            for i in range(cfg.n_blocks)}


def forward(params: Params, state: State, signal: torch.Tensor,
            cfg: ModelConfig, *, train: bool = True,
            skip_gates: Optional[torch.Tensor] = None,
            bounds=None) -> Tuple[torch.Tensor, State]:
    """signal: (B, S, 1) -> (log_probs (B, T, n_bases) fp32, new_state).

    ``skip_gates``: (n_blocks,) in [0,1] — SkipClip's anneal handle.
    ``bounds``: optional ``(start, read_len)`` for chunked serving: the
    window anchors global sample ``start`` (negative at the read head)
    of a ``read_len``-sample read, and positions outside the read are
    re-zeroed before every K > 1 conv so chunked outputs match the
    whole-read forward.
    """
    x = signal.to(getattr(torch, cfg.dtype))
    new_state: State = {}
    causal = cfg.name.startswith("causalcall")
    s_in = 1
    for i in range(cfg.n_blocks):
        gate = None if skip_gates is None else skip_gates[i]
        dilation = 2 ** (i % 5) if causal else 1
        x, ns = bl.block_forward(params[f"block{i:02d}"],
                                 state[f"block{i:02d}"], x, cfg, i,
                                 train=train, skip_gate=gate,
                                 dilation=dilation, causal=causal,
                                 bounds=bounds, s_in=s_in)
        new_state[f"block{i:02d}"] = ns
        s_in *= int(cfg.strides[i])
    logits = bl.conv1d(x, bl.conv_kernel_of(params["head_pw"], x.dtype))
    return torch.log_softmax(logits.float(), dim=-1), new_state


# ---------------------------------------------------------------------------
# Chunked basecalling — the serving BasecallerRunner's substrate.
#
# A read is processed as fixed-size CORE windows of ``core`` samples,
# each padded with a HALO of real neighbouring samples on both sides.
# Every op is local (convs) or positionwise (BN-eval, ReLU,
# log-softmax), so a core frame whose receptive field lies inside the
# padded window equals the whole-read forward's frame.


def total_stride(cfg: ModelConfig) -> int:
    """Cumulative downsampling squiggle samples -> CTC frames."""
    s = 1
    for st in cfg.strides[:cfg.n_blocks]:
        s *= int(st)
    return s


def receptive_field(cfg: ModelConfig) -> int:
    """Receptive field of one output frame, in input samples (conv
    dilation — causalcall — and strides accounted)."""
    causal = cfg.name.startswith("causalcall")
    r, s = 1, 1
    for i in range(cfg.n_blocks):
        dil = 2 ** (i % 5) if causal else 1
        for j in range(cfg.repeats[i]):
            r += (cfg.kernel_sizes[i] - 1) * dil * s
            if j == 0:
                s *= int(cfg.strides[i])
    return r


def chunk_halo(cfg: ModelConfig) -> int:
    """Halo (samples each side) that keeps core frames exact: the full
    receptive field, rounded up to a stride multiple."""
    st = total_stride(cfg)
    return -(-receptive_field(cfg) // st) * st


def chunk_windows(signal: np.ndarray, core: int, halo: int, stride: int
                  ) -> List[Tuple[np.ndarray, int, int]]:
    """Slice one read into model-input windows.

    signal: (S,) float squiggle (normalized). Returns a list of
    ``(window (core + 2*halo, 1) float32, n_frames, n_samples)`` —
    ``n_frames`` core CTC frames are valid (``ceil(n_samples/stride)``).
    """
    sig = np.asarray(signal, np.float32).reshape(-1)
    S = sig.shape[0]
    out: List[Tuple[np.ndarray, int, int]] = []
    W = core + 2 * halo
    for a in range(0, S, core):
        valid = min(core, S - a)
        window = np.zeros((W, 1), np.float32)
        lo, hi = a - halo, a + core + halo
        src = sig[max(lo, 0):min(hi, S)]
        off = max(lo, 0) - lo
        window[off:off + src.shape[0], 0] = src
        out.append((window, -(-valid // stride), valid))
    return out


def forward_window(params: Params, state: State, window: torch.Tensor,
                   cfg: ModelConfig, start, read_len) -> torch.Tensor:
    """Eval-mode forward over padded windows (B, W, 1) -> CTC log-probs
    (B, W/stride, n_bases). ``start``/``read_len`` are scalars or
    ``(B,)`` tensors (one row per co-batched serving slot)."""
    log_probs, _ = forward(params, state, window, cfg, train=False,
                           bounds=(start, read_len))
    return log_probs
