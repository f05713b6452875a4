"""Whisper-style encoder (the port's counterpart of
``repro.models.lm.encdec``): bidirectional attention blocks over stub
audio frame embeddings.

The conv frontend is a stub, as in the reference: the caller supplies
precomputed log-mel frame embeddings ``(B, n_frames, d_model)``; the
encoder adds sinusoidal positions and runs ``cfg.n_enc_layers`` blocks
of norm -> attention (not causal) -> norm -> GELU MLP. Outside training
each block's attention runs ``ops.flash_attention(causal=False)``, the
CUDA kernel on a card; ``train=True`` runs the differentiable
``blockwise_attn``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import Packer
from repro_torch.models.lm import attention as attn_mod
from repro_torch.models.lm.common import (Params, make_mlp_params,
                                          make_rmsnorm_params, mlp, rmsnorm)
from repro_torch.models.lm.transformer import layer_views


def sinusoidal(n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) fp32: the sines of every position over ``10000 ** (2 i /
    d)``, then the cosines (halves concatenated, not interleaved)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_encoder(gen: torch.Generator, cfg: ModelConfig, *,
                 dtype=torch.float32, pack: Optional[Packer] = None) -> Params:
    """Layer-stacked encoder blocks (``ln1``, ``attn``, ``ln2`` and an
    ungated ``ffn``) and ``final_norm``, drawn on ``gen``'s device;
    ``pack`` packs each projection as it is drawn (tags under
    ``encoder/blocks/``)."""
    d, n = cfg.d_model, cfg.n_enc_layers
    norm = dict(lead=(n,), dtype=dtype, device=gen.device)
    kw = dict(lead=(n,), dtype=dtype)
    blocks = {"ln1": make_rmsnorm_params(d, **norm),
              "attn": attn_mod.make_attn_params(gen, cfg, **kw),
              "ln2": make_rmsnorm_params(d, **norm),
              "ffn": make_mlp_params(gen, d, cfg.d_ff, gated=False, **kw)}
    if pack is not None:
        for name in ("attn", "ffn"):
            blocks[name] = pack.tree(blocks[name],
                                     f"encoder/blocks/{name}/")
    return {"blocks": blocks,
            "final_norm": make_rmsnorm_params(d, dtype=dtype,
                                              device=gen.device)}


def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig, *,
           train: bool = False) -> torch.Tensor:
    """frames: (B, F, d) stub embeddings -> (B, F, d) encoder states in
    ``cfg.dtype``. ``train``: the differentiable attention, each block
    rematerialised under ``cfg.remat``."""
    B, F, d = frames.shape
    dt = getattr(torch, cfg.dtype)
    x = frames.to(dt) + sinusoidal(F, d, frames.device).to(dt)[None]
    positions = torch.arange(F, dtype=torch.int32,
                             device=x.device)[None, :].expand(B, F)

    def step(pl, xc):
        h = rmsnorm(pl["ln1"], xc, cfg.norm_eps)
        a, _ = attn_mod.attn_forward(pl["attn"], h, positions, cfg,
                                     causal=False, train=train)
        xc = xc + a
        h2 = rmsnorm(pl["ln2"], xc, cfg.norm_eps)
        return xc + mlp(pl["ffn"], h2, cfg=cfg, tag="enc/mlp", act="gelu")

    remat = train and cfg.remat and torch.is_grad_enabled()
    for pl in layer_views(params["blocks"], cfg.n_enc_layers):
        x = (checkpoint(step, pl, x, use_reentrant=False) if remat
             else step(pl, x))
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)
