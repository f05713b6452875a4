"""GQA attention for slot-batched serving over the paged KV pool (the
port's counterpart of the serving half of ``repro.models.lm.attention``).

Each layer's K/V bytes live in a shared block arena ``(n_blocks,
block_len, Hkv, hd)``; a host block table ``(B, T)`` maps each slot's
logical block to an arena block (-1 = unassigned) and positions stay
per slot (``pos: (n_slots, T * block_len)``), so a recycled block is
masked until its new owner writes it. The arena is updated in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.ops import decode_gqa
from repro_torch.kernels.paged_attention import (EMPTY_POS, PagedWrites,
                                                 paged_writes, put_rows,
                                                 quantize_kv)
from repro_torch.models.lm.common import Params, dense, make_dense_params
from repro_torch.models.lm.rope import apply_rope


def make_attn_params(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
                     dtype=torch.float32) -> Params:
    d, H, Hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    kw = dict(lead=lead, dtype=dtype)
    return {
        "wq": make_dense_params(gen, d, H * hd, bias=cfg.qkv_bias, **kw),
        "wk": make_dense_params(gen, d, Hkv * hd, bias=cfg.qkv_bias, **kw),
        "wv": make_dense_params(gen, d, Hkv * hd, bias=cfg.qkv_bias, **kw),
        "wo": make_dense_params(gen, H * hd, d, **kw),
    }


def _project_qkv(p: Params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig):
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = dense(p["wq"], x, cfg=cfg, tag="attn/wq").reshape(B, S, H, hd)
    kk = dense(p["wk"], x, cfg=cfg, tag="attn/wk").reshape(B, S, Hkv, hd)
    vv = dense(p["wv"], x, cfg=cfg, tag="attn/wv").reshape(B, S, Hkv, hd)
    rope = dict(head_dim=hd, theta=cfg.rope_theta, two_d=cfg.rope_2d)
    return (apply_rope(q, positions, **rope), apply_rope(kk, positions, **rope),
            vv)


def attn_ring_len(cfg: ModelConfig, cache_len: int, *,
                  window: int = 0) -> int:
    """Logical (ring) length a slot's block table must address."""
    return min(window, cache_len) if window > 0 else cache_len


def init_attn_cache_paged(cfg: ModelConfig, n_slots: int, cache_len: int,
                          n_blocks: int, block_len: int, *, window: int = 0,
                          dtype=torch.bfloat16, lead=(),
                          device=None) -> Dict:
    """Empty paged cache: arenas ``(*lead, n_blocks, block_len, Hkv, hd)``
    in ``dtype`` (fp32, bf16, fp8 e4m3 or int8 — int8 adds fp32 scale
    arenas ``k_scale``/``v_scale`` per block, position and KV head),
    positions ``(*lead, n_slots, T * block_len)`` all empty."""
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    T = -(-attn_ring_len(cfg, cache_len, window=window) // block_len)
    arena = (*lead, n_blocks, block_len, Hkv, hd)
    cache = {
        "k": torch.zeros(arena, dtype=dtype, device=device),
        "v": torch.zeros(arena, dtype=dtype, device=device),
        "pos": torch.full((*lead, n_slots, T * block_len), EMPTY_POS,
                          dtype=torch.int32, device=device),
        "window": torch.full(lead, window, dtype=torch.int32, device=device),
    }
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(arena[:-1], dtype=torch.float32,
                                      device=device)
    return cache


def attn_cache_reset_spec(quantized: bool = False) -> Dict[str, str]:
    """Per-leaf slot-recycle action: arena bytes (and int8 scales) are
    ``keep`` — stale but masked; positions are ``empty``."""
    spec = {"k": "keep", "v": "keep", "pos": "empty", "window": "keep"}
    if quantized:
        spec.update({"k_scale": "keep", "v_scale": "keep"})
    return spec


def attn_cache_slot_axes(quantized: bool = False) -> Dict[str, bool]:
    """Which leaves carry a slot axis (axis 1 once layer-stacked):
    positions do; arenas and their scales are shared across slots."""
    axes = {"k": False, "v": False, "pos": True, "window": False}
    if quantized:
        axes.update({"k_scale": False, "v_scale": False})
    return axes


def attn_decode_slots(p: Params, x: torch.Tensor, cache: Dict,
                      t: torch.Tensor, cfg: ModelConfig, *, window: int = 0,
                      table: torch.Tensor,
                      attn_backend: Optional[str] = None,
                      writes: Optional[PagedWrites] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """Slot-batched attention step over the paged arena: row b's C tokens
    sit at positions ``t[b]`` (< 0 = pad). x: (B, C, d); t: (B, C)
    int32; table: (B, T) int32, both on x's device.

    The tokens' K/V (int8 arenas: quantized per token and KV head, the
    scale written at the same index) and positions are written into
    ``cache`` in place before the read, so a chunk attends causally
    within itself through the position mask; pad tokens and tokens
    whose block is unassigned write nothing. ``writes`` are those
    writes precomputed (:func:`paged_writes`, once per tick and group on
    the host); without them this layer filters on its own. The read is
    ``decode_gqa`` with ``attn_backend``. Returns (out (B, C, d),
    cache)."""
    q, k_new, v_new = _project_qkv(p, x, t.clamp(min=0), cfg)
    Nb, bl = cache["k"].shape[:2]
    if writes is None:
        writes = paged_writes(table, t, Nb, bl)
    w = writes
    kn, vn = k_new[w.b, w.c], v_new[w.b, w.c]          # (n, Hkv, hd)
    quantized = "k_scale" in cache
    at = (w.blk, w.off)
    if quantized:
        (kq, ks), (vq, vs) = quantize_kv(kn), quantize_kv(vn)
        put_rows(cache["k"], at, kq)
        put_rows(cache["v"], at, vq)
        put_rows(cache["k_scale"], at, ks)
        put_rows(cache["v_scale"], at, vs)
    else:
        put_rows(cache["k"], at, kn)
        put_rows(cache["v"], at, vn)
    put_rows(cache["pos"], (w.b, w.lw), t[w.b, w.c])
    o = decode_gqa(q, cache["k"], cache["v"], cache["pos"], t,
                   window=window, table=table, backend=attn_backend,
                   k_scale=cache.get("k_scale"),
                   v_scale=cache.get("v_scale"))
    return dense(p["wo"], o, cfg=cfg, tag="attn/wo"), cache
