"""Decoder-only transformer for slot-batched serving (the port's
counterpart of the serving half of ``repro.models.lm.transformer``).

Layers form *groups* of identical blocks; a group's parameters and
caches stack along a leading ``n_layers`` axis, and the port walks that
axis in a Python loop where the reference scans. Ported so far: the
``dense`` block kind (norm -> GQA attention -> norm -> gated SiLU MLP);
every other kind raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import PackedTensor
from repro_torch.kernels.paged_attention import paged_writes
from repro_torch.models.lm import attention as attn_mod
from repro_torch.models.lm.common import (Params, dense, make_dense_params,
                                          make_mlp_params,
                                          make_rmsnorm_params, mlp, rmsnorm,
                                          truncated_normal_init)

# Layer kinds the slot-batched serving path covers in the port.
SLOT_KINDS = ("dense",)


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    if cfg.family == "dense":
        return [("dense", cfg.n_layers)]
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family's layers are not ported "
        f"(ported block kinds: {SLOT_KINDS})")


def group_names(cfg: ModelConfig) -> List[Tuple[str, str, int]]:
    return [(f"g{gi}_{kind}", kind, n)
            for gi, (kind, n) in enumerate(layer_plan(cfg))]


def supports_slot_serving(cfg: ModelConfig) -> bool:
    """Token-only arch whose every block kind is ported."""
    if cfg.frontend_tokens:
        return False
    try:
        return all(kind in SLOT_KINDS for _, kind, _ in group_names(cfg))
    except NotImplementedError:
        return False


def _check_kind(kind: str) -> None:
    if kind not in SLOT_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported (ported: {SLOT_KINDS})")


# ---------------------------------------------------------------------------
# Parameters


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, *,
               lead=(), dtype=torch.float32) -> Params:
    """One block's parameters, stacked over ``lead`` (e.g. (n_layers,))."""
    _check_kind(kind)
    d = cfg.d_model
    norm = dict(lead=lead, dtype=dtype, device=gen.device)
    return {"ln1": make_rmsnorm_params(d, **norm),
            "attn": attn_mod.make_attn_params(gen, cfg, lead=lead,
                                              dtype=dtype),
            "ln2": make_rmsnorm_params(d, **norm),
            "ffn": make_mlp_params(gen, d, cfg.d_ff, lead=lead, dtype=dtype)}


def init_decoder(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Layer-stacked decoder parameters in ``cfg.dtype``, drawn from
    ``gen`` on its device (truncated normal, std 0.02; norms ones,
    biases zeros — the reference's init, other random numbers)."""
    dtype = getattr(torch, cfg.dtype)
    d = cfg.d_model
    params: Params = {
        "embed": truncated_normal_init(gen, (cfg.vocab_size, d),
                                       dtype=dtype),
        "final_norm": make_rmsnorm_params(d, dtype=dtype,
                                          device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = make_dense_params(gen, d, cfg.vocab_size,
                                              dtype=dtype)
    params["groups"] = {
        gname: init_block(gen, cfg, kind, lead=(n,), dtype=dtype)
        for gname, kind, n in group_names(cfg)}
    return params


def layer_views(stack: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """Per-layer views of a layer-stacked tree (PackedTensor children
    sliced too; nothing is copied)."""
    def one(tree, i):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = one(v, i)
            elif isinstance(v, PackedTensor):
                out[k] = PackedTensor(v.data[i], v.scale[i], v.bits,
                                      v.orig_shape)
            else:
                out[k] = v[i]
        return out
    return [one(stack, i) for i in range(n)]


def param_layer_views(params: Params, cfg: ModelConfig
                      ) -> Dict[str, List[Params]]:
    """{group name: per-layer parameter views} — what a runner keeps so
    that a tick does not re-slice the stacks."""
    return {gname: layer_views(params["groups"][gname], n)
            for gname, _, n in group_names(cfg)}


# ---------------------------------------------------------------------------
# Forward pieces


def embed_tokens(params: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens.long()].to(getattr(torch, cfg.dtype))


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return dense(params["lm_head"], x, cfg=cfg, tag="lm_head")


def block_decode_slots(p: Params, x: torch.Tensor, cache: Dict,
                       t: torch.Tensor, cfg: ModelConfig, kind: str, *,
                       table: torch.Tensor,
                       attn_backend: Optional[str] = None,
                       writes=None) -> Tuple[torch.Tensor, Dict]:
    """One block of the slot-batched step; x: (B, C, d); t: (B, C)."""
    _check_kind(kind)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    mix, cache = attn_mod.attn_decode_slots(p["attn"], h, cache, t, cfg,
                                            table=table,
                                            attn_backend=attn_backend,
                                            writes=writes)
    x = x + mix
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["ffn"], h2, cfg=cfg, tag="mlp"), cache


def decode_step_slots(params: Params, caches: Dict, tokens: torch.Tensor,
                      t: torch.Tensor, cfg: ModelConfig,
                      logits_at: Optional[torch.Tensor] = None,
                      tables: Optional[Dict[str, torch.Tensor]] = None,
                      attn_backend: Optional[str] = None,
                      layers: Optional[Dict[str, List[Params]]] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """Slot-batched decode/chunk step of the serving engine.

    tokens, t: (B, C) int32, ``t < 0`` for padding (pad rows give
    garbage logits and write nothing). ``tables``: {group: (B, T) block
    table} over the paged ``caches``, which are updated in place and
    returned. ``logits_at`` (B,) unembeds only each row's emitting
    column. ``layers``: per-layer parameter views
    (:func:`param_layer_views`), else sliced here.

    ``tokens``, ``t``, ``logits_at`` and ``tables`` may sit on the host:
    they move to the parameters' device once per call, and the arena
    writes (:func:`repro_torch.kernels.paged_attention.paged_writes`)
    are filtered from the host copies, so a tick from host inputs needs
    no device synchronisation. Returns (logits (B, C or 1, V), caches).
    """
    dev = params["embed"].device
    if layers is None:
        layers = param_layer_views(params, cfg)
    t_dev = t.to(dev, torch.int32, non_blocking=True)
    x = embed_tokens(params, tokens.to(dev, non_blocking=True).clamp(min=0),
                     cfg)
    for gname, kind, n in group_names(cfg):
        cstack = caches[gname]
        table = tables[gname]
        Nb, bl = cstack["k"].shape[1:3]
        writes = paged_writes(table, t, Nb, bl).to(dev)
        table_dev = table.to(dev, torch.int32, non_blocking=True)
        for i, (p, c) in enumerate(zip(layers[gname],
                                       layer_views(cstack, n))):
            x, _ = block_decode_slots(p, x, c, t_dev, cfg, kind,
                                      table=table_dev,
                                      attn_backend=attn_backend,
                                      writes=writes)
    if logits_at is not None:
        idx = logits_at.to(dev, torch.long, non_blocking=True).clamp(min=0)
        x = x[torch.arange(x.shape[0], device=dev), idx][:, None]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, x, cfg), caches


# ---------------------------------------------------------------------------
# The paged cache pool's per-group layout


def paged_group_layout(cfg: ModelConfig, cache_len: int,
                       block_len: int) -> Dict[str, int]:
    """{group name: blocks per slot (T)} for every KV-bearing group."""
    return {gname: -(-attn_mod.attn_ring_len(cfg, cache_len) // block_len)
            for gname, _, _ in group_names(cfg)}


def init_caches_paged(cfg: ModelConfig, n_slots: int, cache_len: int,
                      n_blocks: Dict[str, int], block_len: int,
                      cache_dtype=torch.bfloat16, device=None) -> Dict:
    """Empty paged pool caches: per group, arenas ``(n_layers,
    n_blocks[g], block_len, Hkv, hd)`` and positions ``(n_layers,
    n_slots, T * block_len)``. ``cache_dtype`` is one storage dtype or a
    ``{group: dtype}`` mapping (int8 groups grow fp32 scale arenas)."""
    caches: Dict[str, Any] = {}
    for gname, kind, n in group_names(cfg):
        _check_kind(kind)
        dt = (cache_dtype.get(gname, torch.bfloat16)
              if isinstance(cache_dtype, dict) else cache_dtype)
        caches[gname] = attn_mod.init_attn_cache_paged(
            cfg, n_slots, cache_len, n_blocks.get(gname, 0), block_len,
            dtype=dt, lead=(n,), device=device)
    return caches


def _quantized(cache_dtype, gname) -> bool:
    dt = (cache_dtype.get(gname, torch.bfloat16)
          if isinstance(cache_dtype, dict) else cache_dtype)
    return dt == torch.int8


def caches_reset_specs(cfg: ModelConfig, cache_dtype=None) -> Dict:
    """Reset-spec tree matching :func:`init_caches_paged`."""
    return {gname: attn_mod.attn_cache_reset_spec(
                _quantized(cache_dtype, gname))
            for gname, _, _ in group_names(cfg)}


def caches_slot_axes(cfg: ModelConfig, cache_dtype=None) -> Dict:
    """Slot-axis tree matching :func:`init_caches_paged`."""
    return {gname: attn_mod.attn_cache_slot_axes(
                _quantized(cache_dtype, gname))
            for gname, _, _ in group_names(cfg)}
