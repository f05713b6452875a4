"""Multi-head Latent Attention (DeepSeek-V3): the whole-sequence forward
of training, and slot-batched serving over the paged latent pool (the
port's counterpart of ``repro.models.lm.mla``).

The whole-sequence form (:func:`mla_forward`) expands the latent into
per-head K/V and runs ``attention.blockwise_attn`` with the value width
``mla_v_dim``, as the reference does. It runs no kernel: the port's
flash kernel takes one head width of at most 128, and MLA's query width
is ``nope + rope`` (192 at full width).

Decode uses the *absorbed* form: scores and values are computed in the
(kv_lora_rank + rope) latent space, so each layer caches one latent
``c (kvr,)`` and one rope key ``k_rope (rope,)`` per position, shared by
every head, instead of per-head K/V. The serving pool keeps the latents
in shared block arenas ``(n_blocks, block_len, kvr|rope)`` addressed
through its block table, with positions per slot, as for GQA
(``repro_torch.models.lm.attention``); the static path keeps them in
contiguous rows ``(B, L, kvr|rope)`` with per-row positions ``(B, L)``
(:func:`init_mla_cache`, :func:`mla_decode`). Caches are updated in
place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.ops import decode_mla, scatter_rows
from repro_torch.models.lm.attention import blockwise_attn
from repro_torch.kernels.paged_attention import (EMPTY_POS, paged_writes,
                                                 quantize_kv)
from repro_torch.models.lm.common import (Params, dense, kernel_of,
                                          make_dense_params,
                                          make_rmsnorm_params, rmsnorm)
from repro_torch.models.lm.rope import apply_rope
from repro_torch.parallel import tensor_parallel as tp


def _dims(cfg: ModelConfig):
    return (cfg.n_heads, cfg.mla_q_lora_rank, cfg.mla_kv_lora_rank,
            cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim, cfg.mla_v_dim)


def make_mla_params(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
                    dtype=torch.float32) -> Params:
    d = cfg.d_model
    H, qr, kvr, nope, rope_d, vd = _dims(cfg)
    kw = dict(lead=lead, dtype=dtype)
    norm = dict(lead=lead, dtype=dtype, device=gen.device)
    return {
        "wdq": make_dense_params(gen, d, qr, **kw),
        "wuq": make_dense_params(gen, qr, H * (nope + rope_d), **kw),
        "wdkv": make_dense_params(gen, d, kvr + rope_d, **kw),
        "wukv": make_dense_params(gen, kvr, H * (nope + vd), **kw),
        "wo": make_dense_params(gen, H * vd, d, **kw),
        "q_norm": make_rmsnorm_params(qr, **norm),
        "kv_norm": make_rmsnorm_params(kvr, **norm),
    }


def heads_split(p: Params, cfg: ModelConfig) -> bool:
    """Whether ``p`` holds this rank's query heads of an MLA block split
    over a tensor-parallel model group (``parallel/tensor_parallel``)."""
    H, qr, kvr, nope, rope_d, vd = _dims(cfg)
    return (tp.size() > 1
            and p["wuq"]["kernel"].shape[-1] != H * (nope + rope_d))


def _project_q(p: Params, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, split: bool = False):
    """(q_nope, q_rope) over the heads ``p`` holds (all of them, or this
    rank's where ``split``: the whole latent ``cq`` enters ``wuq``'s
    columns through ``copy_to_model``)."""
    B, S, _ = x.shape
    H, qr, kvr, nope, rope_d, vd = _dims(cfg)
    cq = rmsnorm(p["q_norm"], dense(p["wdq"], x, cfg=cfg, tag="mla/wdq"),
                 cfg.norm_eps)
    q = dense(p["wuq"], tp.copy_to_model(cq, split), cfg=cfg, tag="mla/wuq",
              parallel="col" if split else "").reshape(
        B, S, -1, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, head_dim=rope_d,
                        theta=cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(p: Params, x: torch.Tensor, positions: torch.Tensor,
                       cfg: ModelConfig):
    H, qr, kvr, nope, rope_d, vd = _dims(cfg)
    ckv = dense(p["wdkv"], x, cfg=cfg, tag="mla/wdkv")
    c, k_rope = ckv[..., :kvr], ckv[..., kvr:]
    c = rmsnorm(p["kv_norm"], c, cfg.norm_eps)
    k_rope = apply_rope(k_rope, positions, head_dim=rope_d,
                        theta=cfg.rope_theta)
    return c, k_rope            # (B, S, kvr), (B, S, rope_d)


def mla_forward(p: Params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Whole-sequence MLA. x: (B, S, d); positions: (B, S). The latent
    up-projects to per-head K = [k_nope, k_rope] (the rope key shared
    by every head) and V, then :func:`blockwise_attn` (causal, value
    width ``mla_v_dim``). Returns (out (B, S, d), {"c": (B, S, kvr),
    "k_rope": (B, S, rope)}).

    Over a tensor-parallel model group whose size divides ``n_heads``,
    ``p`` holds this rank's ``H/M`` query heads of ``wuq`` and ``wukv``
    and their rows of ``wo`` (the reference's q, k, v and output pinned
    on ``model`` by heads). The latents are computed whole on every
    rank from ``x``, which passes no copy, so ``wdq``'s and ``wdkv``'s
    gradients come out whole; each whole tensor that feeds the split
    heads (``cq``, ``c``, ``k_rope``) passes ``copy_to_model`` once,
    and ``wo`` is row-parallel."""
    B, S, _ = x.shape
    H, qr, kvr, nope, rope_d, vd = _dims(cfg)
    split = heads_split(p, cfg)
    q_nope, q_rope = _project_q(p, x, positions, cfg, split)
    c, k_rope = _project_kv_latent(p, x, positions, cfg)
    kv = dense(p["wukv"], tp.copy_to_model(c, split), cfg=cfg,
               tag="mla/wukv", parallel="col" if split else "").reshape(
        B, S, -1, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    kr = tp.copy_to_model(k_rope, split)
    k = torch.cat([k_nope, kr[:, :, None].expand(B, S, kv.shape[2], rope_d)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = blockwise_attn(q, k, v, causal=True).reshape(B, S, -1)
    return (dense(p["wo"], o, cfg=cfg, tag="mla/wo",
                  parallel="row" if split else ""),
            {"c": c, "k_rope": k_rope})


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   dtype=torch.bfloat16, *, lead=(), device=None) -> Dict:
    """Empty contiguous latent cache, stacked over ``lead``: ``c (*lead,
    B, L, kvr)`` and ``k_rope (*lead, B, L, rope)`` in ``dtype``, and
    positions per row, ``pos (*lead, B, L)``, empty. One shared ``(L,)``
    vector would cross-mask a batched decode whose rows sit at
    different positions, so the positions are per row, as the
    reference's."""
    _, _, kvr, _, rope_d, _ = _dims(cfg)
    rows = (*lead, batch, cache_len)
    return {"c": torch.zeros((*rows, kvr), dtype=dtype, device=device),
            "k_rope": torch.zeros((*rows, rope_d), dtype=dtype,
                                  device=device),
            "pos": torch.full(rows, EMPTY_POS, dtype=torch.int32,
                              device=device)}


# the reference's slot layout is the one-shot cache's
init_mla_cache_slots = init_mla_cache


def fill_mla_cache(cache: Dict, kv: Dict) -> Dict:
    """Write a prefill's hand-off ``{"c": (B, S, kvr), "k_rope": (B, S,
    rope)}`` into the first S positions of ``cache``, in place, and mark
    them at positions 0..S-1."""
    S = kv["c"].shape[1]
    cache["c"][:, :S] = kv["c"].to(cache["c"].dtype)
    cache["k_rope"][:, :S] = kv["k_rope"].to(cache["k_rope"].dtype)
    cache["pos"][:, :S] = torch.arange(S, dtype=torch.int32,
                                       device=cache["pos"].device)
    return cache


def init_mla_cache_paged(cfg: ModelConfig, n_slots: int, cache_len: int,
                         n_blocks: int, block_len: int, *,
                         dtype=torch.bfloat16, lead=(), device=None) -> Dict:
    """Empty paged latent cache: ``c (*lead, n_blocks, block_len, kvr)``
    and ``k_rope (*lead, n_blocks, block_len, rope)`` in ``dtype`` (fp32,
    bf16, fp16, fp8 e4m3 or int8 — int8 adds fp32 per-token scale arenas
    ``c_scale``/``kr_scale (*lead, n_blocks, block_len)``: the latent has
    no head axis), positions ``(*lead, n_slots, T * block_len)`` empty."""
    _, _, kvr, _, rope_d, _ = _dims(cfg)
    T = -(-cache_len // block_len)
    blocks = (*lead, n_blocks, block_len)
    cache = {
        "c": torch.zeros((*blocks, kvr), dtype=dtype, device=device),
        "k_rope": torch.zeros((*blocks, rope_d), dtype=dtype, device=device),
        "pos": torch.full((*lead, n_slots, T * block_len), EMPTY_POS,
                          dtype=torch.int32, device=device),
    }
    if dtype == torch.int8:
        for name in ("c_scale", "kr_scale"):
            cache[name] = torch.zeros(blocks, dtype=torch.float32,
                                      device=device)
    return cache


def mla_cache_reset_spec(quantized: bool = False) -> Dict[str, str]:
    """Per-leaf slot-recycle action: latent bytes and their scales are
    ``keep`` (stale but masked); positions are ``empty``."""
    spec = {"c": "keep", "k_rope": "keep", "pos": "empty"}
    if quantized:
        spec.update({"c_scale": "keep", "kr_scale": "keep"})
    return spec


def mla_cache_slot_axes(quantized: bool = False) -> Dict[str, bool]:
    """Which leaves carry a slot axis: positions do; the latent arenas
    and their scales are shared across slots."""
    axes = {"c": False, "k_rope": False, "pos": True}
    if quantized:
        axes.update({"c_scale": False, "kr_scale": False})
    return axes


def mla_decode(p: Params, x: torch.Tensor, cache: Dict, t: torch.Tensor,
               cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-form decode over the contiguous latent cache, updated in
    place. x: (B, 1, d); t: one position, 0-d (every row's, the
    lockstep static decode: the reference's traced scalar), or one a
    row, (B,) or (B, 1); made (B, 1) int32 on x's device, where a
    tensor stays. Runs :func:`mla_decode_slots` with no table, as the
    reference's."""
    B = x.shape[0]
    t = torch.as_tensor(t).to(x.device, torch.int32).reshape(-1, 1).expand(
        B, 1)
    return mla_decode_slots(p, x, cache, t, cfg, table=None)


def mla_decode_slots(p: Params, x: torch.Tensor, cache: Dict,
                     t: torch.Tensor, cfg: ModelConfig, *,
                     table: Optional[torch.Tensor] = None,
                     attn_backend: Optional[str] = None,
                     writes=None) -> Tuple[torch.Tensor, Dict]:
    """Slot-batched absorbed-MLA step: row b's C tokens sit at positions
    ``t[b]`` (< 0 = pad). x: (B, C, d); t: (B, C) int32 on x's device.

    ``table`` (B, T) int32: ``cache`` is the paged pool's, latent arenas
    addressed through the table. ``table`` None: ``cache`` is contiguous
    rows (:func:`init_mla_cache`), token b's written at ``t % L``; int8
    latent scales need the paged layout and raise, as the reference.

    The tokens' latents (int8 arenas: quantized per token, the scale
    written at the same index) and positions are written into ``cache``
    in place before the read, so a chunk attends causally within itself.
    The writes keep the fixed ``B * C`` shape, as the reference's
    ``mode="drop"`` scatter (:func:`scatter_rows`), and nothing is read
    on the host: paged, pad tokens and tokens whose block is unassigned
    carry the sentinel index (``writes``: :class:`PagedWrites`, as
    ``attention.attn_decode_slots`` takes them); contiguous, token b's
    row is b and its column ``t % L``, or L for a pad token. The read
    is ``decode_mla`` with ``attn_backend``: ``q_abs = q_nope · W_uk``
    scores against the latent, ``o = o_lat · W_uv`` then ``wo``, with
    ``wukv`` dequantized in fp32 and cast to the compute dtype (bf16 for
    1-byte arenas). Returns (out (B, C, d), cache)."""
    B, C, _ = x.shape
    H, qr, kvr, nope, rope_d, vd = _dims(cfg)
    quantized = "c_scale" in cache
    if table is None and quantized:
        raise ValueError("mla_decode_slots: int8 latent scales need the "
                         "paged layout (a table)")
    tq = t.clamp(min=0)
    q_nope, q_rope = _project_q(p, x, tq, cfg)            # (B, C, H, *)
    c_new, kr_new = _project_kv_latent(p, x, tq, cfg)     # (B, C, *)
    cn, krn = c_new.flatten(0, 1), kr_new.flatten(0, 1)  # (B*C, *)
    if table is None:
        L = cache["c"].shape[1]
        b = torch.arange(B, device=x.device)[:, None].expand(B, C).reshape(-1)
        tl = t.long()
        col = torch.where(tl >= 0, tl % L, torch.full_like(tl, L))
        at = (b, col.reshape(-1))
        scatter_rows(cache["c"], *at, cn)
        scatter_rows(cache["k_rope"], *at, krn)
        scatter_rows(cache["pos"], *at, t.reshape(-1))
    else:
        w = writes if writes is not None else paged_writes(
            table, t, *cache["c"].shape[:2])
        rows = ({"c": cn, "k_rope": krn} if not quantized else
                dict(zip(("c", "c_scale", "k_rope", "kr_scale"),
                         (*quantize_kv(cn), *quantize_kv(krn)))))
        for name, r in rows.items():
            scatter_rows(cache[name], w.blk, w.off, r)
        scatter_rows(cache["pos"], w.b, w.lw, t.reshape(-1))

    cdt = (torch.bfloat16 if cache["c"].dtype.itemsize == 1
           else cache["c"].dtype)
    wukv = kernel_of(p["wukv"], torch.float32).reshape(kvr, H, nope + vd)
    w_uk, w_uv = wukv[..., :nope], wukv[..., nope:]
    q_abs = torch.einsum("bchn,rhn->bchr", q_nope.to(cdt), w_uk.to(cdt))
    o_lat = decode_mla(q_abs, q_rope, cache["c"], cache["k_rope"],
                       cache["pos"], t, scale=(nope + rope_d) ** -0.5,
                       table=table, backend=attn_backend,
                       c_scale=cache.get("c_scale"),
                       kr_scale=cache.get("kr_scale"))
    o = torch.einsum("bchr,rhv->bchv", o_lat.to(cdt), w_uv.to(cdt))
    o = o.reshape(B, C, H * vd).to(x.dtype)
    return dense(p["wo"], o, cfg=cfg, tag="mla/wo"), cache
