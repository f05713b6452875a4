"""GQA attention (the port's counterpart of
``repro.models.lm.attention``): the whole-prompt forward and the
one-token decode over a contiguous cache (the static path), and the
slot-batched step over the paged KV pool (the serving engine).

Whole-prompt attention, the port's routing: :func:`attn_forward` serves
a prompt of a full-attention layer through ``ops.flash_attention``, the
hand-written CUDA ``flash_attention`` kernel on a card, where the
reference calls its XLA ``blockwise_attn`` and never its Pallas twin
(``flash_attention_p``); on the CPU the same call runs the dense plain
version. A sliding-window layer (the hybrid family's ``hybrid_swa``)
runs :func:`blockwise_attn` with its window, as the reference does for
every prompt: the TPU kernel takes no window in either package, so the
route is chosen by the layer's kind. The kernel has no backward, so a
training forward (``train=True``) runs :func:`blockwise_attn`, the port
of the reference's XLA attention and plain autograd-differentiable
PyTorch, as the reference trains through it; so does a prompt in the
dry run (:data:`REFERENCE_SCHEDULE`). The contiguous decode
runs no kernel; a windowed layer's contiguous cache is a ring of
``min(window, cache_len)`` positions.

In the paged pool, each layer's K/V bytes live in a shared block arena ``(n_blocks,
block_len, Hkv, hd)``; a host block table ``(B, T)`` maps each slot's
logical block to an arena block (-1 = unassigned) and positions stay
per slot (``pos: (n_slots, T * block_len)``), so a recycled block is
masked until its new owner writes it. The arena is updated in place.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.ops import decode_gqa, flash_attention, scatter_rows
from repro_torch.kernels.paged_attention import (EMPTY_POS, NEG_INF,
                                                 PagedWrites, compute_dtype,
                                                 paged_writes, put_at,
                                                 quantize_kv)
from repro_torch.models.lm.common import Params, dense, make_dense_params
from repro_torch.models.lm.rope import apply_rope
from repro_torch.parallel import tensor_parallel as tp


# ---------------------------------------------------------------------------
# Blockwise attention (the training forward's)

# Which program attention runs. False (the eager default): the causal
# schedule stops at the diagonal, and a whole prompt of a full-attention
# layer goes to ``ops.flash_attention``. True (``launch/dryrun.build_cell``
# sets it, so the dry run counts the reference's program): a whole
# prompt runs :func:`blockwise_attn`, as the reference's prefill does,
# and the causal schedule is the reference's, the full masked grid,
# or the triangle under ``REPRO_ATTN_TRI=1`` when Sq == Sk. Values are
# equal either way: past the diagonal p underflows to 0. The dry run
# counts on fake CPU tensors; a CUDA input with the setting on raises
# (:func:`_reference_schedule`), so it never takes a prompt on the card
# past the kernel.
REFERENCE_SCHEDULE = False


def _reference_schedule(t: torch.Tensor) -> bool:
    """:data:`REFERENCE_SCHEDULE` for an input ``t``; raises where it is
    set and ``t`` lies on the card."""
    if REFERENCE_SCHEDULE and t.is_cuda:
        raise RuntimeError(
            "attention.REFERENCE_SCHEDULE is set (the dry run's count of "
            "the reference's program, on CPU tensors) with an input on "
            "the card, where a prompt would skip ops.flash_attention")
    return REFERENCE_SCHEDULE


def _score_dtype() -> torch.dtype:
    """The chunk scores' and probabilities' dtype, read at call time as
    the reference reads it: bf16 under ``REPRO_ATTN_BF16=1``, else fp32.
    The statistics ``m``, ``l`` and the accumulator stay fp32."""
    return (torch.bfloat16 if os.environ.get("REPRO_ATTN_BF16") == "1"
            else torch.float32)


def _chunk(n: int, pref: int) -> int:
    """Largest divisor of n that is <= pref (every chunk the same size)."""
    if n <= pref:
        return n
    c = pref
    while n % c:
        c -= 1
    return c


def _online(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor, *,
            Kc: int, group: int, scale: float, q_offset: int, causal: bool,
            tri: bool, dtype) -> torch.Tensor:
    """Online softmax of each query chunk over the KV chunks.
    qs: (Tq, B, H, Qc, hd); ks/vs: (Tk, B, Hkv, Kc, hd | hd_v). Returns
    (Tq, B, H, Qc, hd_v) in ``dtype``.

    ``tri``: only the KV chunks at or below the diagonal, the reference's
    triangular schedule (``_blockwise_tri``: its pairs ``j * Kc <=
    q_offset + i * Qc + Qc - 1``); else every chunk, masked when
    ``causal`` (the reference's full grid). A chunk past the diagonal is
    masked for every query of the chunk, so it adds exactly nothing (p
    underflows to 0, the correction is 1). Scores and probabilities in
    :func:`_score_dtype`, each P·V product rounded to it and summed in
    fp32. The chunk stacks are unbound once, so the backward stacks the
    chunks' gradients in one op."""
    _, B, H, Qc, _ = qs.shape
    dev = qs.device
    sdt = _score_dtype()
    # the reference scales by the scale rounded to the score dtype
    sc = scale if sdt == torch.float32 else float(torch.tensor(scale,
                                                               dtype=sdt))
    ks, vs = ks.unbind(0), vs.unbind(0)
    kpos = torch.arange(len(ks) * Kc, device=dev) if causal else None
    outs = []
    for i, qc in enumerate(qs.unbind(0)):
        q0 = q_offset + i * Qc
        if causal:
            # the keys each query of the chunk may not see, in every chunk
            future = kpos[None, :] > q0 + torch.arange(Qc,
                                                       device=dev)[:, None]
        qf = qc.to(sdt)
        m = torch.full((B, H, Qc), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, Qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, Qc, vs[0].shape[-1]), dtype=torch.float32,
                          device=dev)
        for j in range(len(ks)):
            if tri and j * Kc > q0 + Qc - 1:
                break
            kc, vc = ks[j], vs[j]
            if group > 1:
                kc = kc.repeat_interleave(group, dim=1)
                vc = vc.repeat_interleave(group, dim=1)
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kc.to(sdt)) * sc
            if causal:
                s = s.masked_fill(future[:, j * Kc:(j + 1) * Kc], NEG_INF)
            vc = vc.to(sdt)
            m_new = torch.maximum(m, s.amax(dim=-1).float())
            p = torch.exp(s - m_new[..., None].to(sdt))
            corr = torch.exp(m - m_new)
            l = l * corr + p.float().sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vc).float()
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).to(dtype))
    return torch.stack(outs)


def blockwise_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0, q_offset: int = 0,
                   q_chunk: int = 0, kv_chunk: int = 1024) -> torch.Tensor:
    """The reference's ``blockwise_attn``: q (B, Sq, H, hd); k (B, Sk,
    Hkv, hd); v (B, Sk, Hkv, hd_v), hd_v taken from v (MLA's value width
    differs from its query width). Returns (B, Sq, H, hd_v) in q's dtype.
    Query head h reads KV head h // (H // Hkv); query i sits at position
    ``q_offset + i``.

    Never materialises (Sq, Sk) scores: query chunks of ``q_chunk`` (the
    largest divisor of Sq not above it; 0 reads ``REPRO_ATTN_QCHUNK``,
    default 512, at call time as the reference does) against KV chunks
    of ``kv_chunk`` with an online softmax (:func:`_online`; the causal
    schedule as :data:`REFERENCE_SCHEDULE` says). Scores in fp32, or
    bf16 under ``REPRO_ATTN_BF16=1`` (:func:`_score_dtype`).
    ``window > 0``: sliding-window attention, each query seeing the
    ``window`` positions up to itself, through one KV window of ``window
    + q_chunk`` positions a query chunk. Plain PyTorch, differentiable
    by autograd; memory in training is bounded by the block-level
    rematerialisation (``transformer.forward``), where the reference
    also remats each KV step."""
    if not q_chunk:
        q_chunk = int(os.environ.get("REPRO_ATTN_QCHUNK", "512"))
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    group = H // Hkv
    scale = hd ** -0.5
    Qc = _chunk(Sq, q_chunk)
    Tq = Sq // Qc
    qs = q.reshape(B, Tq, Qc, H, hd).permute(1, 0, 3, 2, 4)
    dev = q.device
    if window > 0:
        sdt = _score_dtype()
        sc = scale if sdt == torch.float32 else float(torch.tensor(
            scale, dtype=sdt))
        W = min(window, Sk)
        Wpad = W + Qc if Sk >= W + Qc else Sk
        outs = []
        for i, qc in enumerate(qs.unbind(0)):
            q0 = q_offset + i * Qc
            start = min(max(q0 + Qc - Wpad, 0), Sk - Wpad)
            kw = k[:, start:start + Wpad].repeat_interleave(group, dim=2)
            vw = v[:, start:start + Wpad].repeat_interleave(group, dim=2)
            qpos = q0 + torch.arange(Qc, device=dev)
            kpos = start + torch.arange(Wpad, device=dev)
            mask = ((kpos[None, :] <= qpos[:, None])
                    & (kpos[None, :] > qpos[:, None] - W))
            s = torch.einsum("bhqd,bkhd->bhqk", qc.to(sdt),
                             kw.to(sdt)) * sc
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            p = torch.softmax(s.float(), dim=-1)
            outs.append(torch.einsum("bhqk,bkhd->bhqd", p.to(sdt),
                                     vw.to(sdt)).float().to(q.dtype))
        out = torch.stack(outs)
    else:
        Kc = _chunk(Sk, kv_chunk)
        Tk = Sk // Kc
        ks = k.reshape(B, Tk, Kc, Hkv, hd).permute(1, 0, 3, 2, 4)
        vs = v.reshape(B, Tk, Kc, Hkv, hd_v).permute(1, 0, 3, 2, 4)
        tri = causal and (not _reference_schedule(q) or (
            os.environ.get("REPRO_ATTN_TRI") == "1" and Sq == Sk))
        out = _online(qs, ks, vs, Kc=Kc, group=group, scale=scale,
                      q_offset=q_offset, causal=causal, tri=tri,
                      dtype=q.dtype)
    return out.permute(1, 0, 3, 2, 4).reshape(B, Sq, H, hd_v)


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


def heads_split(p: Params, cfg: ModelConfig) -> bool:
    """Whether ``p`` holds this rank's heads of attention split over a
    tensor-parallel model group (``parallel/tensor_parallel``)."""
    return (tp.size() > 1 and p["wq"]["kernel"].shape[-1]
            != cfg.n_heads * cfg.resolved_head_dim)


def _project_qkv(p: Params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, parallel: str = ""):
    """q, k, v over the heads ``p`` holds (all of them, or this rank's
    with ``parallel="col"``), roped."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    kw = dict(cfg=cfg, parallel=parallel)
    q = dense(p["wq"], x, tag="attn/wq", **kw).reshape(B, S, -1, hd)
    kk = dense(p["wk"], x, tag="attn/wk", **kw).reshape(B, S, -1, hd)
    vv = dense(p["wv"], x, tag="attn/wv", **kw).reshape(B, S, -1, hd)
    rope = dict(head_dim=hd, theta=cfg.rope_theta, two_d=cfg.rope_2d)
    return (apply_rope(q, positions, **rope), apply_rope(kk, positions, **rope),
            vv)


# ---------------------------------------------------------------------------
# Whole prompt and contiguous-cache decode (the static path)


def attn_forward(p: Params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, *, window: int = 0, causal: bool = True,
                 train: bool = False, reduce: bool = True
                 ) -> Tuple[torch.Tensor, Dict]:
    """Whole-prompt attention. x: (B, S, d); positions: (B, S). Returns
    (out (B, S, d), {"k", "v": (B, S, Hkv, hd)} for the cache).
    ``window > 0`` (each query sees the ``window`` positions up to
    itself), ``train`` (the training forward, differentiable) and
    :data:`REFERENCE_SCHEDULE` (the dry run's count of the reference's
    program) run :func:`blockwise_attn`; otherwise
    ``ops.flash_attention`` (the kernel on a card, which refuses inputs
    that require grad and takes no window, as the reference's TPU kernel
    takes none).

    Over a tensor-parallel model group whose size divides both head
    counts, ``p`` holds this rank's ``H/M`` query and ``Hkv/M`` KV heads
    (the reference's q/k/v and output pinned on ``model`` by heads):
    ``x`` enters through ``copy_to_model``, and ``wo`` is row-parallel,
    its product summed over the group (``reduce=False``: left as this
    rank's partial sum, for a caller that sums it with another)."""
    B, S, _ = x.shape
    split = heads_split(p, cfg)
    col, row = (("col", "row" if reduce else "partial") if split
                else ("", ""))
    q, k, v = _project_qkv(p, tp.copy_to_model(x, split), positions, cfg,
                           col)
    o = (blockwise_attn(q, k, v, causal=causal, window=window)
         if train or window > 0 or _reference_schedule(q)
         else flash_attention(q, k, v, causal=causal))
    o = o.reshape(B, S, -1)
    return (dense(p["wo"], o, cfg=cfg, tag="attn/wo", parallel=row),
            {"k": k, "v": v})


def init_attn_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
                    window: int = 0, dtype=torch.bfloat16,
                    device=None) -> Dict:
    """Empty contiguous cache: k/v (B, L, Hkv, hd), positions (L,) shared
    by the batch (the static path decodes in lockstep), and the
    reference's ``window`` leaf (0: full attention). A windowed layer
    rings at L = min(window, cache_len), else L = cache_len."""
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    L = attn_ring_len(cfg, cache_len, window=window)
    return {
        "k": torch.zeros((batch, L, Hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, L, Hkv, hd), dtype=dtype, device=device),
        "pos": torch.full((L,), EMPTY_POS, dtype=torch.int32, device=device),
        "window": torch.tensor(window, dtype=torch.int32, device=device),
    }


def fill_cache_from_prefill(cache: Dict, kv: Dict) -> Dict:
    """Write the prompt's k/v (B, S, Hkv, hd) into ``cache`` in place (a
    ring keeps the last L positions at slot position % L)."""
    S = kv["k"].shape[1]
    L = cache["k"].shape[1]
    dev = cache["pos"].device
    if S >= L:
        pos = torch.arange(S - L, S, dtype=torch.int32, device=dev)
        slot = (pos % L).long()
        cache["k"].zero_()
        cache["v"].zero_()
        cache["k"][:, slot] = kv["k"][:, S - L:].to(cache["k"].dtype)
        cache["v"][:, slot] = kv["v"][:, S - L:].to(cache["v"].dtype)
        cache["pos"].fill_(EMPTY_POS)
        cache["pos"][slot] = pos
    else:
        cache["k"][:, :S] = kv["k"].to(cache["k"].dtype)
        cache["v"][:, :S] = kv["v"].to(cache["v"].dtype)
        cache["pos"][:S] = torch.arange(S, dtype=torch.int32, device=dev)
    return cache


def attn_decode(p: Params, x: torch.Tensor, cache: Dict, t: torch.Tensor,
                cfg: ModelConfig, *, window: int = 0
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode over a contiguous cache, updated in place. x: (B,
    1, d); t: the token's position (every row's), a 0-d int32 tensor on
    x's device, as the reference's traced scalar: K, V and the position
    are written at ``t % L`` by ``index_copy_`` (:func:`put_at`, the
    reference's ``dynamic_update_slice``), so no Python index is taken
    from ``t``; ``window > 0``: only cached positions above ``t -
    window`` take part. The cache is read in its storage dtype (bf16 compute for
    1-byte caches), fp32 scores and products, as the reference."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k_new, v_new = _project_qkv(p, x, t.reshape(1, 1), cfg)
    slot = (t % cache["k"].shape[1]).reshape(1).long()
    put_at(cache["k"], 1, slot, k_new)
    put_at(cache["v"], 1, slot, v_new)
    put_at(cache["pos"], 0, slot, t.reshape(1))
    cdt = compute_dtype(cache["k"].dtype)
    qg = q.reshape(B, Hkv, H // Hkv, hd).to(cdt).float()
    s = torch.einsum("bkgd,blkd->bkgl", qg,
                     cache["k"].to(cdt).float()) * (hd ** -0.5)
    pos = cache["pos"]
    valid = (pos >= 0) & (pos <= t)
    if window > 0:
        valid &= pos > t - window
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgl,blkd->bkgd", prob.to(cdt).float(),
                     cache["v"].to(cdt).float()).to(x.dtype)
    return dense(p["wo"], o.reshape(B, 1, H * hd), cfg=cfg,
                 tag="attn/wo"), cache


# ---------------------------------------------------------------------------
# The paged pool (the serving engine)


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
    within itself through the position mask. The writes keep the tick's
    fixed ``B * C`` shape, as the reference's ``mode="drop"`` scatter:
    pad tokens and tokens whose block is unassigned carry the sentinel
    index and are dropped on the device (:func:`scatter_rows`).
    ``writes`` are those indices precomputed (:func:`paged_writes`, once
    per tick and group on the device); without them this layer computes
    its own. The read is ``decode_gqa`` with ``attn_backend``. Returns
    (out (B, C, d), cache)."""
    q, k_new, v_new = _project_qkv(p, x, t.clamp(min=0), cfg)
    Nb, bl = cache["k"].shape[:2]
    w = writes if writes is not None else paged_writes(table, t, Nb, bl)
    kn = k_new.flatten(0, 1)                        # (B*C, Hkv, hd)
    vn = v_new.flatten(0, 1)
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = quantize_kv(kn), quantize_kv(vn)
        for name, rows in (("k", kq), ("v", vq), ("k_scale", ks),
                           ("v_scale", vs)):
            scatter_rows(cache[name], w.blk, w.off, rows)
    else:
        scatter_rows(cache["k"], w.blk, w.off, kn)
        scatter_rows(cache["v"], w.blk, w.off, vn)
    scatter_rows(cache["pos"], w.b, w.lw, t.reshape(-1))
    o = decode_gqa(q, cache["k"], cache["v"], cache["pos"], t,
                   window=window, table=table, backend=attn_backend,
                   k_scale=cache.get("k_scale"),
                   v_scale=cache.get("v_scale"))
    return dense(p["wo"], o, cfg=cfg, tag="attn/wo"), cache
