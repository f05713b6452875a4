"""Decoder-only transformer (the port's counterpart of
``repro.models.lm.transformer``): the whole-sequence ``forward`` of
training (``train=True``: every mixer on its differentiable path, the
MoE aux loss summed over layers, each block rematerialised under
``cfg.remat``), the whole-prompt ``prefill`` and the lockstep
``decode_step`` over contiguous caches (the static path), and the
slot-batched step over the paged pool (the serving engine).

Layers form *groups* of identical blocks; a group's parameters and
caches stack along a leading ``n_layers`` axis, and the port walks that
axis in a Python loop where the reference scans. Ported block kinds:

  dense       norm -> GQA attention -> norm -> gated SiLU MLP
  moe         norm -> GQA attention -> norm -> MoE
  mla_dense   norm -> MLA           -> norm -> gated SiLU MLP (dense_d_ff)
  mla_moe     norm -> MLA           -> norm -> MoE
  ssm         norm -> Mamba-2 (no MLP)
  hybrid_full norm -> mean of (GQA attention || Mamba-2) -> norm -> MLP
  hybrid_swa  the same with sliding-window attention
  xdec        norm -> causal GQA attention -> norm -> cross-attention
              over the encoder's K/V -> norm -> GELU MLP (Whisper's
              decoder)

The vlm family runs dense blocks over its projected patch embeddings
(``vision_proj``) prepended to the tokens. Training, the slot path
(``SLOT_KINDS``) and the static path (``prefill``, ``decode_step``:
``STATIC_KINDS``) each run every kind above, so every LM family serves
under ``--static``. On the static path an MLA block caches contiguous
latent rows with per-row positions (``mla.init_mla_cache``) and decodes
through ``mla.mla_decode``; an MoE block's decode folds the batch into
one dispatch group (``moe_ffn(decode=True)``), as the reference's. A
hybrid block's cache nests ``{"kv": attention cache, "ssm": SSM state}``; an SSM
group has no block table in the paged pool (its state is per slot); an
xdec group's encoder K/V sits beside its cache under ``gname +
"/enc_kv"`` on the static path, and in the runner's per-slot buffer
(``enc_kv``) on the slot path. A kind on a path that does not run it
raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import Packer, PackedTensor
from repro_torch.kernels.ops import decode_gqa
from repro_torch.kernels.paged_attention import EMPTY_POS, paged_writes
from repro_torch.models.lm import attention as attn_mod
from repro_torch.models.lm import mla as mla_mod
from repro_torch.models.lm import moe as moe_mod
from repro_torch.models.lm import ssm as ssm_mod
from repro_torch.models.lm.common import (Params, dense, make_dense_params,
                                          make_mlp_params,
                                          make_rmsnorm_params, mlp, rmsnorm,
                                          truncated_normal_init)
from repro_torch.parallel import tensor_parallel as tp

# Layer kinds the slot-batched serving path covers in the port, the kinds
# the static path (whole-prompt prefill + lockstep decode) covers, and
# every kind whose parameters the port builds.
SLOT_KINDS = ("dense", "moe", "ssm", "mla_dense", "mla_moe", "hybrid_full",
              "hybrid_swa", "xdec")
STATIC_KINDS = ("dense", "moe", "ssm", "mla_dense", "mla_moe",
                "hybrid_full", "hybrid_swa", "xdec")
PARAM_KINDS = SLOT_KINDS
MLA_KINDS = ("mla_dense", "mla_moe")
MOE_KINDS = ("moe", "mla_moe")
HYBRID_KINDS = ("hybrid_full", "hybrid_swa")


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm"):
        return [("dense", L)]
    if cfg.family == "moe":
        if cfg.mla:
            nd = min(cfg.n_dense_layers, L)
            plan = []
            if nd:
                plan.append(("mla_dense", nd))
            if L - nd:
                plan.append(("mla_moe", L - nd))
            return plan
        return [("moe", L)]
    if cfg.family == "ssm":
        return [("ssm", L)]
    if cfg.family == "hybrid":
        # full attention at the first, middle and last layer, sliding
        # windows between them
        full = sorted({0, L // 2, L - 1})
        plan: List[Tuple[str, int]] = []
        prev = -1
        for f in full:
            if f - prev - 1 > 0:
                plan.append(("hybrid_swa", f - prev - 1))
            plan.append(("hybrid_full", 1))
            prev = f
        if L - 1 - full[-1] > 0:
            plan.append(("hybrid_swa", L - 1 - full[-1]))
        return plan
    if cfg.family == "audio":
        return [("xdec", L)]
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family has no layer plan "
        f"(ported block kinds: {PARAM_KINDS})")


def _block_window(cfg: ModelConfig, kind: str) -> int:
    """The attention window of a block kind (0: full attention)."""
    return cfg.sliding_window if kind == "hybrid_swa" else 0


def group_names(cfg: ModelConfig) -> List[Tuple[str, str, int]]:
    return [(f"g{gi}_{kind}", kind, n)
            for gi, (kind, n) in enumerate(layer_plan(cfg))]


def supports_slot_serving(cfg: ModelConfig) -> bool:
    """Token-only arch whose every block kind is ported. A frontend arch
    (vlm, audio) needs a patch or frame prefix that the token-only
    chunked prefill cannot feed: audio serves through its own runner,
    vlm through none."""
    if cfg.frontend_tokens:
        return False
    try:
        return all(kind in SLOT_KINDS for _, kind, _ in group_names(cfg))
    except NotImplementedError:
        return False


def _check_kind(kind: str, kinds=SLOT_KINDS, path: str = "slot") -> None:
    if kind not in kinds:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported on the {path} path "
            f"(ported: {kinds})")


# ---------------------------------------------------------------------------
# Parameters


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, *,
               lead=(), dtype=torch.float32, pack: Optional[Packer] = None,
               tag: str = "") -> Params:
    """One block's parameters, stacked over ``lead`` (e.g. (n_layers,)).
    ``pack`` packs each leaf as it is drawn (``tag``: the block's key
    path, e.g. ``groups/g0_dense/``)."""
    _check_kind(kind, PARAM_KINDS, "parameter")
    d = cfg.d_model
    norm = dict(lead=lead, dtype=dtype, device=gen.device)
    kw = dict(lead=lead, dtype=dtype)
    p: Params = {"ln1": make_rmsnorm_params(d, **norm)}
    if kind != "ssm":
        p["attn"] = (mla_mod.make_mla_params(gen, cfg, **kw)
                     if kind in MLA_KINDS
                     else attn_mod.make_attn_params(gen, cfg, **kw))
        if pack is not None:
            p["attn"] = pack.tree(p["attn"], tag + "attn/")
    if kind == "ssm" or kind in HYBRID_KINDS:
        p["ssm"] = ssm_mod.make_ssm_params(gen, cfg, **kw)
        if pack is not None:
            p["ssm"] = pack.tree(p["ssm"], tag + "ssm/")
    if kind == "ssm":
        return p
    p["ln2"] = make_rmsnorm_params(d, **norm)
    if kind in MOE_KINDS:
        p["ffn"] = moe_mod.make_moe_params(gen, cfg, pack=pack,
                                           tag=tag + "ffn", **kw)
    elif kind == "xdec":
        p["xattn"] = attn_mod.make_attn_params(gen, cfg, **kw)
        if pack is not None:
            p["xattn"] = pack.tree(p["xattn"], tag + "xattn/")
        p["ln_x"] = make_rmsnorm_params(d, **norm)
        p["ffn"] = make_mlp_params(gen, d, cfg.d_ff, gated=False, **kw)
    else:
        ff = (cfg.dense_d_ff or cfg.d_ff) if kind == "mla_dense" else cfg.d_ff
        p["ffn"] = make_mlp_params(gen, d, ff, **kw)
    if pack is not None:
        p["ffn"] = pack.tree(p["ffn"], tag + "ffn/")
    return p


def init_decoder(gen: torch.Generator, cfg: ModelConfig,
                 pack: Optional[Packer] = None, dtype=None) -> Params:
    """Layer-stacked decoder parameters in ``dtype`` (default
    ``cfg.dtype``, what serving holds; training holds fp32 master
    leaves, as the reference's init draws), drawn from ``gen`` on its
    device (truncated normal, std 0.02; norms ones, biases zeros — the
    reference's init, other random numbers). The vlm family's
    ``vision_proj`` (d -> d) is drawn after the groups. With
    ``cfg.mtp_depth`` the
    tree holds the reference's multi-token-prediction head (``mtp``:
    ``proj`` 2d -> d, one ``mla_dense`` or ``dense`` block, ``norm``),
    drawn last, which only the training loss reads.

    ``pack`` packs each weight as soon as it is drawn, so the float tree
    never exists whole; the result equals ``quantize_tree`` of the
    unpacked tree bit for bit."""
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    d = cfg.d_model
    params: Params = {
        "embed": truncated_normal_init(gen, (cfg.vocab_size, d),
                                       dtype=dtype),
        "final_norm": make_rmsnorm_params(d, dtype=dtype,
                                          device=gen.device),
    }
    if not cfg.tie_embeddings:
        head = make_dense_params(gen, d, cfg.vocab_size, dtype=dtype)
        params["lm_head"] = (pack.tree(head, "lm_head/") if pack is not None
                             else head)
    params["groups"] = {
        gname: init_block(gen, cfg, kind, lead=(n,), dtype=dtype, pack=pack,
                          tag=f"groups/{gname}/")
        for gname, kind, n in group_names(cfg)}
    if cfg.family == "vlm":
        proj = make_dense_params(gen, d, d, dtype=dtype)
        params["vision_proj"] = (pack.tree(proj, "vision_proj/")
                                 if pack is not None else proj)
    if cfg.mtp_depth:
        proj = make_dense_params(gen, 2 * d, d, dtype=dtype)
        params["mtp"] = {
            "proj": pack.tree(proj, "mtp/proj/") if pack is not None
            else proj,
            "block": init_block(gen, cfg, "mla_dense" if cfg.mla
                                else "dense", dtype=dtype, pack=pack,
                                tag="mtp/block/"),
            "norm": make_rmsnorm_params(d, dtype=dtype, device=gen.device)}
    return params


def layer_views(stack: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """Per-layer views of a layer-stacked tree (PackedTensor children
    sliced too; nothing is copied). Each leaf is unbound once, so the
    backward through the views stacks the layers' gradients in one op;
    indexing a layer would fill a zero tensor of the whole stack for
    each layer's gradient."""
    out: List[Dict[str, Any]] = [{} for _ in range(n)]
    for k, v in stack.items():
        if isinstance(v, dict):
            parts = layer_views(v, n)
        elif isinstance(v, PackedTensor):
            parts = [PackedTensor(d, sc, v.bits, v.orig_shape) for d, sc
                     in zip(v.data.unbind(0), v.scale.unbind(0))]
        else:
            parts = v.unbind(0)
        for view, part in zip(out, parts):
            view[k] = part
    return out


def param_layer_views(params: Params, cfg: ModelConfig
                      ) -> Dict[str, List[Params]]:
    """{group name: per-layer parameter views} — what a runner keeps so
    that a tick does not re-slice the stacks."""
    return {gname: layer_views(params["groups"][gname], n)
            for gname, _, n in group_names(cfg)}


# ---------------------------------------------------------------------------
# Forward pieces


def vocab_split(params: Params, cfg: ModelConfig) -> bool:
    """Whether ``params`` hold this rank's rows of a vocabulary split over
    a tensor-parallel model group (``parallel/tensor_parallel``): the
    ``embed`` rows and the ``lm_head`` columns split together."""
    return tp.size() > 1 and params["embed"].shape[0] != cfg.vocab_size


def embed_tokens(params: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The tokens' embedding rows in ``cfg.dtype``. Vocabulary-parallel
    (:func:`vocab_split`): each rank looks up the tokens among its rows,
    -0.0 for the others, and the lookups are summed over the group; one
    rank holds each row, so the sum is the row itself."""
    dt = getattr(torch, cfg.dtype)
    emb = params["embed"]
    if not vocab_split(params, cfg):
        return emb[tokens.long()].to(dt)
    n = emb.shape[0]
    idx = tokens.long() - tp.rank() * n
    mine = (idx >= 0) & (idx < n)
    x = emb[torch.where(mine, idx, 0)].to(dt)
    return tp.reduce_from_model(torch.where(mine[..., None], x, -0.0))


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """Logits over the vocabulary, tied or not; vocabulary-parallel
    (:func:`vocab_split`): this rank's columns, for
    ``common.cross_entropy(vocab_size=)``."""
    split = vocab_split(params, cfg)
    x = tp.copy_to_model(x, split)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(x.dtype).T
    return dense(params["lm_head"], x, cfg=cfg, tag="lm_head",
                 parallel="col" if split else "")


def embed_inputs(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 patch_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The token embeddings, after the projected patch embeddings (B, P,
    d) of a vlm prompt when given."""
    x = embed_tokens(params, tokens, cfg)
    if patch_embeds is None:
        return x
    pe = dense(params["vision_proj"],
               patch_embeds.to(getattr(torch, cfg.dtype)), cfg=cfg,
               tag="vision_proj")
    return torch.cat([pe, x], dim=1)


def _mlp_act(cfg: ModelConfig) -> str:
    """The ungated MLP's activation: GELU for the audio family."""
    return "gelu" if cfg.family == "audio" else "silu"


# ---------------------------------------------------------------------------
# Cross-attention over the encoder's K/V (the audio family's xdec blocks)


def enc_kv_for_layer(p: Params, enc_out: torch.Tensor, cfg: ModelConfig
                     ) -> Dict[str, torch.Tensor]:
    """One decoder layer's cross-attention K/V (B, Se, Hkv, hd) from the
    encoder's output (B, Se, d); ``p`` is the layer's ``xattn``. Over a
    tensor-parallel model group that splits the cross-attention, this
    rank's ``Hkv/M`` heads: ``enc_out`` enters ``wk``/``wv``'s columns
    through ``copy_to_model``."""
    B, Se, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    split = attn_mod.heads_split(p, cfg)
    kw = dict(cfg=cfg, parallel="col" if split else "")
    e = tp.copy_to_model(enc_out, split)
    k = dense(p["wk"], e, tag="xattn/wk", **kw)
    v = dense(p["wv"], e, tag="xattn/wv", **kw)
    return {"k": k.reshape(B, Se, -1, hd), "v": v.reshape(B, Se, -1, hd)}


def _cross_attn(p: Params, x: torch.Tensor, enc_kv: Dict, cfg: ModelConfig,
                attn_backend: Optional[str] = None) -> torch.Tensor:
    """Cross-attention of x (B, S, d) over every encoder position of
    ``enc_kv`` {"k", "v": (B, Se, Hkv, hd)}; ``p`` is the layer's
    ``xattn``. With ``attn_backend == "cuda"`` a single-token step (S ==
    1) runs ``ops.decode_gqa`` over the buffer as contiguous rows (every
    position visible), K/V upcast to fp32 as the reference does; every
    other call (prefill, training, a chunk of several tokens) the dense
    fp32 einsum, the same math on every backend. Over a tensor-parallel
    model group that splits it, over this rank's ``H/M`` query and
    ``Hkv/M`` KV heads (:func:`enc_kv_for_layer`): ``x`` enters ``wq``
    through ``copy_to_model``, and ``wo`` is row-parallel."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = x.dtype
    split = attn_mod.heads_split(p, cfg)
    q = dense(p["wq"], tp.copy_to_model(x, split), cfg=cfg, tag="xattn/wq",
              parallel="col" if split else "").reshape(B, S, -1, hd)
    if attn_backend == "cuda" and S == 1:
        Se = enc_kv["k"].shape[1]
        pos = torch.arange(Se, dtype=torch.int32,
                           device=x.device)[None, :].expand(B, Se)
        t = torch.full((B, 1), Se, dtype=torch.int32, device=x.device)
        o = decode_gqa(q, enc_kv["k"].float(), enc_kv["v"].float(), pos, t,
                       backend=attn_backend).to(dt)
        return dense(p["wo"], o, cfg=cfg, tag="xattn/wo")
    group = q.shape[2] // enc_kv["k"].shape[2]
    k = enc_kv["k"].repeat_interleave(group, dim=2).float()
    v = enc_kv["v"].repeat_interleave(group, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * hd ** -0.5
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", prob, v)
    return dense(p["wo"], o.reshape(B, S, -1).to(dt), cfg=cfg,
                 tag="xattn/wo", parallel="row" if split else "")


def _cross(p: Params, x: torch.Tensor, enc_kv: Optional[Dict],
           cfg: ModelConfig, attn_backend: Optional[str] = None
           ) -> torch.Tensor:
    """An xdec block's cross-attention sub-layer (none without
    ``enc_kv``, as the reference's forward without an encoder)."""
    if enc_kv is None:
        return x
    hx = rmsnorm(p["ln_x"], x, cfg.norm_eps)
    return x + _cross_attn(p["xattn"], hx, enc_kv, cfg, attn_backend)


# ---------------------------------------------------------------------------
# The whole sequence: the training forward, and the static path's
# prefill and lockstep decode over contiguous caches


def _mixer_forward(p: Params, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, kind: str, train: bool):
    """Token mixer over the whole sequence -> (y, cache hand-off). A
    hybrid block runs attention (windowed for ``hybrid_swa``) and the
    SSM side by side on the same input and takes their mean; its
    hand-off nests ``{"kv", "ssm"}``."""
    if kind in MLA_KINDS:
        return mla_mod.mla_forward(p["attn"], x, positions, cfg)
    if kind == "ssm":
        return ssm_mod.ssm_forward(p["ssm"], x, cfg, train=train)
    if kind in HYBRID_KINDS:
        # over a model group each split branch's row-parallel output is
        # left as this rank's partial sum: where both split, their mean
        # is summed over the group once; a whole branch is added after
        # the other's sum, so it counts once
        ya, kv = attn_mod.attn_forward(p["attn"], x, positions, cfg,
                                       window=_block_window(cfg, kind),
                                       train=train, reduce=False)
        ys, st = ssm_mod.ssm_forward(p["ssm"], x, cfg, train=train,
                                     reduce=False)
        sa = attn_mod.heads_split(p["attn"], cfg)
        ss = ssm_mod.ssm_ranks(p["ssm"], cfg) > 1
        if sa and ss:
            y = tp.reduce_from_model(0.5 * (ya + ys))
        else:
            y = 0.5 * (tp.reduce_from_model(ya, sa)
                       + tp.reduce_from_model(ys, ss))
        return y, {"kv": kv, "ssm": st}
    return attn_mod.attn_forward(p["attn"], x, positions, cfg, train=train)


def block_forward(p: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, kind: str, *, train: bool = False,
                  enc_kv: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """One block over the whole sequence. Returns (x_out, aux loss (the
    MoE load balance; 0 for the other kinds), cache hand-off).
    ``train``: the mixers' differentiable paths (``blockwise_attn``,
    ``ssd_chunked``) in place of the prefill kernels, which have no
    backward. ``enc_kv``: an xdec layer's encoder K/V."""
    _check_kind(kind, PARAM_KINDS, "whole-sequence")
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    mix, kv = _mixer_forward(p, h, positions, cfg, kind, train)
    x = x + mix
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "ssm":
        return x, aux, kv
    if kind == "xdec":
        x = _cross(p, x, enc_kv, cfg)
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind in MOE_KINDS:
        y, aux = moe_mod.moe_ffn(p["ffn"], h2, cfg)
    else:
        y = mlp(p["ffn"], h2, cfg=cfg, tag="mlp", act=_mlp_act(cfg))
    return x + y, aux, kv


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, dtype=torch.int32,
                        device=x.device)[None, :].expand(B, S)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
            train: bool = False, patch_embeds: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-sequence forward -> (final-normed hidden (B, S, d), the aux
    loss summed over layers). tokens: (B, S). ``train``: the training
    forward (:func:`block_forward`'s ``train``); with ``cfg.remat``
    each block is rematerialised in the backward
    (``torch.utils.checkpoint``), as the reference wraps its scan step
    in ``jax.checkpoint``. ``patch_embeds`` (B, P, d): a vlm prompt's
    patches, projected and prepended (S counts them); ``enc_out`` (B,
    Se, d): the encoder's output that every xdec layer attends to."""
    x = embed_inputs(params, tokens, cfg, patch_embeds)
    positions = _positions(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = train and cfg.remat and torch.is_grad_enabled()
    for gname, kind, n in group_names(cfg):
        def step(p, xc, kind=kind):
            ekv = (enc_kv_for_layer(p["xattn"], enc_out, cfg)
                   if kind == "xdec" and enc_out is not None else None)
            return block_forward(p, xc, positions, cfg, kind, train=train,
                                 enc_kv=ekv)[:2]
        for p in layer_views(params["groups"][gname], n):
            x, a = (checkpoint(step, p, x, use_reentrant=False) if remat
                    else step(p, x))
            aux = aux + a
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _stacked(tree: Dict, lead) -> Dict:
    """Each leaf of ``tree`` repeated over a leading ``lead`` (a copy)."""
    return {k: _stacked(v, lead) if isinstance(v, dict)
            else v.expand(*lead, *v.shape).clone() for k, v in tree.items()}


def init_block_cache(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int, dtype=torch.bfloat16, lead=(),
                     device=None, state_dtype=torch.float32) -> Dict:
    """Empty contiguous cache of one block kind, stacked over ``lead``:
    attention K/V in ``dtype`` (a ``hybrid_swa`` layer's a ring of its
    window); MLA latent rows in ``dtype`` with per-row positions; SSM
    state h fp32 and conv in ``state_dtype`` (fp32 as the reference's
    ``init_ssm_cache``; a prefill fills it with the activation dtype's
    hand-off)."""
    _check_kind(kind, STATIC_KINDS, "static")
    if kind in MLA_KINDS:
        return mla_mod.init_mla_cache(cfg, batch, cache_len, dtype,
                                      lead=lead, device=device)
    attn = dict(window=_block_window(cfg, kind), dtype=dtype, device=device)
    if kind == "ssm":
        one = ssm_mod.init_ssm_cache(cfg, batch, state_dtype, device=device)
    elif kind in HYBRID_KINDS:
        one = {"kv": attn_mod.init_attn_cache(cfg, batch, cache_len, **attn),
               "ssm": ssm_mod.init_ssm_cache(cfg, batch, state_dtype,
                                             device=device)}
    else:
        one = attn_mod.init_attn_cache(cfg, batch, cache_len, **attn)
    return _stacked(one, lead)


def fill_block_cache(cfg: ModelConfig, kind: str, cache: Dict,
                     kv: Dict) -> Dict:
    """One layer's cache from its prefill hand-off, written into
    ``cache`` in place: attention K/V (a ring keeps the last positions);
    MLA's latent ``{"c", "k_rope"}``; the SSM state as handed off (h
    fp32, the conv window)."""
    if kind in MLA_KINDS:
        return mla_mod.fill_mla_cache(cache, kv)
    if kind == "ssm":
        for name in ("h", "conv"):
            cache[name].copy_(kv[name])
        return cache
    if kind in HYBRID_KINDS:
        fill_block_cache(cfg, "ssm", cache["ssm"], kv["ssm"])
        attn_mod.fill_cache_from_prefill(cache["kv"], kv["kv"])
        return cache
    return attn_mod.fill_cache_from_prefill(cache, kv)


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            cache_len: Optional[int] = None,
            cache_dtype=torch.bfloat16,
            patch_embeds: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None,
            caches: Optional[Dict] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt (B, S) and fill per-group contiguous caches, each
    layer's as the layer runs: :func:`init_caches`' trees of
    ``cache_len`` positions (default S, patches included), attention K/V
    in ``cache_dtype``, the SSM state as handed off (h fp32, conv in the
    activation dtype, as the reference returns it). ``patch_embeds``/
    ``enc_out`` as :func:`forward`; an xdec group's encoder K/V is kept
    in ``cache_dtype`` under ``gname + "/enc_kv"`` (stacked over its
    layers), where :func:`decode_step` reads it.

    ``caches``: trees laid out as :func:`init_caches` lays them out
    (``state_dtype`` the activation dtype), allocated by the caller and
    filled in place, ``cache_len`` and ``cache_dtype`` then theirs; they
    are first reset (:func:`reset_caches`), so nothing an earlier pass
    left in them is seen. The static plans allocate theirs once, outside
    any CUDA graph. Returns (last-position logits (B, 1, V), caches)."""
    x = embed_inputs(params, tokens, cfg, patch_embeds)
    B, S, _ = x.shape
    if caches is None:
        caches = init_caches(cfg, B, cache_len or S, cache_dtype,
                             device=x.device, state_dtype=x.dtype,
                             enc_len=0 if enc_out is None
                             else enc_out.shape[1])
    else:
        reset_caches(cfg, caches)
    positions = _positions(x)
    for gname, kind, n in group_names(cfg):
        ekvs = (layer_views(caches[gname + "/enc_kv"], n)
                if kind == "xdec" and enc_out is not None else [None] * n)
        for p, c, stored in zip(layer_views(params["groups"][gname], n),
                                layer_views(caches[gname], n), ekvs):
            ekv = None
            if stored is not None:
                ekv = enc_kv_for_layer(p["xattn"], enc_out, cfg)
                for name in ("k", "v"):
                    stored[name].copy_(ekv[name])
            x, _, kv = block_forward(p, x, positions, cfg, kind, enc_kv=ekv)
            fill_block_cache(cfg, kind, c, kv)
    x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return unembed(params, x, cfg), caches


def block_decode(p: Params, x: torch.Tensor, cache: Dict, t: torch.Tensor,
                 cfg: ModelConfig, kind: str, enc_kv: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    """One block of the lockstep decode; x: (B, 1, d); t: the position,
    a 0-d int32 tensor on x's device (the reference's traced scalar: no
    Python index is taken from it, so a CUDA graph replays the block at
    any position); ``enc_kv``: an xdec layer's encoder K/V (read by the
    dense einsum, as the reference's static decode reads it). MLA reads
    its latent rows through ``decode_mla``'s gather route, as the
    reference's; MoE routes the batch as one dispatch group."""
    _check_kind(kind, STATIC_KINDS, "static")
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "ssm":
        mix, nc = ssm_mod.ssm_decode(p["ssm"], h, cache, cfg)
        return x + mix, nc
    if kind in MLA_KINDS:
        mix, nc = mla_mod.mla_decode(p["attn"], h, cache, t, cfg)
    elif kind in HYBRID_KINDS:
        ya, nkv = attn_mod.attn_decode(p["attn"], h, cache["kv"], t, cfg,
                                       window=_block_window(cfg, kind))
        ys, nst = ssm_mod.ssm_decode(p["ssm"], h, cache["ssm"], cfg)
        mix, nc = 0.5 * (ya + ys), {"kv": nkv, "ssm": nst}
    else:
        mix, nc = attn_mod.attn_decode(p["attn"], h, cache, t, cfg)
    x = x + mix
    if kind == "xdec":
        x = _cross(p, x, enc_kv, cfg)
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind in MOE_KINDS:
        y, _ = moe_mod.moe_ffn(p["ffn"], h2, cfg, decode=True)
    else:
        y = mlp(p["ffn"], h2, cfg=cfg, tag="mlp", act=_mlp_act(cfg))
    return x + y, nc


def decode_step(params: Params, caches: Dict, tokens: torch.Tensor, t,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One token for the whole stack, every row at position ``t``: a 0-d
    int32 tensor, or an int, which becomes one on the tokens' device
    here, once (everything below takes the tensor). tokens: (B, 1). The
    caches are updated in place and returned (an xdec group's
    ``/enc_kv`` entry is read, never written). Returns (logits (B, 1,
    V), caches)."""
    t = torch.as_tensor(t, dtype=torch.int32, device=tokens.device)
    x = embed_tokens(params, tokens, cfg)
    for gname, kind, n in group_names(cfg):
        ekv = caches.get(gname + "/enc_kv")
        ekvs = layer_views(ekv, n) if ekv is not None else [None] * n
        for p, c, e in zip(layer_views(params["groups"][gname], n),
                           layer_views(caches[gname], n), ekvs):
            x, nc = block_decode(p, x, c, t, cfg, kind, enc_kv=e)
            _copy_back(c, nc)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, x, cfg), caches


def _copy_back(cache: Dict, new: Dict) -> None:
    """Copy each leaf of ``new`` that is not ``cache``'s own tensor (SSM
    state comes back new) into ``cache`` in place."""
    for name, leaf in new.items():
        if isinstance(leaf, dict):
            _copy_back(cache[name], leaf)
        elif leaf is not cache[name]:
            cache[name].copy_(leaf)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                cache_dtype=torch.bfloat16, device=None, *,
                state_dtype=torch.float32,
                enc_len: Optional[int] = None) -> Dict:
    """Empty contiguous caches of the static path, per group stacked
    over its layers (:func:`init_block_cache`: MLA groups hold latent
    rows with per-row positions; SSM conv state in ``state_dtype``); an
    xdec group's encoder K/V (``enc_len`` positions, default
    ``frontend_tokens``; 0: none) zero beside it."""
    enc_len = cfg.frontend_tokens if enc_len is None else enc_len
    caches: Dict[str, Any] = {}
    for gname, kind, n in group_names(cfg):
        caches[gname] = init_block_cache(cfg, kind, batch, cache_len,
                                         dtype=cache_dtype, lead=(n,),
                                         device=device,
                                         state_dtype=state_dtype)
        if kind == "xdec" and enc_len:
            shape = (n, batch, enc_len, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            caches[gname + "/enc_kv"] = {
                name: torch.zeros(shape, dtype=cache_dtype, device=device)
                for name in ("k", "v")}
    return caches


def reset_caches(cfg: ModelConfig, caches: Dict) -> Dict:
    """Reset :func:`init_caches`' trees in place wherever a stale value
    could be read: every position empty and the SSM state zero, as
    :func:`caches_reset_specs` says for the paged pool. K/V and latent
    rows are ``keep``, masked by their positions; an xdec group's
    encoder K/V is overwritten whole by the prefill."""
    def reset(tree: Dict, spec: Dict) -> None:
        for name, leaf in tree.items():
            action = spec.get(name, "keep")
            if isinstance(leaf, dict):
                reset(leaf, action)
            elif action == "empty":
                leaf.fill_(EMPTY_POS)
            elif action == "zero":
                leaf.zero_()
    for gname, spec in caches_reset_specs(cfg).items():
        reset(caches[gname], spec)
    return caches


def block_decode_slots(p: Params, x: torch.Tensor, cache: Dict,
                       t: torch.Tensor, cfg: ModelConfig, kind: str, *,
                       table: Optional[torch.Tensor],
                       attn_backend: Optional[str] = None,
                       writes=None, enc_kv: Optional[Dict] = None
                       ) -> Tuple[torch.Tensor, Dict]:
    """One block of the slot-batched step; x: (B, C, d); t: (B, C).
    ``table``: the group's block table (None for an SSM group, whose
    state is per slot). ``enc_kv``: an xdec layer's per-slot encoder K/V
    (B, Se, Hkv, hd), written at admission and only read here (a pad
    row's cross-attention output is ignored, and writes nothing). The
    cache updates in place."""
    _check_kind(kind)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "ssm":
        mix, cache = ssm_mod.ssm_decode_slots(p["ssm"], h, cache, t, cfg)
        return x + mix, cache
    kw = dict(table=table, attn_backend=attn_backend, writes=writes)
    if kind in HYBRID_KINDS:
        ya, _ = attn_mod.attn_decode_slots(p["attn"], h, cache["kv"], t,
                                           cfg,
                                           window=_block_window(cfg, kind),
                                           **kw)
        ys, _ = ssm_mod.ssm_decode_slots(p["ssm"], h, cache["ssm"], t, cfg)
        mix = 0.5 * (ya + ys)
    else:
        mixer = (mla_mod.mla_decode_slots if kind in MLA_KINDS
                 else attn_mod.attn_decode_slots)
        mix, cache = mixer(p["attn"], h, cache, t, cfg, **kw)
    x = x + mix
    if kind == "xdec":
        x = _cross(p, x, enc_kv, cfg, attn_backend)
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind in MOE_KINDS:
        # pad slots (t < 0) take no part in expert routing: a live
        # request's routing must not depend on how many slots are free
        y, _ = moe_mod.moe_ffn(p["ffn"], h2, cfg, decode=x.shape[1] == 1,
                               pad_mask=t >= 0)
    else:
        y = mlp(p["ffn"], h2, cfg=cfg, tag="mlp", act=_mlp_act(cfg))
    return x + y, cache


def decode_step_slots(params: Params, caches: Dict, tokens: torch.Tensor,
                      t: torch.Tensor, cfg: ModelConfig,
                      logits_at: Optional[torch.Tensor] = None,
                      tables: Optional[Dict[str, torch.Tensor]] = None,
                      attn_backend: Optional[str] = None,
                      layers: Optional[Dict[str, List[Params]]] = None,
                      enc_kv: Optional[Dict[str, Dict]] = None
                      ) -> Tuple[torch.Tensor, Dict]:
    """Slot-batched decode/chunk step of the serving engine.

    tokens, t: (B, C) int32, ``t < 0`` for padding (pad rows give
    garbage logits and write nothing). ``tables``: {group: (B, T) block
    table} over the paged ``caches`` (none for an SSM group), which are
    updated in place and returned. ``logits_at`` (B,) unembeds only
    each row's emitting column. ``layers``: per-layer parameter views
    (:func:`param_layer_views`), else sliced here. ``enc_kv``: {xdec
    group: {"k", "v": (n_layers, B, Se, Hkv, hd)}}, the per-slot encoder
    buffers the audio family's runner stages at admission.

    ``tokens``, ``t``, ``logits_at`` and ``tables`` may sit on the host
    (they move to the parameters' device once per call, every one
    before the first layer is enqueued: a copy from pageable host memory
    waits for the stream) or on the device already, as a tick plan
    stages them. Each paged group's writes
    (:func:`repro_torch.kernels.paged_attention.paged_writes`) are
    computed once per call on the device, at the tick's fixed ``(B,
    C)`` shape with dropped writes marked, as the reference's: nothing
    is read back, so the step can be captured in a CUDA graph. Returns
    (logits (B, C or 1, V), caches).
    """
    dev = params["embed"].device
    if layers is None:
        layers = param_layer_views(params, cfg)
    t_dev = t.to(dev, torch.int32, non_blocking=True)
    tok_dev = tokens.to(dev, non_blocking=True)
    idx = (None if logits_at is None else
           logits_at.to(dev, torch.long, non_blocking=True))
    tables_dev = {g: tb.to(dev, torch.int32, non_blocking=True)
                  for g, tb in (tables or {}).items()}
    paged: Dict[str, Tuple[torch.Tensor, Any]] = {}
    for gname, _, _ in group_names(cfg):
        table = tables_dev.get(gname)
        if table is not None:
            Nb, bl = _arena(caches[gname]).shape[1:3]
            paged[gname] = (table, paged_writes(table, t_dev, Nb, bl))
    x = embed_tokens(params, tok_dev.clamp(min=0), cfg)
    for gname, kind, n in group_names(cfg):
        table_dev, writes = paged.get(gname, (None, None))
        ekv = None if enc_kv is None else enc_kv.get(gname)
        ekvs = layer_views(ekv, n) if ekv is not None else [None] * n
        for p, c, e in zip(layers[gname], layer_views(caches[gname], n),
                           ekvs):
            x, _ = block_decode_slots(p, x, c, t_dev, cfg, kind,
                                      table=table_dev,
                                      attn_backend=attn_backend,
                                      writes=writes, enc_kv=e)
    if idx is not None:
        x = x[torch.arange(x.shape[0], device=dev), idx.clamp(min=0)][:, None]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, x, cfg), caches


# ---------------------------------------------------------------------------
# The paged cache pool's per-group layout


def _arena(cache: Dict) -> torch.Tensor:
    """A group's (layer-stacked) block arena: latent ``c`` for MLA groups,
    ``k`` for attention groups (under ``kv`` in a hybrid group)."""
    cache = cache.get("kv", cache)
    return cache["c"] if "c" in cache else cache["k"]


def _state_dtype(dtype: torch.dtype) -> torch.dtype:
    """The storage of a group's SSM conv state under a cache dtype: the
    recurrent state has no masking point and feeds forward
    multiplicatively, so a 1-byte policy (fp8, int8) keeps it bf16."""
    return torch.bfloat16 if dtype.itemsize < 2 else dtype


def paged_group_layout(cfg: ModelConfig, cache_len: int,
                       block_len: int) -> Dict[str, int]:
    """{group name: blocks per slot (T)} for every KV-bearing group. An
    SSM group has no table (its state is per slot); a sliding-window
    group rings at ``min(window, cache_len)``, so it needs fewer blocks
    a slot than a full-attention group."""
    return {gname: -(-attn_mod.attn_ring_len(
                cfg, cache_len, window=_block_window(cfg, kind))
                // block_len)
            for gname, kind, _ in group_names(cfg) if kind != "ssm"}


def init_caches_paged(cfg: ModelConfig, n_slots: int, cache_len: int,
                      n_blocks: Dict[str, int], block_len: int,
                      cache_dtype=torch.bfloat16, device=None) -> Dict:
    """Empty paged pool caches: per group, arenas ``(n_layers,
    n_blocks[g], block_len, Hkv, hd)`` (MLA groups: latent arenas
    ``(n_layers, n_blocks[g], block_len, kvr|rope)``) and positions
    ``(n_layers, n_slots, T * block_len)``; SSM state per slot
    (:func:`repro_torch.models.lm.ssm.init_ssm_cache_slots`, conv in
    :func:`_state_dtype`), under ``ssm`` beside the attention cache's
    ``kv`` in a hybrid group. ``cache_dtype`` is one storage dtype or a
    ``{group: dtype}`` mapping (int8 groups grow fp32 scale arenas)."""
    caches: Dict[str, Any] = {}
    for gname, kind, n in group_names(cfg):
        _check_kind(kind)
        dt = (cache_dtype.get(gname, torch.bfloat16)
              if isinstance(cache_dtype, dict) else cache_dtype)
        kw = dict(lead=(n,), device=device)
        state = (ssm_mod.init_ssm_cache_slots(cfg, n_slots, _state_dtype(dt),
                                              **kw)
                 if kind == "ssm" or kind in HYBRID_KINDS else None)
        if kind == "ssm":
            caches[gname] = state
            continue
        init = (mla_mod.init_mla_cache_paged if kind in MLA_KINDS
                else functools.partial(attn_mod.init_attn_cache_paged,
                                       window=_block_window(cfg, kind)))
        kv = init(cfg, n_slots, cache_len, n_blocks.get(gname, 0),
                  block_len, dtype=dt, **kw)
        caches[gname] = kv if state is None else {"kv": kv, "ssm": state}
    return caches


def _quantized(cache_dtype, gname) -> bool:
    dt = (cache_dtype.get(gname, torch.bfloat16)
          if isinstance(cache_dtype, dict) else cache_dtype)
    return dt == torch.int8


def _block_spec(kind: str, quantized: bool, mla, attn, ssm) -> Dict:
    """One block's spec tree, shaped as its paged cache: ``mla``,
    ``attn`` and ``ssm`` are the modules' spec functions."""
    if kind == "ssm":
        return ssm()
    if kind in HYBRID_KINDS:
        return {"kv": attn(quantized), "ssm": ssm()}
    return (mla if kind in MLA_KINDS else attn)(quantized)


def caches_reset_specs(cfg: ModelConfig, cache_dtype=None) -> Dict:
    """Reset-spec tree matching :func:`init_caches_paged`: per leaf
    ``keep`` (stale but masked), ``empty`` (positions) or ``zero`` (SSM
    state, which no mask can hide)."""
    return {gname: _block_spec(kind, _quantized(cache_dtype, gname),
                               mla_mod.mla_cache_reset_spec,
                               attn_mod.attn_cache_reset_spec,
                               ssm_mod.ssm_cache_reset_spec)
            for gname, kind, _ in group_names(cfg)}


def caches_slot_axes(cfg: ModelConfig, cache_dtype=None) -> Dict:
    """Slot-axis tree matching :func:`init_caches_paged`."""
    return {gname: _block_spec(kind, _quantized(cache_dtype, gname),
                               mla_mod.mla_cache_slot_axes,
                               attn_mod.attn_cache_slot_axes,
                               ssm_mod.ssm_cache_slot_axes)
            for gname, kind, _ in group_names(cfg)}
