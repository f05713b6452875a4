"""Mixture-of-Experts FFN — GShard-style token-choice top-k with capacity
(the port's counterpart of ``repro.models.lm.moe``).

Routing is the reference's, step for step: softmax gates, iterative
top-1 x k (ties to the first expert), a per-(group, expert) capacity with
overflow dropped, pad tokens excluded, combine weights renormalised over
the chosen experts. The experts then run in the reference's
capacity-slot form, every expert's ``capacity`` slots of every group at
a fixed shape, restricted to at most ``n = min(E, G·S·k)`` experts, the
most a call can choose (:func:`_routed`). Nothing of the routing is read
back to the host, so a tick that routes is held by a CUDA graph. Each
expert is dequantized as ``kernel_of`` does, ``EXPERT_CHUNK`` experts at
a time. Fake tensors (the dry run's counter) take the reference's
program as it is, every expert at once (:func:`_routed_dense`).

Expert parallelism (a tensor-parallel training step,
``parallel/tensor_parallel``): where the model group's size divides
``n_experts``, each rank holds ``E/M`` experts of every stack. The
router and the dispatch stay whole and are the same on every rank;
:func:`_routed` walks this rank's experts and sums their fp32 outputs
over the group before the one rounding to the activation dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.compat import is_fake
from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import (Packer, PackedTensor, dequantize,
                                           quantize_tensor)
from repro_torch.models.lm.common import (Params, dense, kernel_of,
                                          make_dense_params,
                                          make_mlp_params, mlp,
                                          truncated_normal_init)
from repro_torch.parallel import tensor_parallel as tp

# Experts drawn (and packed) at a time: one draw of a whole full-width
# stack (256 x 7168 x 2048) would be 15 GB of fp32 before its cast.
EXPERT_CHUNK = 8


def _draw_experts(gen: torch.Generator, shape, dtype, pack: Optional[Packer],
                  tag: str):
    """An expert stack ``(*lead, E, a, b)`` drawn ``EXPERT_CHUNK`` experts
    at a time, and packed chunk by chunk when ``pack`` packs the leaf.
    Per-channel scales reduce over axis -2 only, so the packed stack is
    bit-identical to packing the whole stack at once."""
    E = shape[-3]
    bits = pack.bits(tag, shape) if pack is not None else 0
    parts, out = [], None
    for e0 in range(0, E, EXPERT_CHUNK):
        n = min(EXPERT_CHUNK, E - e0)
        w = truncated_normal_init(gen, (*shape[:-3], n, *shape[-2:]),
                                  dtype=dtype)
        if not bits:
            parts.append(w)
            continue
        pt = quantize_tensor(w, bits)
        if out is None:
            lead = tuple(shape[:-3]) + (E,)
            out = PackedTensor(
                torch.empty(lead + tuple(pt.data.shape[-2:]),
                            dtype=pt.data.dtype, device=w.device),
                torch.empty(lead + tuple(pt.scale.shape[-2:]),
                            dtype=pt.scale.dtype, device=w.device),
                bits, tuple(shape))
        out.data[..., e0:e0 + n, :, :] = pt.data
        out.scale[..., e0:e0 + n, :, :] = pt.scale
        del w, pt
    return out if bits else torch.cat(parts, dim=-3)


def make_moe_params(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
                    dtype=torch.float32, pack: Optional[Packer] = None,
                    tag: str = "ffn") -> Params:
    """Router, expert stacks ``wi``/``wg`` (E, d, ff) and ``wo`` (E, ff,
    d), and the shared expert's MLP. ``pack`` packs the expert stacks as
    they are drawn (``tag`` is their key path for its rule)."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    p = {"router": make_dense_params(gen, d, E, stddev=0.006, lead=lead,
                                     dtype=dtype)}
    for name, (a, b) in (("wi", (d, ff)), ("wg", (d, ff)), ("wo", (ff, d))):
        p[name] = _draw_experts(gen, (*lead, E, a, b), dtype, pack,
                                f"{tag}/{name}")
    if cfg.n_shared_experts:
        p["shared"] = make_mlp_params(gen, d, ff * cfg.n_shared_experts,
                                      lead=lead, dtype=dtype)
    return p


def _top_k_dispatch(gates: torch.Tensor, k: int, capacity: int,
                    mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gates: (G, S, E) softmax probs. Returns (dispatch (G, S, E, cap)
    bool, combine (G, S, E, cap) fp32, aux load-balance loss).

    ``mask`` (G, S), 0 for padding tokens: masked tokens are excluded
    from routing — they take no expert capacity and do not shift other
    tokens' slots."""
    G, S, E = gates.shape
    if mask is not None:
        gates = gates * mask.to(gates.dtype)[..., None]
    dev = gates.device
    combine = torch.zeros((G, S, E, capacity), dtype=torch.float32,
                          device=dev)
    dispatch = torch.zeros((G, S, E, capacity), dtype=torch.bool, device=dev)
    slots = torch.arange(capacity, device=dev)
    experts = torch.arange(E, device=dev)
    remaining = gates
    counts = torch.zeros((G, E), dtype=torch.int32, device=dev)
    me = gates.mean(dim=1)                              # (G, E) mean prob
    ce = torch.zeros((G, E), dtype=torch.float32, device=dev)
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)           # ties: first index
        # F.one_hot's bounds check reads idx on the host on the CPU
        onehot = (idx[..., None] == experts).float()
        if mask is not None:
            onehot = onehot * mask.to(onehot.dtype)[..., None]
        prob = (gates * onehot).sum(dim=-1)             # (G, S)
        pos = counts[:, None, :] + (torch.cumsum(onehot, dim=1) - onehot)
        pos_tok = (pos * onehot).sum(dim=-1)            # (G, S)
        fits = pos_tok < capacity
        # one-hot of the slot; an overflowing slot (>= capacity) is all 0
        pos_oh = (pos_tok.long()[..., None] == slots).float()
        upd = ((onehot * (prob * fits)[..., None])[..., None]
               * pos_oh[:, :, None, :])
        combine = combine + upd
        dispatch = dispatch | (upd > 0)
        counts = counts + onehot.sum(dim=1).to(torch.int32)
        ce = ce + onehot.mean(dim=1)
        remaining = remaining * (1.0 - onehot)
    denom = combine.sum(dim=(2, 3), keepdim=True)
    combine = combine / torch.clamp_min(denom, 1e-9)
    aux = (me * ce).sum(dim=-1).mean() * (E / k)
    return dispatch, combine, aux


def _routed(p: Params, x: torch.Tensor, dispatch: torch.Tensor,
            combine: torch.Tensor, split: bool = False, *,
            k: int) -> torch.Tensor:
    """sum over the (token, expert) pairs of ``dispatch`` of
    ``combine · expert(x)``, the expert a gated SiLU MLP in x's dtype;
    combine weights rounded to x's dtype, the sum in fp32, rounded once.
    x: (G, S, d). Returns (G, S, d).

    The reference's capacity-slot form over ``n = min(E_local, G·S·k)``
    expert slots, walked ``EXPERT_CHUNK`` at a time. Where ``n`` is the
    stack's own expert count the slots are its experts in order; else a
    table on the device lists the chosen experts first and each chunk
    gathers its experts' weights by it. A slot's unchosen expert has
    all-zero dispatch and combine columns and adds exactly zero. A
    token's output from an expert is read at the one capacity slot it
    holds there, not summed over every slot. No shape or trip count
    depends on the routing, so a CUDA graph holds the call.

    ``split``: ``p`` holds this rank's experts of a stack split over the
    model group: every one of them walked, and the fp32 sum reduced over
    the group before its rounding."""
    G, S, d = x.shape
    C = dispatch.shape[-1]
    dt = x.dtype
    n_local = (p["wi"].data if isinstance(p["wi"], PackedTensor)
               else p["wi"]).shape[0]
    lo = tp.rank() * n_local if split else 0
    n = n_local if split else min(n_local, G * S * k)
    # a token takes a slot of an expert at most once: its pair's weight
    # is the sum over the capacity slots
    cw = tp.copy_to_model(combine.sum(dim=-1), split)[:, :, lo:lo + n_local]
    x = tp.copy_to_model(x, split)
    disp = dispatch[:, :, lo:lo + n_local]
    if n == n_local:
        # views: the backward concatenates a float stack's chunk
        # gradients instead of filling a zero stack for each chunk
        def pick(t: torch.Tensor, dim: int):
            return torch.split(t, EXPERT_CHUNK, dim)
    else:
        chosen = disp.any(dim=-1).any(dim=1).any(dim=0)     # (E_local,)
        table = torch.argsort((~chosen).to(torch.uint8), stable=True)[:n]
        ids = torch.split(table, EXPERT_CHUNK)

        def pick(t: torch.Tensor, dim: int):
            return (t.index_select(dim, i) for i in ids)

    def weights(name: str):
        w = p[name]
        if not isinstance(w, PackedTensor):
            return pick(w.to(dt), 0)
        return (dequantize(PackedTensor(q, s, w.bits, w.orig_shape), dt)
                for q, s in zip(pick(w.data, 0), pick(w.scale, 0)))
    y = torch.zeros((G, S, d), dtype=torch.float32, device=x.device)
    for dc, wc, wi, wg, wo in zip(pick(disp, 2), pick(cw, 2),
                                  weights("wi"), weights("wg"),
                                  weights("wo")):
        m = dc.shape[2]
        xe = torch.einsum("gsnc,gsd->ngcd", dc.to(dt), x)
        h = F.silu(torch.einsum("ngcd,ndf->ngcf", xe, wg)) * torch.einsum(
            "ngcd,ndf->ngcf", xe, wi)
        ye = torch.einsum("ngcf,nfd->ngcd", h, wo)
        # each (token, expert) pair's row of ye: its slot there (0, at
        # zero weight, where the pair holds none)
        slot = dc.to(torch.uint8).argmax(dim=-1)                # (G, S, m)
        row = ((torch.arange(m, device=x.device) * G)[None, None, :]
               + torch.arange(G, device=x.device)[:, None, None]) * C + slot
        out = ye.reshape(m * G * C, d).index_select(0, row.reshape(-1))
        w = wc.to(dt).float() * dc.any(dim=-1)
        y = y + torch.einsum("gsn,gsnd->gsd", w,
                             out.reshape(G, S, m, d).float())
    return tp.reduce_from_model(y, split).to(dt)


def _routed_dense(p: Params, x: torch.Tensor, dispatch: torch.Tensor,
                  combine: torch.Tensor) -> torch.Tensor:
    """:func:`_routed` in the reference's capacity-padded einsum form:
    every expert runs its ``capacity`` slots of every group, filled or
    not, so no shape depends on the routing. The same sum, in other
    rounding; for fake tensors (the dry run's counter), whose routing
    cannot be read."""
    G, S, d = x.shape
    dt = x.dtype
    wi, wg, wo = (kernel_of(p[n], dt) for n in ("wi", "wg", "wo"))
    xe = torch.einsum("gsec,gsd->egcd", dispatch.to(dt), x)
    h = F.silu(torch.einsum("egcd,edf->egcf", xe, wg)) * torch.einsum(
        "egcd,edf->egcf", xe, wi)
    ye = torch.einsum("egcf,efd->egcd", h, wo)
    return torch.einsum("gsec,egcd->gsd", combine.to(dt).float(),
                        ye.float()).to(dt)


def moe_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
            capacity_factor: float = 1.25, decode: bool = False,
            pad_mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss); the batch dim is the GShard group.
    ``decode`` with S == 1 and B > 1 folds the batch into one group, so
    capacity is provisioned for B tokens, not per token. ``pad_mask``
    (B, S): False for pad tokens, which take no part in routing."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_tok
    if decode and S == 1 and B > 1:
        y, aux = moe_ffn(p, x.reshape(1, B, d), cfg,
                         capacity_factor=capacity_factor, decode=True,
                         pad_mask=None if pad_mask is None
                         else pad_mask.reshape(1, B))
        return y.reshape(B, S, d), aux
    capacity = max(int(math.ceil(S * k / E * capacity_factor)), 4)
    logits = dense(p["router"], x, cfg=cfg, tag="moe/router",
                   quantize=False).float()
    gates = torch.softmax(logits, dim=-1)
    dispatch, combine, aux = _top_k_dispatch(gates, k, capacity,
                                             mask=pad_mask)
    if is_fake(x):
        y = _routed_dense(p, x, dispatch, combine)
    else:
        y = _routed(p, x, dispatch, combine, split=tp.size() > 1 and (
            p["wi"].shape[-3] != E), k=k)
    if "shared" in p:
        y = y + mlp(p["shared"], x, cfg=cfg, tag="moe/shared",
                    d_ff=(cfg.moe_d_ff or cfg.d_ff) * cfg.n_shared_experts)
    return y, aux.float()
