"""Shared building blocks of the LM family (the port's counterpart of
``repro.models.lm.common``).

Conventions: parameters are nested dicts of tensors; a layer group
stacks its blocks along a leading ``n_layers`` axis (indexed per layer
in a Python loop, where the reference scans); compute runs in
``cfg.dtype`` with norms in fp32. Matmuls go through :func:`dense`,
which applies the per-layer quantization policy: fake-quant for
unpacked weights, and for serving-time packed int8/int4 weights the
``qmatmul`` kernel when the config carries 4- or 8-bit weights for the
layer and the shapes meet the reference kernel's tiling contract.
Where the reference pins an activation on the ``model`` axis
(``constrain``), a training step over a model group splits the unit
instead (``parallel/tensor_parallel``): :func:`dense` takes column- or
row-parallel use from its caller, :func:`mlp` splits its hidden width
and :func:`cross_entropy` its vocabulary. Without a group every such
step is the identity.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.compat import is_fake
from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import PackedTensor, dequantize
from repro_torch.parallel import tensor_parallel as tp

Params = Dict[str, Any]


def truncated_normal_init(gen: torch.Generator, shape, stddev: float = 0.02,
                          dtype=torch.float32) -> torch.Tensor:
    """``stddev`` x a standard normal truncated to [-2, 2], drawn in fp32
    on the generator's device and returned in ``dtype``. A fake or meta
    tensor (shapes only, as ``api.count_params_analytic`` asks) is
    returned undrawn."""
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if w.is_meta or is_fake(w):
        return w.to(dtype)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(stddev).to(dtype)


def make_dense_params(gen: torch.Generator, d_in: int, d_out: int, *,
                      bias: bool = False, stddev: float = 0.02,
                      lead=(), dtype=torch.float32) -> Params:
    """``lead`` is the stacking prefix, e.g. ``(n_layers,)``."""
    p = {"kernel": truncated_normal_init(gen, (*lead, d_in, d_out), stddev,
                                         dtype)}
    if bias:
        p["bias"] = torch.zeros((*lead, d_out), dtype=dtype,
                                device=gen.device)
    return p


def kernel_of(p, dtype) -> torch.Tensor:
    """Weight leaf in ``dtype``, dequantizing a PackedTensor on read."""
    w = p["kernel"] if isinstance(p, dict) else p
    if isinstance(w, PackedTensor):
        return dequantize(w, dtype)
    return w.to(dtype)


def _qmatmul_tiles(m: int, k: int, n: int, bits: int) -> bool:
    """The reference kernel's tiling contract (``qmatmul_p``): every dim
    divides its ``min(128, dim)`` block, and int4 needs an even K. The
    port's kernel takes any shape; this gate keeps the routing of each
    projection the reference's."""
    ok = all(d > 0 and d % min(128, d) == 0 for d in (m, k, n))
    if bits == 4:
        ok = ok and k % 2 == 0 and min(128, k) % 2 == 0
    return ok


def dense(p: Params, x: torch.Tensor, *, cfg: ModelConfig, tag: str = "",
          quantize: bool = True, parallel: str = "") -> torch.Tensor:
    """Quantization-aware dense layer (``y = x @ W (+ b)``).

    A packed weight takes the ``qmatmul`` kernel when the config's
    policy gives the layer 4 or 8 weight bits and the tiling contract
    holds, and dequantizes on read otherwise. An unpacked weight under
    an enabled policy is fake-quantized with one scale per input row
    (``axis=0``, as the reference does) and, with activation bits,
    ``x`` per tensor (:func:`dense_operands`).

    ``parallel``: ``"col"`` where ``W`` holds this rank's columns of a
    unit split over the model group (``x`` whole), ``"row"`` where it
    holds this rank's rows (``x`` this rank's part): the row-parallel
    product is summed over the group before the bias is added, once;
    ``"partial"``: row-parallel, the product left unsummed for a caller
    that sums it with another (no bias)."""
    dt = getattr(torch, cfg.dtype)
    if parallel == "partial" and "bias" in p:
        raise ValueError(f"{tag}: a partial row-parallel product takes no "
                         f"bias (each rank would add it)")
    w = p["kernel"]
    if isinstance(w, PackedTensor):
        wb, _ = cfg.quant.bits_for(tag)
        m = x.numel() // x.shape[-1]
        if (wb in (4, 8) and w.data.ndim == 2
                and _qmatmul_tiles(m, x.shape[-1], w.data.shape[-1],
                                   w.bits)):
            from repro_torch.kernels.ops import qmatmul
            return _bias(p, tp.reduce_from_model(qmatmul(x.to(dt), w),
                                                 parallel == "row"), dt)
    x, w = dense_operands(p, x, cfg=cfg, tag=tag, quantize=quantize,
                          parallel=parallel)
    return _bias(p, tp.reduce_from_model(x @ w, parallel == "row"), dt)


def dense_operands(p: Params, x: torch.Tensor, *, cfg: ModelConfig,
                   tag: str = "", quantize: bool = True,
                   parallel: str = "") -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, W) in the compute dtype as :func:`dense` multiplies them
    without the kernel: a packed ``W`` dequantized, an unpacked one
    fake-quantized under an enabled policy, ``x`` too with activation
    bits. A fake-quant scale whose extent the model group splits takes
    the group's maximum: a column-parallel weight's per-row scale (and
    any split weight's per-tensor one), a row-parallel input's
    per-tensor scale."""
    dt = getattr(torch, cfg.dtype)
    w = p["kernel"]
    if isinstance(w, PackedTensor):
        return x.to(dt), kernel_of(p, dt)
    if quantize and cfg.quant.enabled:
        from repro_torch.core.quant.fake_quant import fake_quant
        from repro_torch.parallel import data_parallel
        wb, ab = cfg.quant.bits_for(tag)
        per_row = cfg.quant.per_channel
        row = parallel in ("row", "partial")
        if wb:
            split_scale = parallel == "col" or (parallel and not per_row)
            w = fake_quant(w, wb, axis=0 if per_row else None,
                           amax_reduce=tp.all_max_ if split_scale
                           else None)
        if ab:
            def amax(t):
                t = data_parallel.all_max_(t)
                return tp.all_max_(t) if row else t
            x = fake_quant(x, ab, axis=None, amax_reduce=amax)
    return x.to(dt), w.to(dt)


def _bias(p: Params, y: torch.Tensor, dt) -> torch.Tensor:
    return y + p["bias"].to(dt) if "bias" in p else y


# ---------------------------------------------------------------------------
# Norms and MLPs


def make_rmsnorm_params(d: int, *, lead=(), dtype=torch.float32,
                        device=None) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def make_layernorm_params(d: int, *, lead=(), dtype=torch.float32,
                          device=None) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 (the biased variance, as ``jnp.var``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


def make_mlp_params(gen: torch.Generator, d: int, ff: int, *,
                    gated: bool = True, lead=(),
                    dtype=torch.float32) -> Params:
    """A gated MLP (``wi``, ``wo``, ``wg``: the dense family's) or, with
    ``gated=False``, the two-matrix MLP of Whisper's blocks; drawn in the
    reference's order."""
    kw = dict(lead=lead, dtype=dtype)
    p = {"wi": make_dense_params(gen, d, ff, **kw),
         "wo": make_dense_params(gen, ff, d, **kw)}
    if gated:
        p["wg"] = make_dense_params(gen, d, ff, **kw)
    return p


def mlp(p: Params, x: torch.Tensor, *, cfg: ModelConfig, tag: str = "mlp",
        act: str = "silu", d_ff: int = 0) -> torch.Tensor:
    """Gated SiLU MLP ``(silu(x Wg) * (x Wi)) Wo`` when ``p`` has ``wg``;
    else ``act(x Wi) Wo``. ``act="gelu"`` is the tanh approximation, as
    ``jax.nn.gelu`` computes by default. Where ``p`` holds this rank's
    part of a hidden width of ``d_ff`` (default ``cfg.d_ff``) split over
    the model group, ``Wi``/``Wg`` are column- and ``Wo`` row-parallel
    (the reference's hidden pinned on ``model``)."""
    split = (tp.size() > 1
             and p["wi"]["kernel"].shape[-1] != (d_ff or cfg.d_ff))
    x = tp.copy_to_model(x, split)
    col, row = ("col", "row") if split else ("", "")
    h = dense(p["wi"], x, cfg=cfg, tag=tag + "/wi", parallel=col)
    if "wg" in p:
        g = dense(p["wg"], x, cfg=cfg, tag=tag + "/wg", parallel=col)
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh") if act == "gelu" else F.silu(h)
    return dense(p["wo"], h, cfg=cfg, tag=tag + "/wo", parallel=row)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1, vocab_size: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy in fp32 (logsumexp over the vocabulary). Labels
    equal to ``ignore_id`` weigh 0. Returns (sum of the losses, sum of
    the weights), so microbatches can be averaged.

    Vocabulary-parallel where ``logits`` are this rank's columns of a
    vocabulary of ``vocab_size`` split over the model group: the
    row maximum, the sum of exponentials and the picked logit are each
    reduced over the group (maximum, sum, sum; three fp32 values a
    token), and each rank's gradient stays on its own columns. Without
    a group the same formula is the local logsumexp."""
    lf = logits.float()
    n = lf.shape[-1]
    split = tp.size() > 1 and n != (vocab_size or n)
    m = lf.detach().amax(dim=-1, keepdim=True)
    if split:
        tp.all_max_(m)
    sumexp = tp.reduce_from_model((lf - m).exp().sum(dim=-1), split)
    lse = sumexp.log() + m[..., 0]
    # an ignored label still needs an index to gather from
    idx = torch.where(labels == ignore_id, 0, labels).long()
    if split:
        idx = idx - tp.rank() * n
        mine = (idx >= 0) & (idx < n)
        picked = torch.gather(lf, -1, torch.where(mine, idx, 0)[..., None])
        picked = tp.reduce_from_model(
            torch.where(mine, picked[..., 0], 0.0))
    else:
        picked = torch.gather(lf, -1, idx[..., None])[..., 0]
    w = (labels != ignore_id).float()
    return ((lse - picked) * w).sum(), w.sum()
