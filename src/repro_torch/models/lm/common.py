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
There is no device mesh, so the reference's sharding constraints have
no counterpart here.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import PackedTensor, dequantize

Params = Dict[str, Any]


def truncated_normal_init(gen: torch.Generator, shape, stddev: float = 0.02,
                          dtype=torch.float32) -> torch.Tensor:
    """``stddev`` x a standard normal truncated to [-2, 2], drawn in fp32
    on the generator's device and returned in ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
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
          quantize: bool = True) -> torch.Tensor:
    """Quantization-aware dense layer (``y = x @ W (+ b)``).

    A packed weight takes the ``qmatmul`` kernel when the config's
    policy gives the layer 4 or 8 weight bits and the tiling contract
    holds, and dequantizes on read otherwise. An unpacked weight under
    an enabled policy is fake-quantized with one scale per input row
    (``axis=0``, as the reference does) and, with activation bits,
    ``x`` per tensor."""
    dt = getattr(torch, cfg.dtype)
    w = p["kernel"]
    if isinstance(w, PackedTensor):
        wb, _ = cfg.quant.bits_for(tag)
        m = x.numel() // x.shape[-1]
        if (wb in (4, 8) and w.data.ndim == 2
                and _qmatmul_tiles(m, x.shape[-1], w.data.shape[-1],
                                   w.bits)):
            from repro_torch.kernels.ops import qmatmul
            y = qmatmul(x.to(dt), w)
            if "bias" in p:
                y = y + p["bias"].to(dt)
            return y
        w = kernel_of(p, dt)
    else:
        if quantize and cfg.quant.enabled:
            from repro_torch.core.quant.fake_quant import fake_quant
            wb, ab = cfg.quant.bits_for(tag)
            if wb:
                w = fake_quant(w, wb,
                               axis=0 if cfg.quant.per_channel else None)
            if ab:
                x = fake_quant(x, ab, axis=None)
        w = w.to(dt)
    y = x.to(dt) @ w
    if "bias" in p:
        y = y + p["bias"].to(dt)
    return y


# ---------------------------------------------------------------------------
# Norms and MLP


def make_rmsnorm_params(d: int, *, lead=(), dtype=torch.float32,
                        device=None) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def make_mlp_params(gen: torch.Generator, d: int, ff: int, *, lead=(),
                    dtype=torch.float32) -> Params:
    """Gated MLP (the dense family's); drawn in the reference's order."""
    return {"wi": make_dense_params(gen, d, ff, lead=lead, dtype=dtype),
            "wo": make_dense_params(gen, ff, d, lead=lead, dtype=dtype),
            "wg": make_dense_params(gen, d, ff, lead=lead, dtype=dtype)}


def mlp(p: Params, x: torch.Tensor, *, cfg: ModelConfig,
        tag: str = "mlp") -> torch.Tensor:
    """Gated SiLU MLP: ``(silu(x Wg) * (x Wi)) Wo``."""
    h = dense(p["wi"], x, cfg=cfg, tag=tag + "/wi")
    g = dense(p["wg"], x, cfg=cfg, tag=tag + "/wg")
    return dense(p["wo"], F.silu(g) * h, cfg=cfg, tag=tag + "/wo")
