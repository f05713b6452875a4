"""Quantized 1-D conv blocks — the RUBICALL/Bonito building material.

Block = R repeats of [grouped (depthwise) conv -> pointwise conv -> BN ->
quantized ReLU], with an optional skip branch (pointwise projection of
the block input, added before the last activation — QuartzNet/Bonito
style), gated by a per-block ``skip_gate`` in [0, 1] (SkipClip).

Layouts follow the JAX package so weights bridge one to one:
activations are NWC ``(B, S, C)``, conv weights ``(K, Cin/groups,
Cout)``. In eval mode a stride-1 square block whose weights are packed
int8 runs the fused ``qconv1d`` kernel; every other conv runs
``F.conv1d``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.compat import is_fake
from repro_torch.config import ModelConfig
from repro_torch.core.quant.fake_quant import fake_quant
from repro_torch.core.quant.policy import PackedTensor, dequantize
from repro_torch.parallel import data_parallel

Params = Dict[str, Any]
State = Dict[str, Any]


def truncated_normal_init(gen: torch.Generator, shape, stddev=0.02
                          ) -> torch.Tensor:
    """``stddev`` x a standard normal truncated to [-2, 2] (fp32, CPU).
    A fake or meta tensor (shapes only) is returned undrawn."""
    w = torch.empty(shape, dtype=torch.float32)
    if w.is_meta or is_fake(w):
        return w
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return stddev * w


def conv_kernel_of(w, dtype) -> torch.Tensor:
    """Conv weight leaf -> its ``(K, Cg, Cout)`` tensor, dequantizing
    serving-time :class:`PackedTensor` storage on read (``orig_shape``
    keeps the conv layout)."""
    if isinstance(w, PackedTensor):
        return dequantize(w, dtype).reshape(w.orig_shape)
    return w.to(dtype)


def _maybe_quant(w, x, cfg: ModelConfig, tag: str):
    if cfg.quant.enabled:
        wb, ab = cfg.quant.bits_for(tag)
        if wb:
            w = fake_quant(w, wb, axis=w.ndim - 1)
        if ab:
            x = fake_quant(x, ab, axis=None,
                           amax_reduce=data_parallel.all_max_)
    return w, x


def _act_quant(h, cfg: ModelConfig, tag: str):
    if cfg.quant.enabled:
        _, ab = cfg.quant.bits_for(tag + "/act")
        if ab:
            h = fake_quant(h, ab, amax_reduce=data_parallel.all_max_)
    return h


def conv1d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           groups: int = 1, dilation: int = 1,
           causal: bool = False) -> torch.Tensor:
    """x: (B, S, Cin); w: (K, Cin//groups, Cout). Non-causal convs pad
    ``total//2`` on the left and the rest on the right (explicit pad:
    ``F.conv1d``'s symmetric ``padding`` differs for even totals)."""
    K = w.shape[0]
    total = dilation * (K - 1)
    left = total if causal else total // 2
    xc = F.pad(x.transpose(1, 2), (left, total - left))
    y = F.conv1d(xc, w.permute(2, 1, 0), stride=stride, dilation=dilation,
                 groups=groups)
    return y.transpose(1, 2)


def make_bn_params(c: int) -> Params:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def make_bn_state(c: int) -> State:
    return {"mean": torch.zeros(c), "var": torch.ones(c)}


def batchnorm(p: Params, s: State, x: torch.Tensor, *, train: bool,
              momentum: float = 0.9) -> Tuple[torch.Tensor, State]:
    """Biased batch variance; running stats ``0.9*old + 0.1*new``. The
    statistics are the sum over (batch, time), then the sum of squares
    about the mean, each over n values: in a data-parallel step
    (``parallel/data_parallel.batch_stats_over``) both sums and n are
    the global batch's, summed over the data group; alone, the local
    batch's."""
    xf = x.float()
    if train:
        n = xf.shape[0] * xf.shape[1] * data_parallel.group_size()
        mean = data_parallel.all_sum(xf.sum(dim=(0, 1))) / n
        var = data_parallel.all_sum(((xf - mean) ** 2).sum(dim=(0, 1))) / n
        new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mean,
                 "var": momentum * s["var"] + (1 - momentum) * var}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    y = (xf - mean) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    return y.to(x.dtype), new_s


def make_sep_conv_params(gen: torch.Generator, c_in: int, c_out: int,
                         k: int) -> Params:
    return {
        "dw": truncated_normal_init(gen, (k, 1, c_in), stddev=0.2),
        "pw": truncated_normal_init(gen, (1, c_in, c_out)),
        "bn": make_bn_params(c_out),
    }


def make_conv_params(gen: torch.Generator, k: int, c_in: int,
                     c_out: int) -> torch.Tensor:
    """Plain (non-separable) ``(K, Cin, Cout)`` conv kernel — the
    basecaller blocks themselves are depthwise-separable (see
    :func:`make_sep_conv_params`); the read-until classifier head uses
    full convs because its channel counts are tiny."""
    return truncated_normal_init(gen, (k, c_in, c_out), stddev=0.2)


def sep_conv_state(c_out: int) -> State:
    return {"bn": make_bn_state(c_out)}


def sep_conv(p: Params, s: State, x: torch.Tensor, cfg: ModelConfig,
             tag: str, *, stride: int = 1, dilation: int = 1,
             causal: bool = False, train: bool = True, relu: bool = True
             ) -> Tuple[torch.Tensor, State]:
    c_in = x.shape[-1]
    dw_p, pw_p = p["dw"], p["pw"]
    if (isinstance(dw_p, PackedTensor) and isinstance(pw_p, PackedTensor)
            and not train and stride == 1 and dilation == 1 and not causal
            and dw_p.bits == 8 and pw_p.bits == 8
            and pw_p.orig_shape[-2] == pw_p.orig_shape[-1]
            and cfg.quant.bits_for(tag + "/pw")[0] in (4, 8)):
        # Fused route (the config carries QABAS bit-widths for this
        # layer and both weights serve packed): depthwise -> pointwise
        # -> folded-BN -> ReLU in one kernel over the int8 bytes.
        # Eval-mode only — BN folds its running stats into the
        # per-channel scale/shift, so state passes through unchanged.
        from repro_torch.kernels import ops
        rs = s["bn"]
        g = p["bn"]["scale"] * torch.rsqrt(rs["var"] + 1e-5)
        b = p["bn"]["bias"] - rs["mean"] * g
        h = ops.qconv1d_block(x, dw_p, pw_p, g, b, relu=relu)
        if relu:
            h = _act_quant(h, cfg, tag)
        return h, {"bn": rs}
    dw = conv_kernel_of(dw_p, x.dtype)
    if isinstance(dw_p, PackedTensor):
        xq = x          # storage is already quantized — no fake-quant
    else:
        dw, xq = _maybe_quant(dw, x, cfg, tag + "/dw")
    h = conv1d(xq, dw, stride=stride, groups=c_in, dilation=dilation,
               causal=causal)
    pw = conv_kernel_of(pw_p, x.dtype)
    if isinstance(pw_p, PackedTensor):
        hq = h
    else:
        pw, hq = _maybe_quant(pw, h, cfg, tag + "/pw")
    h = conv1d(hq, pw)
    h, bn_s = batchnorm(p["bn"], s["bn"], h, train=train)
    if relu:
        h = _act_quant(torch.relu(h), cfg, tag)
    return h, {"bn": bn_s}


def make_block_params(gen: torch.Generator, cfg: ModelConfig, i: int,
                      c_in: int) -> Params:
    """Block i of the config's channels/kernel_sizes/repeats tables."""
    c_out = cfg.channels[i]
    k = cfg.kernel_sizes[i]
    p: Params = {f"rep{j}": make_sep_conv_params(
        gen, c_in if j == 0 else c_out, c_out, k)
        for j in range(cfg.repeats[i])}
    if cfg.use_skips:
        p["skip_pw"] = truncated_normal_init(gen, (1, c_in, c_out))
        p["skip_bn"] = make_bn_params(c_out)
    return p


def block_state(cfg: ModelConfig, i: int) -> State:
    c_out = cfg.channels[i]
    s: State = {f"rep{j}": sep_conv_state(c_out)
                for j in range(cfg.repeats[i])}
    if cfg.use_skips:
        s["skip_bn"] = make_bn_state(c_out)
    return s


def _mask_outside(h: torch.Tensor, bounds, s: int) -> torch.Tensor:
    """Zero positions outside the read (chunked serving).

    ``bounds = (start, read_len)`` are scalars — or ``(B,)`` tensors
    when the serving runner batches every slot's window into one
    forward; each row then masks against its own read edges (rows with
    ``read_len == 0`` mask everything: idle slots). Position ``i`` at
    cumulative stride ``s`` anchors global sample ``start + i*s``; the
    whole-read forward's convs zero-pad beyond the read, and masking
    the window's halo the same way keeps chunked == whole-read.
    """
    if bounds is None:
        return h
    start, read_len = (torch.as_tensor(v, device=h.device) for v in bounds)
    idx = torch.arange(h.shape[1], device=h.device, dtype=torch.int32) * s
    if start.ndim == 1:                 # per-row bounds (batched serving)
        gpos = start[:, None] + idx[None, :]
        ok = (gpos >= 0) & (gpos < read_len[:, None])
        return h * ok[:, :, None].to(h.dtype)
    gpos = start + idx
    ok = (gpos >= 0) & (gpos < read_len)
    return h * ok[None, :, None].to(h.dtype)


def block_forward(p: Params, s: State, x: torch.Tensor, cfg: ModelConfig,
                  i: int, *, train: bool = True,
                  skip_gate: Optional[torch.Tensor] = None,
                  dilation: int = 1, causal: bool = False,
                  bounds=None, s_in: int = 1
                  ) -> Tuple[torch.Tensor, State]:
    reps = cfg.repeats[i]
    stride = cfg.strides[i]
    tag = f"block{i:02d}"
    new_s: State = {}
    h = x
    for j in range(reps):
        # each grouped (K > 1) conv must see zeros beyond the read edge;
        # the positionwise ops in between cannot smear out-of-read
        # values inward, so masking the repeat inputs is sufficient
        h = _mask_outside(h, bounds, s_in if j == 0 else s_in * stride)
        h, ns = sep_conv(p[f"rep{j}"], s[f"rep{j}"], h, cfg, f"{tag}/rep{j}",
                         stride=stride if j == 0 else 1,
                         dilation=dilation, causal=causal,
                         train=train, relu=j != reps - 1)
        new_s[f"rep{j}"] = ns
    if cfg.use_skips and "skip_pw" in p:
        gate = 1.0 if skip_gate is None else skip_gate
        sk = conv1d(x, conv_kernel_of(p["skip_pw"], x.dtype))
        if stride > 1:
            sk = sk[:, ::stride]
        sk, bn_s = batchnorm(p["skip_bn"], s["skip_bn"], sk, train=train)
        new_s["skip_bn"] = bn_s
        h = h + gate * sk
    return _act_quant(torch.relu(h), cfg, tag), new_s
