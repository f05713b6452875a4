"""QABAS over-parameterised supernet with ProxylessNAS-style binarized
path sampling.

Every block holds weights for ALL candidate ops (weight sharing). A step
samples TWO candidate ops and TWO quant choices per block (ProxylessNAS
memory trick), computes only those paths, and mixes them with
renormalised architecture probabilities — gradients flow to the sampled
entries of alpha/beta through the mixture weights. ``blocks`` is a list
of dicts, one per block.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.qabas.space import SearchSpace
from repro_torch.core.quant.fake_quant import fake_quant
from repro_torch.models.basecaller.blocks import conv1d, truncated_normal_init

Params = Dict


def init_supernet(gen: torch.Generator, space: SearchSpace, *,
                  channels: int, n_bases: int = 5) -> Params:
    """fp32 CPU params drawn from ``gen``. As in the reference, every op
    of a block starts from the same pointwise weights."""
    C = channels
    blocks = []
    for _ in range(space.n_blocks):
        ops = {f"op{i}_k{k}": {"dw": truncated_normal_init(gen, (k, 1, C),
                                                           stddev=0.2)}
               for i, k in enumerate(space.kernel_options)}
        pw = truncated_normal_init(gen, (1, C, C))
        for op in ops.values():
            op["pw"] = pw.clone()
        ops["gamma"] = torch.ones(C)      # light norm per block
        blocks.append(ops)
    return {
        "stem": truncated_normal_init(gen, (9, 1, C), stddev=0.2),
        "blocks": blocks,
        "head": truncated_normal_init(gen, (1, C, n_bases)),
    }


def init_arch_params(space: SearchSpace) -> Params:
    return {"alpha": torch.zeros((space.n_blocks, space.n_ops)),
            "beta": torch.zeros((space.n_blocks, space.n_quant))}


def sample_paths(gen: torch.Generator, arch: Params, space: SearchSpace
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two ops + two quant choices per block, Gumbel top-2 by alpha /
    beta: (n_blocks, 2) int64 on arch's device each. The noise comes from
    ``gen`` (a CPU ``torch.Generator``): the same generator state gives
    the same draws; JAX's threefry draws cannot be matched."""
    def top2(logits):
        u = torch.empty(logits.shape).uniform_(
            torch.finfo(torch.float32).tiny, 1.0, generator=gen)
        g = -torch.log(-torch.log(u))
        return torch.argsort(-(logits.detach() + g.to(logits.device)),
                             dim=-1)[:, :2]
    return top2(arch["alpha"]), top2(arch["beta"])


def _apply_op(ops: Params, x: torch.Tensor, op_index: int, quant_bits,
              space: SearchSpace) -> torch.Tensor:
    """Candidate op ``op_index`` at ``quant_bits``; identity is the last
    op."""
    if op_index == len(space.kernel_options):
        return x
    C = x.shape[-1]
    wb, ab = quant_bits
    k = space.kernel_options[op_index]
    p = ops[f"op{op_index}_k{k}"]
    dw = fake_quant(p["dw"], wb, axis=2)
    pw = fake_quant(p["pw"], wb, axis=2)
    xx = fake_quant(x, ab)
    h = conv1d(xx, dw.to(xx.dtype), groups=C)
    h = conv1d(h, pw.to(xx.dtype))
    # parameter-free norm keeps supernet activations bounded
    h = h * torch.rsqrt(h.square().mean(dim=(1, 2), keepdim=True) + 1e-5)
    return torch.relu(h * ops["gamma"].to(xx.dtype))


def supernet_forward(params: Params, arch: Params, x: torch.Tensor,
                     op_idx: torch.Tensor, q_idx: torch.Tensor,
                     space: SearchSpace) -> torch.Tensor:
    """x: (B, S, 1) -> CTC log-probs. op_idx/q_idx: (n_blocks, 2)."""
    # sync: the sampled paths pick Python branches (the reference's
    # lax.switch), so they are read to the host once a call
    rows = torch.cat([op_idx, q_idx], dim=1).tolist()
    ops_h, qs_h = [r[:2] for r in rows], [r[2:] for r in rows]
    h = torch.relu(conv1d(x, params["stem"], stride=3))
    for b, ops in enumerate(params["blocks"]):
        # renormalised two-path mixture weights (differentiable wrt arch)
        w_a = torch.softmax(arch["alpha"][b, ops_h[b]], dim=-1)
        w_b = torch.softmax(arch["beta"][b, qs_h[b]], dim=-1)
        y = 0.0
        for ii in range(2):
            for jj in range(2):
                yq = _apply_op(ops, h, ops_h[b][ii],
                               space.quant_options[qs_h[b][jj]], space)
                y = y + w_a[ii] * w_b[jj] * yq
        h = y
    logits = conv1d(h, params["head"])
    return torch.log_softmax(logits.float(), dim=-1)
