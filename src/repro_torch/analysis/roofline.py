"""Roofline terms for one NVIDIA H100 card.

H100 SXM5 80GB at 700 W, from NVIDIA's H100 Tensor Core GPU data
sheet (dense figures, no sparsity):

- 3.35 TB/s HBM3 bandwidth;
- 989 TFLOP/s bf16 and 1979 TOP/s int8 on the tensor cores (int8 2x);
- 67 TFLOP/s fp32 on the CUDA cores;
- 80 GiB of HBM3 a card;
- NVLink 4: 900 GB/s a card, both directions together; collectives are
  charged at one direction's 450 GB/s.

All inputs are per-card quantities. ``hbm_bytes`` is the bytes a step
moves through HBM; the port has no HLO analyzer, so a caller counts
them itself.
"""
from __future__ import annotations

from typing import Dict

PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
HBM_PER_CARD = 80 * 1024 ** 3


def roofline_terms(hlo: Dict[str, float], *, int8_frac: float = 0.0
                   ) -> Dict[str, float]:
    """hlo: ``flops``, ``hbm_bytes`` and ``collective_bytes`` of one
    step. int8_frac: fraction of the dot flops on the int8 tensor-core
    path (quantized serving)."""
    flops = hlo["flops"]
    eff_peak = PEAK_BF16 * (1 - int8_frac) + PEAK_INT8 * int8_frac
    compute_s = flops / eff_peak
    memory_s = hlo["hbm_bytes"] / HBM_BW
    coll_s = hlo["collective_bytes"] / NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {
        **terms,
        "bottleneck": dom,
        "step_time_lower_bound_s": bound,
        "roofline_fraction": bound / total if total else 0.0,
    }


def model_flops(n_active_params: int, tokens: int, train: bool) -> float:
    """The 6ND / 2ND convention (fwd+bwd vs fwd-only)."""
    return (6.0 if train else 2.0) * n_active_params * tokens
