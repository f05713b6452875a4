"""QABAS-style search over SERVING knobs (not architecture ops).

The original QABAS loop searches per-block conv ops and weight/act
bit-widths against a latency model. This module applies the same
shape of search — enumerate a knob space, rank by a cheap analytic
prior, then score candidates by MEASUREMENT — to the serving engine's
deployment knobs:

- per-layer-group KV-cache quantization (``CacheQuantPolicy`` spec:
  bf16 | fp8 | int8, uniform or per-group overrides),
- paged-arena ``block_len``,
- decode-attention backend (``gather``, the logical-view reference, vs
  ``cuda``, the paged-attention kernels over the arena).

Each candidate serves a small deterministic greedy workload end-to-end
through :class:`repro_torch.serving.engine.ServingEngine` and is scored
by

    score = decode tok/s  /  total cache bytes (arena + scales + pos
                              + state — ``CachePool.nbytes()``)

i.e. measured throughput per byte of KV budget: the quantity that
decides how many concurrent requests a fixed HBM budget serves. The
roofline prior (``analysis.roofline``, the H100's table) orders
candidates before measurement so a ``budget`` cap measures the most
promising ones first; the emitted table reports both the measured score
and the prior.

``search_serving_knobs(..., per_group=True)`` adds a QABAS-flavoured
coordinate-descent refinement: starting from the best uniform cache
mode it flips one layer group's mode at a time (e.g. MoE groups to
int8, dense groups kept bf16) and keeps flips that improve the
measured score — layer-wise precision assignment without enumerating
the exponential per-group product space.

Every candidate runs on ``device`` (CUDA unless the caller asks for the
CPU). A ``cuda`` candidate launches the paged kernels, or raises if one
fails to build or launch: it is never measured on another path. On the
CPU it runs the kernels' plain versions.

Surfaced as ``python -m repro_torch.launch.serve --knob-search``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.roofline import roofline_terms
from repro_torch.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ServingKnobs:
    """One point in the serving-knob space."""
    quant_policy: str = "bf16"      # CacheQuantPolicy spec string
    block_len: int = 16
    attn_backend: str = "gather"

    def label(self) -> str:
        return (f"cache={self.quant_policy};bl={self.block_len};"
                f"attn={self.attn_backend}")


@dataclasses.dataclass
class KnobResult:
    knobs: ServingKnobs
    resolved_policy: str            # the pool's policy, described
    decode_tok_s: float
    cache_bytes: int                # CachePool.nbytes(): ALL leaves
    bytes_by_class: Dict[str, int]
    score: float                    # decode_tok_s / cache_bytes
    prior_score: float              # roofline-prior tok/s-per-byte
    bytes_vs_bf16: float            # arena compression ratio (>= 1)
    tokens_match_bf16: Optional[bool]
    _tokens: Optional[Dict[int, List[int]]] = dataclasses.field(
        default=None, repr=False)   # greedy outputs, for parity columns


DEFAULT_CACHE_MODES: Tuple[str, ...] = ("bf16", "fp8", "int8")


def enumerate_knobs(modes: Sequence[str] = DEFAULT_CACHE_MODES,
                    block_lens: Sequence[int] = (8, 16),
                    backends: Sequence[str] = ("gather",)
                    ) -> List[ServingKnobs]:
    """The uniform-mode grid (per-group refinement is a second,
    measured pass — see ``search_serving_knobs``)."""
    return [ServingKnobs(quant_policy=m, block_len=bl, attn_backend=be)
            for m in modes for bl in block_lens for be in backends]


# ---------------------------------------------------------------------------
# Roofline prior


def knob_prior(cfg: ModelConfig, knobs: ServingKnobs, *,
               param_bytes: int, cache_bytes: int, n_slots: int) -> float:
    """Analytic tok/s-per-cache-byte prior for ranking, from the
    roofline model: one decode tick reads every live weight byte plus
    (roughly) the full cache arena, at 2 flops per weight element.
    Absolute numbers are irrelevant — only the ORDER matters, and the
    order is driven by the cache-byte denominator plus the int8
    tensor-core credit for a quantized arena."""
    n_params = max(param_bytes // 2, 1)          # bf16-equivalent elems
    int8_frac = 1.0 if "int8" in knobs.quant_policy else 0.0
    hlo = {"flops": 2.0 * n_params * n_slots,
           "hbm_bytes": float(param_bytes + cache_bytes),
           "collective_bytes": 0.0}
    terms = roofline_terms(hlo, int8_frac=int8_frac)
    step_s = max(terms["step_time_lower_bound_s"], 1e-12)
    return (n_slots / step_s) / max(cache_bytes, 1)


# ---------------------------------------------------------------------------
# Measurement


def _workload(cfg: ModelConfig, n_reqs: int, prompt_len: int,
              max_tokens: int, seed: int = 0) -> List[List[int]]:
    rs = np.random.RandomState(seed)
    return [rs.randint(1, cfg.vocab_size, size=prompt_len).tolist()
            for _ in range(n_reqs)]


def _drain(engine, prompts, max_tokens) -> Dict[int, List[int]]:
    """One full workload drain through a (possibly warm) engine; fresh
    Request objects each pass, metrics reset so the pass reports
    itself."""
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import SamplingParams
    engine.reset_stats()
    for i, prompt in enumerate(prompts):
        engine.submit(Request(
            rid=i, prompt=prompt,
            sampling=SamplingParams(max_new_tokens=max_tokens)))
    done = engine.run()
    return {i: list(r.out_tokens) for i, r in done.items()}


def measure_knobs(params, cfg: ModelConfig, knobs: ServingKnobs, *,
                  n_slots: int = 4, cache_len: int = 48,
                  prompt_len: int = 16, max_tokens: int = 24,
                  oversub: int = 2, prefill_chunk: int = 8,
                  repeats: int = 2,
                  baseline: Optional[KnobResult] = None,
                  device=None) -> KnobResult:
    """Serve one deterministic greedy workload under ``knobs`` on
    ``device`` and score it. ``baseline`` (the bf16 row) supplies the
    compression ratio and the cross-knob token-parity column."""
    from repro_torch.models import api

    engine = api.make_serving_engine(params, cfg, device=device,
                                     n_slots=n_slots, cache_len=cache_len,
                                     prefill_chunk=prefill_chunk,
                                     cache_dtype=getattr(torch, cfg.dtype),
                                     quant_policy=knobs.quant_policy,
                                     block_len=knobs.block_len,
                                     attn_backend=knobs.attn_backend)
    pool = engine.runner.pool
    if pool is None:
        raise ValueError(
            f"serving-knob search needs a paged KV pool; "
            f"{cfg.name} ({cfg.family}) serves without one")
    prompts = _workload(cfg, n_slots * oversub, prompt_len, max_tokens)
    _drain(engine, prompts, max_tokens)          # warm pass
    best_tps, tokens = 0.0, None
    for _ in range(repeats):
        tokens = _drain(engine, prompts, max_tokens)
        tps = engine.metrics.summary()["decode_tokens_per_s"]
        best_tps = max(best_tps, tps)
    by_class = pool.nbytes_by_class()
    total = pool.nbytes()
    prior = knob_prior(cfg, knobs, param_bytes=_param_bytes(params),
                       cache_bytes=total, n_slots=n_slots)
    res = KnobResult(knobs=knobs,
                     resolved_policy=pool.quant_policy.describe(),
                     decode_tok_s=best_tps, cache_bytes=total,
                     bytes_by_class=by_class,
                     score=best_tps / max(total, 1), prior_score=prior,
                     bytes_vs_bf16=(baseline.cache_bytes / total
                                    if baseline else 1.0),
                     tokens_match_bf16=(tokens == baseline._tokens
                                        if baseline else None))
    res._tokens = tokens
    return res


def _param_bytes(params) -> int:
    from repro_torch.core.quant.policy import tree_size_bytes
    return tree_size_bytes(params)


# ---------------------------------------------------------------------------
# Search loop


def search_serving_knobs(params, cfg: ModelConfig, *,
                         modes: Sequence[str] = DEFAULT_CACHE_MODES,
                         block_lens: Sequence[int] = (8, 16),
                         backends: Sequence[str] = ("gather",),
                         n_slots: int = 4, cache_len: int = 48,
                         prompt_len: int = 16, max_tokens: int = 24,
                         per_group: bool = False,
                         budget: Optional[int] = None,
                         emit=None, device=None) -> List[KnobResult]:
    """Measure the knob grid on ``device`` and return results ranked by
    measured tok/s-per-cache-byte (best first). ``budget`` caps how many
    candidates are measured, taken in roofline-prior order (the bf16
    baseline row is always measured). ``per_group=True`` runs the
    coordinate-descent per-group precision refinement from the best
    uniform candidate."""
    from repro_torch.models.lm import transformer as tfm

    say = emit if emit is not None else (lambda s: None)
    mkw = dict(n_slots=n_slots, cache_len=cache_len,
               prompt_len=prompt_len, max_tokens=max_tokens, device=device)

    base_knobs = ServingKnobs(quant_policy="bf16",
                              block_len=block_lens[0] if block_lens else 16,
                              attn_backend=(backends[0] if backends
                                            else "gather"))
    baseline = measure_knobs(params, cfg, base_knobs, **mkw)
    baseline.bytes_vs_bf16 = 1.0
    baseline.tokens_match_bf16 = True
    say(f"[knobs] baseline {base_knobs.label()}: "
        f"{baseline.decode_tok_s:.1f} tok/s, "
        f"{baseline.cache_bytes/2**20:.2f} MiB cache")

    cands = [k for k in enumerate_knobs(modes, block_lens, backends)
             if k != base_knobs]
    # rank by the analytic prior before paying for measurement
    pb = _param_bytes(params)
    est = {k: knob_prior(cfg, k, param_bytes=pb,
                         cache_bytes=_est_cache_bytes(baseline, k),
                         n_slots=n_slots) for k in cands}
    cands.sort(key=lambda k: -est[k])
    if budget is not None:
        dropped = cands[max(budget - 1, 0):]
        if dropped:
            say(f"[knobs] budget {budget}: skipping "
                f"{len(dropped)} low-prior candidates "
                f"({', '.join(k.label() for k in dropped[:4])}"
                f"{', ...' if len(dropped) > 4 else ''})")
        cands = cands[:max(budget - 1, 0)]

    results = [baseline]
    for k in cands:
        r = measure_knobs(params, cfg, k, baseline=baseline, **mkw)
        say(f"[knobs] {k.label()}: {r.decode_tok_s:.1f} tok/s, "
            f"{r.cache_bytes/2**20:.2f} MiB "
            f"({r.bytes_vs_bf16:.2f}x smaller), "
            f"parity={'ok' if r.tokens_match_bf16 else 'diff'}")
        results.append(r)

    if per_group:
        results += _refine_per_group(params, cfg, results, tfm,
                                     baseline, say, mkw)

    results.sort(key=lambda r: -r.score)
    return results


def _est_cache_bytes(baseline: KnobResult, knobs: ServingKnobs) -> int:
    """Prior-only cache-byte estimate scaled off the measured bf16 row
    (arena shrinks by itemsize; pos/state/scale overheads ignored —
    good enough to ORDER candidates)."""
    arena = baseline.bytes_by_class.get("arena", baseline.cache_bytes)
    rest = baseline.cache_bytes - arena
    shrink = {"bf16": 1.0, "fp16": 1.0, "fp32": 0.5,
              "fp8": 2.0, "int8": 2.0}.get(knobs.quant_policy, 1.0)
    return int(arena / shrink) + rest


def _refine_per_group(params, cfg, results, tfm, baseline, say, mkw
                      ) -> List[KnobResult]:
    """Coordinate descent over per-group cache modes from the best
    uniform candidate: flip one group at a time, keep improvements."""
    best = max(results, key=lambda r: r.score)
    groups = [g for g, _, _ in tfm.group_names(cfg)]
    cur_mode = best.knobs.quant_policy
    assign = {g: cur_mode for g in groups}
    cur = best
    extra: List[KnobResult] = []
    for g in groups:
        for m in DEFAULT_CACHE_MODES:
            if m == assign[g]:
                continue
            trial = dict(assign)
            trial[g] = m
            spec = "default=" + cur_mode + "," + ",".join(
                f"{gg}={mm}" for gg, mm in trial.items()
                if mm != cur_mode)
            spec = spec.rstrip(",")
            k = dataclasses.replace(best.knobs, quant_policy=spec)
            r = measure_knobs(params, cfg, k, baseline=baseline, **mkw)
            extra.append(r)
            say(f"[knobs] refine {g}->{m}: score "
                f"{r.score:.3e} vs {cur.score:.3e}")
            if r.score > cur.score:
                assign, cur = trial, r
    return extra


def format_knob_table(results: Sequence[KnobResult]) -> str:
    """Ranked, human-readable table (best measured score first)."""
    lines = [f"{'rank':>4}  {'cache policy':<28} {'bl':>3} {'attn':>6} "
             f"{'tok/s':>8} {'cache MiB':>9} {'vs bf16':>7} "
             f"{'tok/s/MiB':>9} {'parity':>6}"]
    for i, r in enumerate(results):
        par = ("-" if r.tokens_match_bf16 is None
               else "ok" if r.tokens_match_bf16 else "diff")
        lines.append(
            f"{i + 1:>4}  {r.knobs.quant_policy:<28} "
            f"{r.knobs.block_len:>3} {r.knobs.attn_backend:>6} "
            f"{r.decode_tok_s:>8.1f} {r.cache_bytes / 2**20:>9.2f} "
            f"{r.bytes_vs_bf16:>6.2f}x "
            f"{r.score * 2**20:>9.1f} {par:>6}")
    return "\n".join(lines)
