"""Per-request sampling for the serving engine: ``SamplingParams`` and
a vectorized on-device sampler (the port's counterpart of
``repro.serving.sampling``).

``SamplingParams`` is the per-request contract (vLLM-style): stopping
criteria (``max_new_tokens``, ``eos_id``) plus the sampler knobs.
``temperature == 0`` is exact greedy argmax (the first maximum, as in
the reference). A mixed greedy + sampled batch is one pass: the
per-slot knobs ride in as ``(B,)`` rows (:func:`pack_rows`) and
:func:`sample_tokens` selects per row.

Reproducibility: the Gumbel noise of a request's ``step``-th token at
vocabulary index ``v`` is a counter-based hash of ``(seed, rid, step,
v)`` in integer tensor ops, so it is a pure function of those four
numbers, drawn on the device in one pass with no per-row generator, and
independent of slot placement, batch composition, restarts and
preemption. (The reference keys JAX threefry with the same triple; the
two packages' sampled tokens differ, their contract is the same.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

NEG = -1e30

# host-side row record: (params, rid, step) — step is the index of the
# output token about to be sampled (== len(request.out_tokens))
Row = Tuple["SamplingParams", int, int]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation parameters.

    max_new_tokens : output budget; generation stops after this many.
    eos_id : optional stop token (generation ends when it is emitted).
    temperature : 0 = greedy argmax (the default); > 0 softens the
        distribution before sampling.
    top_k : keep only the k highest-probability tokens (0 = off).
    top_p : nucleus sampling threshold (1.0 = off).
    seed : per-request RNG seed.
    """

    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


def pack_rows(rows: Sequence[Optional[Row]]) -> Dict[str, np.ndarray]:
    """Per-slot ``(SamplingParams, rid, step)`` records -> the ``(B,)``
    rows :func:`sample_tokens` consumes; ``None`` (free/pad) slots pack
    as greedy."""
    n = len(rows)
    out = {
        "temperature": np.zeros((n,), np.float32),
        "top_k": np.zeros((n,), np.int32),
        "top_p": np.ones((n,), np.float32),
        "seed": np.zeros((n,), np.int32),
        "rid": np.zeros((n,), np.int32),
        "step": np.zeros((n,), np.int32),
    }
    for i, row in enumerate(rows):
        if row is None:
            continue
        p, rid, step = row
        out["temperature"][i] = p.temperature
        out["top_k"][i] = p.top_k
        out["top_p"][i] = p.top_p
        out["seed"][i] = p.seed
        out["rid"][i] = rid
        out["step"][i] = step
    return out


def any_sampled(rows: Sequence[Optional[Row]]) -> bool:
    """True if any live row samples (temperature > 0): pure-greedy ticks
    keep the plain argmax program."""
    return any(row is not None and row[0].temperature > 0 for row in rows)


_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer on int64 tensors holding values in
    [0, 2^32): its multiplier is below 2^27, so no product leaves int64."""
    x = ((x >> 16) ^ x) * 0x45D9F3B & _MASK32
    x = ((x >> 16) ^ x) * 0x45D9F3B & _MASK32
    return (x >> 16) ^ x


def gumbel_noise(seed: torch.Tensor, rid: torch.Tensor, step: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(B, vocab) fp32 standard Gumbel noise, a pure function of each
    row's ``(seed, rid, step)`` and the vocabulary index."""
    dev = seed.device
    key = _mix32(seed.long() & _MASK32)
    key = _mix32(key ^ (rid.long() & _MASK32))
    key = _mix32(key ^ (step.long() & _MASK32))                 # (B,)
    v = torch.arange(vocab, dtype=torch.int64, device=dev)
    h = _mix32(key[:, None] ^ _mix32(v)[None, :])               # (B, V)
    u = ((h >> 8).double() + 0.5) / float(1 << 24)              # (0, 1)
    return (-torch.log(-torch.log(u))).float()


def sample_tokens(logits: torch.Tensor, sp: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """One token per row. logits: (B, V); sp: packed (B,) rows on the
    logits' device. Greedy rows (temperature <= 0) return exact
    ``argmax(logits)``; sampled rows scale by temperature, intersect
    the top-k and top-p masks and take the Gumbel-max (a draw from the
    masked softmax). Returns (B,) int32."""
    logits = logits.float()
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temp = torch.clamp_min(sp["temperature"].float(), 1e-6)[:, None]
    scaled = logits / temp
    srt = torch.sort(scaled, dim=-1, descending=True).values
    # top-k: keep logits >= the k-th largest (k = V when off)
    k = torch.clamp(torch.where(sp["top_k"] > 0, sp["top_k"],
                                torch.full_like(sp["top_k"], V)), 1, V)
    kth = torch.gather(srt, 1, (k.long() - 1)[:, None])
    keep = scaled >= kth
    # top-p: the smallest sorted prefix whose probability reaches top_p
    probs = torch.softmax(srt, dim=-1)
    exclusive = torch.cumsum(probs, dim=-1) - probs
    nkeep = (exclusive < torch.clamp_max(sp["top_p"].float(), 1.0)[:, None]
             ).sum(dim=-1)
    pth = torch.gather(srt, 1, (torch.clamp_min(nkeep, 1) - 1)[:, None])
    keep &= scaled >= pth
    masked = torch.where(keep, scaled, torch.full_like(scaled, NEG))
    noise = gumbel_noise(sp["seed"], sp["rid"], sp["step"], V)
    sampled = torch.argmax(masked + noise, dim=-1).to(torch.int32)
    return torch.where(sp["temperature"] > 0, sampled, greedy)
