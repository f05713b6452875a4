"""Per-request generation parameters for the serving engine.

``SamplingParams`` is the per-request contract (vLLM-style): stopping
criteria (``max_new_tokens``, ``eos_id``) plus the sampler knobs.
``temperature == 0`` is exact greedy argmax. The sampler itself comes
with the LM serving slice; the engine needs only the record.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


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
