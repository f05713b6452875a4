"""Synthetic LM token stream (the port's counterpart of
``repro.data.tokens``): a fixed-transition Markov walk over a
vocab-sized ring, so the loss has structure to learn, with
deterministic seeding and shift-by-one labels. The draws are the
reference's, ``np.random.RandomState`` call for call, so one seed gives
the same tokens and labels in both packages. Batches are numpy arrays;
the training loop moves them to the device."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.config import ModelConfig


def token_batches(cfg: ModelConfig, batch: int, seq: int,
                  seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless ``{"tokens", "labels"}`` batches, (batch, seq) int32; a
    vlm batch adds ``patch_embeds`` and an audio batch ``frames``,
    (batch, frontend_tokens, d_model) fp32 standard normal stubs drawn
    after the tokens from the same stream."""
    rng = np.random.RandomState(seed)
    V = cfg.vocab_size
    jumps = rng.randint(1, 17, size=64)
    while True:
        start = rng.randint(0, V, size=(batch, 1))
        steps = jumps[rng.randint(0, 64, size=(batch, seq))]
        toks = (start + np.cumsum(steps, axis=1) - steps) % V
        labels = (toks + steps) % V
        out = {"tokens": toks.astype(np.int32),
               "labels": labels.astype(np.int32)}
        if cfg.family in ("vlm", "audio"):
            name = "patch_embeds" if cfg.family == "vlm" else "frames"
            out[name] = rng.randn(batch, cfg.frontend_tokens,
                                  cfg.d_model).astype(np.float32)
        yield out
