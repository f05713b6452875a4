"""Synthetic nanopore squiggle simulator (pore-model based).

No ONT reads are available offline, so we generate training data the way
pore simulators (DeepSimulator/squigulator) do:

1. Random DNA sequence over {A,C,G,T}.
2. 6-mer -> mean current lookup (deterministic pseudo-random pore table,
   seeded — stands in for the ONT R9.4.1 k-mer model).
3. Per-base dwell times ~ 1 + Poisson(lambda-1) samples (sequencer speed
   jitter).
4. Gaussian noise + slow drift; med/MAD normalisation (same normalisation
   Bonito applies to chunks).

Labels are CTC targets (1..4 for A,C,G,T; 0 = blank reserved).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

K = 6
BASES = "ACGT"


@dataclasses.dataclass
class SquiggleConfig:
    chunk_len: int = 2048          # signal samples per training chunk
    mean_dwell: float = 9.0        # samples per base (R9.4 ~ 8-10)
    noise: float = 0.18
    drift: float = 0.01
    seed: int = 1234
    k: int = K                     # pore-model context order (R9.4: 6-mer)
    dwell_jitter: bool = True      # Poisson dwell variation

    @property
    def max_bases(self) -> int:
        # conservative label-capacity bound per chunk
        return int(self.chunk_len / (self.mean_dwell * 0.5))


def pore_table(seed: int = 7, k: int = K) -> np.ndarray:
    """Deterministic k-mer -> mean current map, standard-normal scaled."""
    rng = np.random.RandomState(seed)
    return rng.randn(4 ** k).astype(np.float32)


def _kmer_index(seq: np.ndarray, k: int = K) -> np.ndarray:
    """seq: (L,) in 0..3 -> (L-k+1,) k-mer indices."""
    idx = np.zeros(len(seq) - k + 1, np.int64)
    for i in range(k):
        idx = idx * 4 + seq[i:len(seq) - k + 1 + i]
    return idx


def simulate_read(rng: np.random.RandomState, cfg: SquiggleConfig,
                  table: np.ndarray, n_bases: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (signal (~n_bases*dwell,), bases (n_bases,)) unnormalised."""
    k = cfg.k
    seq = rng.randint(0, 4, n_bases + k - 1)
    levels = table[_kmer_index(seq, k)]
    if cfg.dwell_jitter:
        dwell = 1 + rng.poisson(cfg.mean_dwell - 1, len(levels))
    else:
        dwell = np.full(len(levels), int(cfg.mean_dwell), np.int64)
    sig = np.repeat(levels, dwell)
    sig = sig + cfg.noise * rng.randn(len(sig)).astype(np.float32)
    sig = sig + cfg.drift * np.cumsum(rng.randn(len(sig))).astype(np.float32) \
        / np.sqrt(max(len(sig), 1))
    return sig.astype(np.float32), seq[k // 2: k // 2 + n_bases]


def normalize(sig: np.ndarray) -> np.ndarray:
    med = np.median(sig)
    mad = np.median(np.abs(sig - med)) + 1e-6
    return ((sig - med) / (1.4826 * mad)).astype(np.float32)


def make_batch(rng: np.random.RandomState, cfg: SquiggleConfig,
               table: np.ndarray, batch: int) -> Dict[str, np.ndarray]:
    """Fixed-shape training batch: signal (B, chunk, 1), labels (B, Lmax),
    label_lengths (B,)."""
    Lmax = cfg.max_bases
    signal = np.zeros((batch, cfg.chunk_len, 1), np.float32)
    labels = np.zeros((batch, Lmax), np.int32)
    lengths = np.zeros((batch,), np.int32)
    for b in range(batch):
        n_bases = int(cfg.chunk_len / cfg.mean_dwell * 0.9)
        sig, seq = simulate_read(rng, cfg, table, n_bases)
        sig = normalize(sig)[: cfg.chunk_len]
        signal[b, : len(sig), 0] = sig
        # bases actually covered by the truncated signal window
        covered = min(n_bases, int(len(sig) / cfg.mean_dwell))
        covered = min(covered, Lmax)
        labels[b, :covered] = seq[:covered] + 1      # 1..4 (0 = blank)
        lengths[b] = covered
    return {"signal": signal, "labels": labels, "label_lengths": lengths}


def batches(cfg: SquiggleConfig, batch: int) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.RandomState(cfg.seed)
    table = pore_table(k=cfg.k)
    while True:
        yield make_batch(rng, cfg, table, batch)
