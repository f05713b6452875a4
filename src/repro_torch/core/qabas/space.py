"""QABAS search space (paper §Methods).

Per block: a grouped 1-D conv op with one of ten kernel sizes, or the
identity op (removes the layer); jointly, a <weight, activation> bit-width
pair for the block's layers. Channel options x repeats span the depth/width
grid. The full space must enumerate to the paper's ~1.8e32 options; the
quantization dimension alone contributes the paper's ~6.72e20 factor.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

KERNEL_OPTIONS: Tuple[int, ...] = (3, 5, 7, 9, 25, 31, 55, 75, 115, 123)
QUANT_OPTIONS: Tuple[Tuple[int, int], ...] = ((8, 4), (8, 8), (16, 8),
                                              (16, 16))
CHANNEL_OPTIONS: Tuple[int, ...] = (128, 192, 256, 344, 512)
REPEATS = 4


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    kernel_options: Tuple[int, ...] = KERNEL_OPTIONS
    quant_options: Tuple[Tuple[int, int], ...] = QUANT_OPTIONS
    channel_options: Tuple[int, ...] = CHANNEL_OPTIONS
    repeats: int = REPEATS
    n_blocks: int = 28
    include_identity: bool = True

    @property
    def n_ops(self) -> int:
        return len(self.kernel_options) + int(self.include_identity)

    @property
    def n_quant(self) -> int:
        return len(self.quant_options)

    def size(self) -> float:
        """Distinct model count: (ops x quant)^blocks x channel grid."""
        per_block = self.n_ops * self.n_quant
        return float(per_block) ** self.n_blocks * \
            float(len(self.channel_options)) ** self.repeats

    def quant_size(self) -> float:
        """Multiplier the quantization dimension adds (paper: ~6.7e20).

        Quant bits are chosen per weight+activation pair per block:
        n_quant^blocks additional viable options."""
        return float(self.n_quant) ** self.n_blocks


DEFAULT_SPACE = SearchSpace()

# A reduced space for CPU demos/tests (same structure, fewer options).
TINY_SPACE = SearchSpace(kernel_options=(3, 5, 9), quant_options=((8, 8),
                         (16, 16)), channel_options=(16,), repeats=1,
                         n_blocks=4)
