"""Tick-plan cache: one registered step program per tick bucket.

The port's counterpart of ``repro.serving.plan``. Every schedulable
tick shape maps to a plan key ``(kind, width, flavor)`` that owns one
plain callable; ``warmup`` (runner-side) executes each plan once at
launch, and ``lookup`` is the tick-time access path with hit/miss
accounting (a hit is a lookup of a plan that already ran). PyTorch
runs eagerly, so nothing is traced or compiled per plan and
``stats()["retraces"]`` is always 0.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

PlanKey = Tuple[str, int, str]


def chunk_buckets(chunk_tokens: int) -> Tuple[int, ...]:
    """Mixed-tick width buckets: powers of two below ``chunk_tokens``,
    plus the full width itself."""
    if chunk_tokens < 1:
        raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
    buckets: List[int] = []
    b = 1
    while b < chunk_tokens:
        buckets.append(b)
        b *= 2
    buckets.append(int(chunk_tokens))
    return tuple(buckets)


def round_chunk(n: int, buckets: Sequence[int]) -> int:
    """Round a tick's widest chunk up to its covering bucket."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"chunk width {n} exceeds the largest bucket {buckets[-1]} — "
        f"the scheduler emitted a shape outside the warmed plan set")


class PlanMissError(RuntimeError):
    """A tick needed a plan that was never registered."""


class PlanCache:
    """Registry of per-bucket step callables with hit/miss accounting."""

    def __init__(self) -> None:
        self._fns: Dict[PlanKey, Callable] = {}
        self._warmed: set = set()
        self.hits = 0
        self.misses = 0
        self.calls: Dict[PlanKey, int] = {}     # tick lookups per key

    def register(self, key: PlanKey, fn: Callable) -> None:
        if key in self._fns:
            raise ValueError(f"plan {key} registered twice")
        self._fns[key] = fn

    def keys(self) -> List[PlanKey]:
        return list(self._fns)

    def __contains__(self, key: PlanKey) -> bool:
        return key in self._fns

    def fn(self, key: PlanKey) -> Callable:
        """Raw access to a plan's callable (warmup)."""
        return self._fns[key]

    def mark_warmed(self, key: PlanKey) -> None:
        self._warmed.add(key)

    def lookup(self, key: PlanKey) -> Callable:
        """Tick-time plan access with bucket accounting."""
        fn = self._fns.get(key)
        if fn is None:
            raise PlanMissError(
                f"no plan registered for tick bucket {key}; registered: "
                f"{sorted(self._fns)}")
        self.calls[key] = self.calls.get(key, 0) + 1
        if key in self._warmed:
            self.hits += 1
        else:
            self.misses += 1
            self._warmed.add(key)
        return fn

    def stats(self) -> Dict[str, int]:
        """``{plans, warmed, bucket_hits, bucket_misses, retraces}``."""
        return {"plans": len(self._fns), "warmed": len(self._warmed),
                "bucket_hits": self.hits, "bucket_misses": self.misses,
                "retraces": 0}
