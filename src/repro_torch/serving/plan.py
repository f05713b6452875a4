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

from typing import Callable, Dict, Tuple

PlanKey = Tuple[str, int, str]


class PlanMissError(RuntimeError):
    """A tick needed a plan that was never registered."""


class PlanCache:
    """Registry of per-bucket step callables with hit/miss accounting."""

    def __init__(self) -> None:
        self._fns: Dict[PlanKey, Callable] = {}
        self._warmed: set = set()
        self.hits = 0
        self.misses = 0

    def register(self, key: PlanKey, fn: Callable) -> None:
        if key in self._fns:
            raise ValueError(f"plan {key} registered twice")
        self._fns[key] = fn

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
