"""Serving metrics: per-request latency, aggregate throughput, queue
depth, paged-pool utilization.

Everything is host-side bookkeeping around an injectable clock (tests
pass a fake clock for determinism). ``summary()`` condenses to the
numbers the CLI / bench print: decode tokens/s, time-to-first-token
percentiles (p50/p95/p99), per-tick decode-interval jitter (p50/p99 of
the gap between decode-bearing ticks — the number unified mixed ticks
exist to flatten), queue depth, slot occupancy, block-pool utilization,
preemption count.

Bounded mode (``max_samples``): long-running serves must not grow host
memory without bound, so the per-request table evicts the oldest DONE
entries and the per-step sample lists become rolling windows. Aggregate
counters (requests done, tokens generated, decode/prefill totals,
preemptions) are kept exactly either way; only the percentile-style
numbers (TTFT, queue depth) reduce to the rolling window.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class RequestTimes:
    rid: int
    n_prompt: int = 0
    arrival: Optional[float] = None
    admit: Optional[float] = None
    first_token: Optional[float] = None
    done: Optional[float] = None
    n_generated: int = 0

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token is None or self.arrival is None:
            return None
        return self.first_token - self.arrival


def _pct(xs: List[float], q: float) -> float:
    if not xs:
        return float("nan")
    s = sorted(xs)
    i = min(int(q * (len(s) - 1) + 0.5), len(s) - 1)
    return s[i]


class ServingMetrics:
    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 max_samples: Optional[int] = None):
        self.clock = clock
        self.max_samples = max_samples
        self.requests: Dict[int, RequestTimes] = {}

        def _samples():
            return deque(maxlen=max_samples) if max_samples else []

        self.queue_depth_samples = _samples()
        self.active_samples = _samples()
        self.pool_util_samples = _samples()
        # dispatch pipeline: wall time of each non-idle engine tick
        # (schedule + dispatch + deferred harvest) — p50 is the steady
        # cadence, p99 the worst stall a tick injects
        self.tick_latency_samples = _samples()
        # wall-clock gap between consecutive decode-bearing ticks — the
        # decode-interval jitter reservoir (p50 = steady cadence, p99 =
        # the stall an admission injects under split-tick scheduling)
        self.decode_interval_samples = _samples()
        # streaming: sample-arrival -> base-emission latency reservoir
        self.emit_latency_samples = _samples()
        self._last_decode_time: Optional[float] = None
        self.done_count = 0             # exact even when `requests` rolls
        self.gen_count = 0
        self.preempts = 0
        # read-until: ejection + samples-saved accounting (exact counters)
        self.ejections = 0
        self.ejected_consumed = 0       # samples basecalled before eject
        self.ejected_arrived = 0        # samples arrived before eject
        self.samples_saved = 0          # samples never sequenced/appended
        # backpressure + dispatch-pipeline accounting (exact counters)
        self.rejections = 0             # bounded-queue load-shed count
        self.idle_ticks = 0             # ticks the fast path skipped
        self.queue_depth_hwm = 0        # exact high-water mark (the
                                        # rolling sample window may miss it)
        self.plan_stats: Dict[str, int] = {}   # runner PlanCache.stats()
        self.decode_steps = 0
        self.decode_tokens = 0          # useful (non-pad) tokens decoded
        self.decode_time = 0.0
        self.prefill_chunks = 0
        self.prefill_tokens = 0
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None

    # ---------------------------------------------------------- events
    def _req(self, rid: int) -> RequestTimes:
        if rid not in self.requests:
            self.requests[rid] = RequestTimes(rid)
        return self.requests[rid]

    def record_arrival(self, rid: int, n_prompt: int) -> None:
        if self.start_time is None:
            self.start_time = self.clock()
        r = self._req(rid)
        r.arrival = self.clock()
        r.n_prompt = n_prompt

    def record_admit(self, rid: int) -> None:
        self._req(rid).admit = self.clock()

    def record_first_token(self, rid: int) -> None:
        r = self._req(rid)
        if r.first_token is None:       # preemption resume: keep the first
            r.first_token = self.clock()

    def record_preempt(self, rid: int) -> None:
        self.preempts += 1

    def record_emit(self, latency_s: float) -> None:
        """One streamed base-emission event: seconds from the arrival of
        the sample that completed the emitted frames' receptive field to
        the bases landing in ``out_tokens``."""
        self.emit_latency_samples.append(latency_s)

    def record_eject(self, rid: int, consumed: int, arrived: int) -> None:
        """A read-until ejection: the read completed with status
        ``ejected`` after basecalling ``consumed`` of its ``arrived``
        samples. Arrived-but-never-basecalled samples count as saved
        immediately; the traffic generator adds the forgone tail via
        :meth:`record_samples_saved` when it stops appending."""
        r = self._req(rid)
        r.done = self.end_time = self.clock()
        self.ejections += 1
        self.ejected_consumed += consumed
        self.ejected_arrived += arrived
        self.samples_saved += max(arrived - consumed, 0)

    def record_samples_saved(self, n: int) -> None:
        """Samples a generator skipped because the read was ejected."""
        self.samples_saved += n

    def record_done(self, rid: int, n_generated: int) -> None:
        r = self._req(rid)
        r.done = self.end_time = self.clock()
        r.n_generated = n_generated
        self.done_count += 1
        self.gen_count += n_generated
        if self.max_samples and len(self.requests) > self.max_samples:
            # evict oldest DONE entries (insertion order); live ones stay
            for old in list(self.requests):
                if len(self.requests) <= self.max_samples:
                    break
                if self.requests[old].done is not None:
                    del self.requests[old]

    def record_reject(self, rid: int) -> None:
        """Bounded-admission load-shed: the request completed with
        status ``rejected`` without ever running."""
        r = self._req(rid)
        r.done = self.clock()           # terminal: evictable when rolling
        self.rejections += 1
        if self.max_samples and len(self.requests) > self.max_samples:
            for old in list(self.requests):
                if len(self.requests) <= self.max_samples:
                    break
                if self.requests[old].done is not None:
                    del self.requests[old]

    def record_tick(self, dt: float) -> None:
        """Wall time of one non-idle engine tick."""
        self.tick_latency_samples.append(dt)

    def record_idle_tick(self) -> None:
        """The idle fast path skipped a tick's schedule/dispatch."""
        self.idle_ticks += 1

    def record_plan_stats(self, stats: Dict[str, int]) -> None:
        """Latest runner ``PlanCache.stats()`` snapshot (cumulative
        counters — overwrite, don't accumulate)."""
        if stats:
            self.plan_stats = dict(stats)

    def record_step(self, queue_depth: int, n_active: int,
                    pool_util: float = 0.0) -> None:
        self.queue_depth_samples.append(queue_depth)
        self.active_samples.append(n_active)
        self.pool_util_samples.append(pool_util)
        if queue_depth > self.queue_depth_hwm:
            self.queue_depth_hwm = queue_depth

    def record_decode(self, n_tokens: int, dt: float) -> None:
        now = self.clock()
        if self._last_decode_time is not None:
            self.decode_interval_samples.append(now - self._last_decode_time)
        self._last_decode_time = now
        self.decode_steps += 1
        self.decode_tokens += n_tokens
        self.decode_time += dt

    def record_prefill(self, n_tokens: int) -> None:
        self.prefill_chunks += 1
        self.prefill_tokens += n_tokens

    # --------------------------------------------------------- summary
    def summary(self) -> Dict[str, float]:
        elapsed = ((self.end_time or self.clock())
                   - (self.start_time or 0.0)) if self.start_time else 0.0
        ttfts = [r.ttft for r in self.requests.values()
                 if r.done is not None and r.ttft is not None]
        gen = self.gen_count
        qd = list(self.queue_depth_samples)
        act = list(self.active_samples)
        pu = list(self.pool_util_samples)
        di = list(self.decode_interval_samples)
        em = list(self.emit_latency_samples)
        tl = list(self.tick_latency_samples)
        ps = self.plan_stats
        return {
            "requests_done": self.done_count,
            "generated_tokens": gen,
            "elapsed_s": elapsed,
            "tokens_per_s": gen / elapsed if elapsed > 0 else 0.0,
            "decode_tokens_per_s": (self.decode_tokens / self.decode_time
                                    if self.decode_time > 0 else 0.0),
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "preemptions": self.preempts,
            "ttft_mean_s": (sum(ttfts) / len(ttfts)) if ttfts else float("nan"),
            "ttft_p50_s": _pct(ttfts, 0.50),
            "ttft_p95_s": _pct(ttfts, 0.95),
            "ttft_p99_s": _pct(ttfts, 0.99),
            "decode_interval_p50_s": _pct(di, 0.50),
            "decode_interval_p99_s": _pct(di, 0.99),
            "emit_events": len(em),
            "emit_latency_p50_s": _pct(em, 0.50),
            "emit_latency_p99_s": _pct(em, 0.99),
            "ejections": self.ejections,
            "ejected_consumed_samples": self.ejected_consumed,
            "samples_saved": self.samples_saved,
            "queue_depth_max": max(qd, default=0),
            "queue_depth_mean": sum(qd) / len(qd) if qd else 0.0,
            "queue_depth_hwm": self.queue_depth_hwm,
            "slot_occupancy": sum(act) / len(act) if act else 0.0,
            "pool_util_mean": sum(pu) / len(pu) if pu else 0.0,
            "pool_util_max": max(pu, default=0.0),
            "tick_latency_p50_s": _pct(tl, 0.50),
            "tick_latency_p99_s": _pct(tl, 0.99),
            "idle_ticks": self.idle_ticks,
            "rejections": self.rejections,
            "plans": ps.get("plans", 0),
            "plans_warmed": ps.get("warmed", 0),
            "bucket_hits": ps.get("bucket_hits", 0),
            "bucket_misses": ps.get("bucket_misses", 0),
            "retraces": ps.get("retraces", 0),
            "graphs": ps.get("graphs", 0),
        }
