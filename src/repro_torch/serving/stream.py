"""Streaming serving: live signal append, incremental base emission,
and read-until ejection support types (the port's copy of
``repro.serving.stream``).

A :class:`StreamingRequest` is a basecaller read whose squiggle arrives
over time: callers push samples with ``append(samples)`` and close the
read with ``finish()``. The engine admits it like any read, but instead
of pre-chunked windows it pulls work from a :class:`StreamCursor` (built
by the runner, which knows the model's core/halo/stride geometry) every
tick. The cursor only ever issues frames whose receptive field is fully
covered by arrived samples, so every emitted base is final the moment it
leaves the CTC merge — the emitted prefix is exactly a prefix of the
whole-read offline basecall under ANY append schedule.

Frame-stability rule
--------------------
The basecaller emits one frame per ``stride`` samples, and ``halo``
(``ceil(receptive_field / stride) * stride``) bounds how far any frame's
receptive field reaches past its own sample span. Frame ``g`` (global
index, samples ``[g*stride, (g+1)*stride)``) is therefore STABLE — its
value can never change as more samples arrive — once

    arrived >= (g + 1) * stride + halo        (or the stream finished).

Stable frames of a zero-tail-padded window equal the whole-read forward
bit-for-bit: convolutions are local, BatchNorm (eval) and ReLU are
positionwise, and the read-edge mask with the :data:`UNBOUNDED` sentinel
only differs from the true-length mask at positions outside every stable
frame's receptive field.

QoS knob
--------
``qos="latency"`` (emit_latency) re-forwards the live window each time
new frames become stable — lowest sample-to-base latency, at the cost of
re-running the window forward as the tail fills in. ``qos="accuracy"``
(halo_recompute) forwards each window exactly ONCE, when its core+halo
is fully covered (or the stream finished) — the windows are then
byte-identical to the offline chunked path for every config, including
act-quantized ones whose activation scales see the whole window.
"""
from __future__ import annotations

import dataclasses
import time
from bisect import bisect_left
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.serving.engine import Request

# read_len sentinel for pre-finish windows: "the read end is not here
# yet" — masks nothing on the right, which is correct because only
# frames whose receptive field lies inside arrived samples are emitted
UNBOUNDED = 1 << 30


@dataclasses.dataclass
class ReadUntil:
    """Read-until (selective sequencing) config for the basecaller
    runner: a cheap start-of-read classifier head races the basecaller
    and ejects off-target reads after the first chunks.

    ``params``             classifier params, a tree of tensors
                           (``repro_torch.models.basecaller.classifier``)
    ``eject_after_chunks`` decide after this many classified windows
                           (the classifier sees each window exactly once,
                           when its content is final — so the decision is
                           append-schedule invariant)
    ``threshold``          eject iff the mean on-target logit over those
                           windows falls below this
    """

    params: Any
    eject_after_chunks: int = 2
    threshold: float = 0.0


class StreamWork(NamedTuple):
    """One coverable unit of streaming work, issued by a cursor."""
    payload: Any        # BasecallerRunner payload (see runner docstring)
    n_units: int        # NEW samples this work consumes (slot.pos delta)
    final: bool         # last frames of a finished stream
    need: int           # arrived-sample count that enabled these frames
    needs_finish: bool  # the finish() event (not an append) enabled them


class StreamingRequest(Request):
    """A basecaller read whose signal arrives via ``append()`` calls.

    The request can be submitted before any samples exist; the engine
    drains newly-covered windows every tick. ``finish()`` marks the read
    end (after which the final frames flush with true read-edge
    masking). Appends are timestamped so the engine can report
    sample-arrival -> base-emission latency; pass the engine's ``clock``
    for deterministic tests.
    """

    streaming = True

    def __init__(self, rid: int, sampling=None, *,
                 arrival_time: float = 0.0,
                 clock: Callable[[], float] = time.perf_counter):
        super().__init__(rid, (), sampling,
                         signal=np.zeros((0,), np.float32),
                         arrival_time=arrival_time)
        self._clock = clock
        self._parts: List[np.ndarray] = []
        self.arrived = 0
        self.stream_finished = False
        self.finish_time: Optional[float] = None
        # (cumulative samples, arrival clock) per append — emit latency
        self._log: List[Tuple[int, float]] = []

    # ------------------------------------------------------------ intake
    def append(self, samples) -> int:
        """Push newly-arrived squiggle samples; returns total arrived."""
        if self.stream_finished:
            raise RuntimeError(
                f"request {self.rid}: append() after finish()")
        arr = np.asarray(samples, np.float32).reshape(-1)
        if arr.size:
            self._parts.append(arr)
            self.arrived += int(arr.size)
            self.signal = np.concatenate(self._parts)
            self._log.append((self.arrived, self._clock()))
        return self.arrived

    def finish(self) -> None:
        """Mark the read end. Idempotent; an empty stream is invalid
        (mirrors the runner's empty-signal validation)."""
        if self.stream_finished:
            return
        if self.arrived < 1:
            raise ValueError(
                f"request {self.rid}: finish() on an empty stream — a "
                f"read needs at least one sample")
        self.stream_finished = True
        self.finish_time = self._clock()

    # ----------------------------------------------------------- queries
    def enable_time(self, need: int, needs_finish: bool) -> Optional[float]:
        """Clock time at which sample ``need`` (1-indexed cumulative
        count) had arrived — and, when ``needs_finish``, the stream had
        also finished. This is the event that made the just-emitted
        frames coverable."""
        t: Optional[float] = None
        if need > 0 and self._log:
            i = bisect_left([c for c, _ in self._log], need)
            if i < len(self._log):
                t = self._log[i][1]
        if needs_finish and self.finish_time is not None:
            t = self.finish_time if t is None else max(t, self.finish_time)
        return t


class StreamCursor:
    """Window/frame progress for one streaming read.

    Built by the runner (``BasecallerRunner.open_stream``) so the engine
    never sees model geometry; the engine calls :meth:`next_work` once
    per tick and wraps the result in a ``PrefillWork``. Window ``k``
    covers core samples ``[k*core, (k+1)*core)`` with ``halo`` context
    on each side — exactly the offline ``chunk_windows`` layout, so the
    frames fed to the CTC merge match the non-streaming path.
    """

    def __init__(self, core: int, halo: int, stride: int, *,
                 qos: str = "accuracy", classify_chunks: int = 0):
        if qos not in ("latency", "accuracy"):
            raise ValueError(f"qos must be 'latency' (emit_latency) or "
                             f"'accuracy' (halo_recompute), got {qos!r}")
        self.core, self.halo, self.stride = int(core), int(halo), int(stride)
        self.frames_per_window = self.core // self.stride
        self.qos = qos
        self.classify_chunks = int(classify_chunks)
        self.g_done = 0          # global frames emitted so far
        self.samples_done = 0    # samples consumed so far (slot.pos)
        self.done = False        # final frames issued

    def next_work(self, req) -> Optional[StreamWork]:
        """The next coverable frame span, or None if no new frame's
        receptive field is covered by arrived samples yet. At most one
        window's frames per call (one fixed-shape forward per tick)."""
        if self.done:
            return None
        arrived, fin = req.arrived, req.stream_finished
        F0 = self.frames_per_window
        k = self.g_done // F0                      # current window
        a = k * self.core                          # its core start
        win_end = (k + 1) * F0                     # frame bound (exclusive)
        if fin:
            total = -(-arrived // self.stride)     # ceil(S / stride) >= 1
            g_hi = min(win_end, total)
            need, needs_finish = arrived, True
        elif self.qos == "accuracy":
            # halo_recompute: forward the window exactly once, when its
            # core + right halo is fully covered (left side has arrived
            # by construction) — window content == offline chunk
            need, needs_finish = a + self.core + self.halo, False
            if arrived < need:
                return None
            g_hi = win_end
        else:
            # emit_latency: flush every frame the moment its receptive
            # field is covered (re-forwards the live window as it fills)
            g_hi = min(win_end, (arrived - self.halo) // self.stride)
            if g_hi <= self.g_done:
                return None
            need, needs_finish = g_hi * self.stride + self.halo, False
        final = fin and g_hi == total
        read_len = arrived if fin else UNBOUNDED
        new_samples = min(g_hi * self.stride, arrived) if fin \
            else g_hi * self.stride
        # classify only window-final forwards: their window content is
        # complete, so the verdict is append-schedule invariant
        window_complete = g_hi == win_end or final
        classify = int(window_complete and k < self.classify_chunks)
        payload = (self._window(req.signal, a), self.g_done - k * F0,
                   g_hi - k * F0, a - self.halo, read_len, classify)
        work = StreamWork(payload, new_samples - self.samples_done,
                          final, min(need, arrived) if fin else need,
                          needs_finish)
        self.g_done, self.samples_done = g_hi, new_samples
        if final:
            self.done = True
        return work

    def _window(self, sig: np.ndarray, a: int) -> np.ndarray:
        """Zero-padded ``(W, 1)`` window over core start ``a`` from the
        samples arrived so far (identical to the offline window once the
        span is fully covered)."""
        lo, hi = a - self.halo, a + self.core + self.halo
        win = np.zeros((hi - lo, 1), np.float32)
        src_lo, src_hi = max(lo, 0), min(hi, sig.shape[0])
        if src_hi > src_lo:
            win[src_lo - lo:src_hi - lo, 0] = sig[src_lo:src_hi]
        return win
