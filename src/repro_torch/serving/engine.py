"""Continuous-batching scheduler: request queue -> runner -> tokens.

The port's copy of ``repro.serving.engine``. The engine is PURE
host-side control flow — queue, slots, admission, block accounting,
preemption, metrics. Everything model-shaped (which jitted programs
run, what a payload is, how a pool backs it) lives behind the
:class:`repro_torch.serving.runner.ModelRunner` protocol, so one scheduler
serves token LMs, audio enc-dec, and the squiggle basecaller alike;
this module imports no model code at all.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence)

import numpy as np
import torch

from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.runner import (Chunk, DecodeWork, PrefillWork,
                                        make_runner)
from repro_torch.serving.sampling import GREEDY, SamplingParams

FREE, PREFILL, DECODE = "free", "prefill", "decode"
# async pipeline only: the request completed at a harvest, but a newer
# speculative tick for the slot is still in flight — the slot keeps its
# pool row until that tick is harvested (and its output discarded)
DRAIN = "drain"


class Request:
    """One serving request: a payload union + per-request sampling.

    Payloads (exactly one):
      ``prompt``  token ids — LM decoding (audio archs also take
                  ``frames``, the encoder input, alongside the decoder
                  prompt).
      ``signal``  a 1-D float squiggle — basecaller serving;
                  ``out_tokens`` fills with base ids (1..4) as chunks
                  stream through, and stopping criteria don't apply
                  (the read ends when the signal does).

    ``sampling`` is a :class:`repro_torch.serving.sampling.SamplingParams`
    (stopping criteria + temperature/top-k/top-p/seed). The legacy
    ``Request(prompt, max_new_tokens=…, eos_id=…)`` kwargs still work —
    they map onto a default-greedy SamplingParams and emit a
    DeprecationWarning.

    ``out_tokens`` fills as the engine runs. ``status`` tracks the
    lifecycle — ``queued`` -> ``running`` -> ``finished``, with
    ``preempted-pending`` while evicted-awaiting-resume, ``ejected``
    for reads the read-until classifier rejected (their ``out_tokens``
    hold the PARTIAL bases emitted before ejection; never mistake them
    for a complete basecall — check ``status``/``ejected``), and
    ``rejected`` for requests the bounded admission queue shed
    (``max_queue`` full or the queue deadline expired) — an EXPLICIT
    terminal status with ``reject_reason`` set, never a silent drop.
    """

    def __init__(self, rid: int, prompt: Sequence[int] = (),
                 sampling: Optional[SamplingParams] = None, *,
                 frames=None, signal=None, arrival_time: float = 0.0,
                 max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None):
        if max_new_tokens is not None or eos_id is not None:
            if sampling is not None:
                raise ValueError(
                    f"request {rid}: pass either `sampling=SamplingParams"
                    f"(...)` or the legacy max_new_tokens/eos_id kwargs, "
                    f"not both")
            warnings.warn(
                "Request(max_new_tokens=..., eos_id=...) is deprecated; "
                "use Request(rid, prompt, SamplingParams(max_new_tokens"
                "=..., eos_id=...)) — the legacy kwargs map to greedy "
                "sampling", DeprecationWarning, stacklevel=2)
            sampling = SamplingParams(
                max_new_tokens=(GREEDY.max_new_tokens
                                if max_new_tokens is None
                                else max_new_tokens),
                eos_id=eos_id)
        if signal is not None and len(prompt):
            raise ValueError(
                f"request {rid}: carries both a prompt and a signal — a "
                f"request is exactly one payload (token prompt OR "
                f"squiggle read)")
        self.rid = rid
        self.prompt = prompt
        self.sampling = sampling if sampling is not None else GREEDY
        self.frames = frames
        self.signal = signal
        self.arrival_time = arrival_time    # virtual arrival (Poisson replay)
        self.out_tokens: List[int] = []
        self.status = "queued"              # engine-owned lifecycle state
        self.reject_reason: Optional[str] = None
        self._deadline: Optional[float] = None   # queue-shed deadline

    # legacy accessors (the pre-SamplingParams field names)
    @property
    def max_new_tokens(self) -> int:
        return self.sampling.max_new_tokens

    @property
    def eos_id(self) -> Optional[int]:
        return self.sampling.eos_id

    @property
    def finished(self) -> bool:
        """Complete AND fully served (an ejected read is NOT finished)."""
        return self.status == "finished"

    @property
    def ejected(self) -> bool:
        """Read-until rejected this read; ``out_tokens`` are partial."""
        return self.status == "ejected"

    @property
    def rejected(self) -> bool:
        """The bounded admission queue shed this request before it ran."""
        return self.status == "rejected"

    @property
    def done(self) -> bool:
        if self.status == "rejected":       # shed: terminal, never served
            return True
        if self.signal is not None:         # reads end with their signal
            return self.status in ("finished", "ejected")
        if len(self.out_tokens) >= self.sampling.max_new_tokens:
            return True
        eos = self.sampling.eos_id
        return (eos is not None and len(self.out_tokens) > 0
                and self.out_tokens[-1] == eos)

    def __repr__(self) -> str:              # tests print these on failure
        payload = (f"signal[{np.asarray(self.signal).size}]"
                   if self.signal is not None else f"prompt[{len(self.prompt)}]")
        return (f"Request(rid={self.rid}, {payload}, "
                f"sampling={self.sampling}, out={len(self.out_tokens)})")


@dataclasses.dataclass
class StreamState:
    """Per-slot lifecycle of a live :class:`StreamingRequest`.

    The engine owns this; the ``cursor`` inside it is an opaque object
    the runner built (``runner.open_stream``) that turns arrived samples
    into work payloads — the engine never sees model geometry. On
    preemption the whole StreamState (plus the runner's exported row
    state, e.g. the CTC merge) is stashed on the request and restored at
    re-admission, so a resumed stream continues exactly where it left.
    """

    cursor: Any                        # runner-built window/frame cursor
    consumed: int = 0                  # samples issued to the runner
    need: int = 0                      # samples enabling the in-flight work
    needs_finish: bool = False         # ... or the finish() event


@dataclasses.dataclass
class _Slot:
    state: str = FREE
    req: Optional[Request] = None
    pos: int = 0                       # payload units already consumed
    pending: List[Chunk] = dataclasses.field(default_factory=list)
    last_token: int = 0                # next decode input
    fresh: bool = False                # first chunk must invalidate the row
    seq: int = -1                      # admission order (preemption picks max)
    stream: Optional[StreamState] = None   # live StreamingRequest state
    # async pipeline bookkeeping (dispatch-time state; unused when sync)
    emitted: int = 0                   # tokens emitted OR in flight
    inflight_emit: bool = False        # newest dispatched tick emits for
                                       # this slot (token not read back yet)
    eject_pending: bool = False        # eject once the speculative tick
                                       # in flight is harvested+discarded


class ServingEngine:
    """Slot-based continuous batching over a :class:`ModelRunner`.

    The runner registry (``repro_torch.serving.runner``) picks the backend:
    token-only archs (dense/moe/ssm/mla/hybrid) serve over the paged
    block-granular KV pool with per-request SamplingParams; audio
    enc-dec archs stage their encoder K/V per slot at admission; the
    basecaller streams squiggle chunks with incremental CTC merge (no
    decode phase at all). Scheduling invariants are runner-independent:
    greedy rows decode bit-identically to the one-shot path regardless
    of scheduling, and sampled rows replay deterministically from their
    ``(seed, rid, step)`` keys (so preemption + re-prefill resume is
    token-exact for both).

    Admission & preemption (paged pool)
    -----------------------------------
    ``submit`` rejects only what can NEVER run (runner ``validate``:
    capacity, payload shape). ``_admit`` takes the FIFO head when a slot
    is free AND the runner can back its payload (``alloc_pool``); decode
    allocates one block at a time as positions cross block boundaries.
    When the pool runs dry mid-decode, the YOUNGEST running request is
    preempted — pool row released, request pushed back to the queue
    front — and resumes later by re-prefilling prompt + generated
    tokens (decode is deterministic, so tokens are unchanged).
    Preempting the youngest means the oldest always progresses: no
    livelock.

    Parameters
    ----------
    params, cfg : the model; the runner registry dispatches on ``cfg``
        (vlm frontends have no runner yet and raise NotImplementedError).
    n_slots : decode batch size (fixed for the engine's lifetime).
    cache_len : per-REQUEST logical KV capacity; every admitted token
        request must satisfy ``len(prompt) + max_new_tokens - 1 <=
        cache_len``. (Ignored by the basecaller runner — reads stream.)
    prefill_chunk : tokens per chunked-prefill step. The scheduler runs
        at most one chunk per slot per tick.
    max_prefill_tokens : per-tick prefill token budget for the unified
        tick — chunks are scheduled oldest-admission-first until the
        cumulative payload reaches the budget (soft cap: the chunk that
        crosses it still runs, so one chunk always makes progress).
        0 = unlimited (every PREFILL slot runs a chunk each tick).
        Bounding it keeps mixed ticks small, so a burst of admissions
        cannot inflate the decode interval of the running slots.
    co_batch : True (default) = unified ticks — every scheduled slot,
        mid-prefill or decoding, advances in ONE runner step per tick.
        False = the legacy split-tick scheduler (one runner step per
        prefill slot, then a decode-only step; a long admission stalls
        decode) — kept as the measured baseline in
        ``benchmarks/bench_serving.py``. Token sequences are identical
        in both modes; only tick timing differs (in co-batched mode a
        slot finishing prefill decodes its next token on the FOLLOWING
        tick rather than in the same one).
    block_len : KV positions per arena block (``cache_len`` degenerates
        to the old contiguous one-row-per-slot layout).
    n_blocks : arena blocks per full-length layer group; 0 = full
        backing. Set lower to oversubscribe slots against KV bytes.
    async_dispatch : pipeline the tick — dispatch tick N's device work,
        THEN harvest tick N-1's deferred readback, so host scheduling
        and CTC-merge overlap device compute. Token-identical to the
        synchronous engine (decode rows whose input token is still in
        flight chain to the previous tick's on-device output; see
        ``repro_torch.serving.runner``), one tick of extra output latency.
        Requires a runner with ``supports_async``.
    max_queue : bounded admission — ``submit`` beyond this queue depth
        sheds load with an explicit ``status='rejected'`` instead of
        growing the queue (0 = unbounded). Preempted-pending requests
        never count against (or fall to) the bound.
    queue_timeout_s : deadline-aware shedding — a request still QUEUED
        this many seconds after submit is rejected at the next
        submit/admission scan rather than served late (0 = no deadline).
    history_limit : bound host-side growth for indefinite serves (slot
        history, completed map, metrics reservoirs roll; aggregate
        counters stay exact). None = unbounded (tests, benches).
    runner : pre-built ModelRunner (overrides the registry dispatch).
    **runner_kw : extra backend knobs, e.g. ``chunk_samples``/``beam``/
        ``model_state`` for the basecaller runner.
    """

    def __init__(self, params, cfg, *, n_slots: int = 4,
                 cache_len: int = 256, prefill_chunk: int = 16,
                 max_prefill_tokens: int = 0, co_batch: bool = True,
                 async_dispatch: bool = False, max_queue: int = 0,
                 queue_timeout_s: float = 0.0,
                 cache_dtype=None, block_len: int = 0,
                 n_blocks: int = 0, history_limit: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 runner=None, **runner_kw):
        if cache_dtype is None:
            cache_dtype = torch.bfloat16
        self.params = params
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.cache_len = int(cache_len)
        self.prefill_chunk = int(prefill_chunk)
        self.max_prefill_tokens = int(max_prefill_tokens)
        self.co_batch = bool(co_batch)
        self.runner = runner if runner is not None else make_runner(
            params, cfg, n_slots=self.n_slots, cache_len=self.cache_len,
            prefill_chunk=self.prefill_chunk, cache_dtype=cache_dtype,
            block_len=block_len, n_blocks=n_blocks,
            async_dispatch=bool(async_dispatch), **runner_kw)
        self.async_dispatch = bool(async_dispatch)
        self.max_queue = int(max_queue)
        self.queue_timeout_s = float(queue_timeout_s)
        if self.async_dispatch:
            if not co_batch:
                raise ValueError(
                    "async_dispatch requires co_batch=True — the legacy "
                    "split-tick scheduler has no single tick to pipeline")
            if not getattr(self.runner, "supports_async", False):
                raise ValueError(
                    f"async_dispatch needs a runner with dispatch/collect "
                    f"support; {type(self.runner).__name__} is "
                    f"synchronous-only")
        # the one in-flight tick under async dispatch:
        # [works, handle, discard-slot set, per-slot stream (need,
        #  needs_finish) metadata] — harvested one step later
        self._inflight: Optional[list] = None
        self._last_idle_sig = None      # idle-tick fast path witness
        self.history_limit = history_limit
        self.metrics = ServingMetrics(clock, max_samples=history_limit)
        self.queue: Deque[Request] = deque()
        self.slots = [_Slot() for _ in range(self.n_slots)]
        self._admit_seq = 0
        # rid admission order per slot — observability + slot-reuse tests
        self.slot_history: List[Any] = [
            deque(maxlen=history_limit) if history_limit else []
            for _ in range(self.n_slots)]
        self.completed: Dict[int, Request] = {}

    @property
    def pool(self):
        """The runner's cache pool (None for poolless runners)."""
        return self.runner.pool

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> bool:
        """Queue a request. Invalid payloads still raise ValueError
        (they can NEVER run); a full bounded queue instead sheds load —
        the request completes immediately with ``status='rejected'``
        and ``submit`` returns False. Accepted submits return True."""
        if getattr(req, "streaming", False) and \
                not getattr(self.runner, "supports_streaming", False):
            raise ValueError(
                f"request {req.rid}: {type(self.runner).__name__} cannot "
                f"serve a StreamingRequest — live signal append is a "
                f"basecaller-runner capability (use a basecaller arch or "
                f"submit a whole-payload Request)")
        self.runner.validate(req)      # capacity/payload; raises ValueError
        n_in = (int(np.asarray(req.signal).size) if req.signal is not None
                else len(req.prompt))
        self.metrics.record_arrival(req.rid, n_in)
        if self.queue_timeout_s:
            req._deadline = self.metrics.clock() + self.queue_timeout_s
        if self.max_queue and self._queued_depth() >= self.max_queue:
            self._shed_expired()       # expired waiters make room first
            if self._queued_depth() >= self.max_queue:
                self._reject(req, f"queue full (max_queue="
                                  f"{self.max_queue})")
                return False
        self.queue.append(req)
        return True

    def _queued_depth(self) -> int:
        """Fresh waiters only: preempted-pending requests re-queued for
        resume hold generated tokens and are never shed, so they don't
        count against the admission bound either."""
        return sum(r.status == "queued" for r in self.queue)

    def _shed_expired(self) -> None:
        """Deadline-aware load-shed: reject every QUEUED request whose
        queue deadline has passed (explicit ``rejected`` status — never
        a silent drop). Preempted-pending requests are exempt."""
        if not self.queue_timeout_s:
            return
        now = self.metrics.clock()
        kept: Deque[Request] = deque()
        while self.queue:
            r = self.queue.popleft()
            if (r.status == "queued" and r._deadline is not None
                    and now > r._deadline):
                self._reject(r, f"queue deadline expired "
                                f"({self.queue_timeout_s}s)")
            else:
                kept.append(r)
        self.queue = kept

    def _reject(self, req: Request, reason: str) -> None:
        req.status = "rejected"
        req.reject_reason = reason
        self.metrics.record_reject(req.rid)
        self._complete(req)

    @property
    def busy(self) -> bool:
        return (bool(self.queue) or self._inflight is not None
                or any(s.state != FREE for s in self.slots))

    @property
    def n_active(self) -> int:
        return sum(s.state != FREE for s in self.slots)

    # --------------------------------------------------------- scheduler
    def step(self) -> None:
        """One scheduler tick: admit -> schedule -> one co-batched
        runner step (or the legacy split ticks when ``co_batch=False``;
        dispatch + deferred harvest when ``async_dispatch``)."""
        t0 = self.metrics.clock()
        self._shed_expired()
        self._admit()
        sig = self._idle_signature()
        if sig is not None and sig == self._last_idle_sig:
            # idle fast path: every live slot is a stream still waiting
            # on the same unarrived samples — skip rebuilding (and, in
            # async mode, re-dispatching) an all-empty work list
            self.metrics.record_idle_tick()
            return
        if self.async_dispatch:
            dispatched = self._step_async()
        elif self.co_batch:
            if self.runner.autoregressive:
                self._ensure_decode_blocks()
            works = self._schedule()
            dispatched = any(w is not None for w in works)
            self._run_works(works)
        else:
            # legacy split ticks: one runner step per prefill slot,
            # then a decode-only step — the pre-unified-tick scheduler,
            # where a long admission stalls every running slot's decode
            dispatched = True
            for i in [j for j, s in enumerate(self.slots)
                      if s.state == PREFILL]:
                works: List[Optional[Any]] = [None] * self.n_slots
                self._pop_chunk(works, i)
                self._run_works(works)
            if self.runner.autoregressive:
                self._ensure_decode_blocks()
                works = [None] * self.n_slots
                self._add_decode_works(works)
                self._run_works(works)
        self._last_idle_sig = None if dispatched else sig
        self.metrics.record_plan_stats(self.runner.plan_stats())
        self.metrics.record_step(len(self.queue), self.n_active,
                                 self.runner.pool_util())
        self.metrics.record_tick(self.metrics.clock() - t0)

    def _idle_signature(self):
        """Hashable witness that NOTHING can progress without new
        external input (stream appends/finish or a submit): every live
        slot is a stream mid-wait. None whenever some slot has
        dispatchable work or a tick is in flight. Two consecutive
        identical witnesses let ``step`` skip the schedule/dispatch
        machinery entirely — ``run()``-style loops stop busy-spinning
        the runner while a pore fills a buffer."""
        if self.queue or self._inflight is not None:
            return None
        sig = []
        for s in self.slots:
            if s.state == FREE:
                continue
            if s.state != PREFILL or s.stream is None:
                return None             # decode/drain/chunked work exists
            sig.append((s.req.rid, s.req.arrived, s.req.stream_finished))
        return tuple(sig)

    def warmup(self) -> int:
        """Pre-compile every tick-plan bucket (runner ``warmup``) so a
        full traffic run performs zero mid-traffic compiles; returns
        the number of plans warmed. Call before the first ``step``."""
        fn = getattr(self.runner, "warmup", None)
        return int(fn()) if fn is not None else 0

    # -------------------------------------------------- async pipeline
    def _step_async(self) -> bool:
        """Dispatch tick N, THEN harvest tick N-1: the deferred
        readback (and the host-side booking it feeds) overlaps the
        device computing tick N. Scheduling uses dispatch-time booked
        state only — the single token value the host can't know yet (a
        slot that emitted in the still-in-flight tick) rides as a
        CHAINED decode row, resolved on device. Returns True when
        device work was dispatched."""
        if self.runner.autoregressive:
            self._ensure_decode_blocks()
        works = self._schedule(async_=True)
        prev, self._inflight = self._inflight, None
        if any(w is not None for w in works):
            meta = self._stream_meta(works)
            self._book_dispatch(works)
            handle = self.runner.dispatch(works)
            self._inflight = [works, handle, set(), meta]
        if prev is not None:
            self._harvest(prev)
        return self._inflight is not None

    def flush(self) -> None:
        """Harvest the in-flight tick, if any. After a flush every
        emitted token is booked and no speculative work exists — the
        state preemption and external inspection need."""
        prev, self._inflight = self._inflight, None
        if prev is not None:
            self._harvest(prev)

    def _stream_meta(self, works) -> List[Optional[tuple]]:
        """Capture each streaming work's (need, needs_finish) enabling
        event AT DISPATCH — by harvest time the cursor may already have
        issued the next window and overwritten the slot's copy."""
        meta: List[Optional[tuple]] = [None] * self.n_slots
        for i, w in enumerate(works):
            s = self.slots[i]
            if isinstance(w, PrefillWork) and s.stream is not None:
                meta[i] = (s.stream.need, s.stream.needs_finish)
        return meta

    def _book_dispatch(self, works) -> None:
        """Dispatch-time booking: every host-deterministic transition
        (positions, chunk accounting, PREFILL->DECODE, emit counters)
        happens when the work is ENQUEUED, so the next tick schedules
        without waiting for this tick's readback. Token values, stream
        emissions, EOS/completions and ejection verdicts book at
        harvest."""
        for i, w in enumerate(works):
            slot = self.slots[i]
            if w is None:
                if slot.state != FREE:
                    # no emitting work this tick: by the time the NEXT
                    # schedule runs, any earlier emission is harvested
                    slot.inflight_emit = False
                continue
            if isinstance(w, PrefillWork):
                slot.fresh = False
                slot.pos += w.n_units
                slot.inflight_emit = False
                self.metrics.record_prefill(w.n_units)
                if slot.stream is not None:
                    slot.stream.consumed = slot.pos
                if not w.final:
                    continue
                if self.runner.autoregressive:
                    # prompt fully cached: this chunk emits the next
                    # generated token (in flight until harvest)
                    slot.state = DECODE
                    slot.inflight_emit = True
                    slot.emitted += 1
                else:
                    slot.state = DRAIN  # read ends here; finish at harvest
            else:
                slot.pos += 1
                slot.emitted += 1
                slot.inflight_emit = True

    def _harvest(self, inflight) -> None:
        """Deferred readback + all token-dependent bookkeeping for a
        previously dispatched tick: emitted tokens, stream emissions,
        completions (EOS / max_new / final chunk), read-until
        ejections. Slots whose request completed while a newer
        speculative tick was already in flight park in DRAIN and
        resolve here one tick later, their speculative output
        discarded."""
        works, handle, discard, meta = inflight
        n_decode = sum(isinstance(w, DecodeWork) for w in works)
        t0 = self.metrics.clock()
        # sync: the tick's one deferred readback — collect() returns
        # the emitted tokens to the host, a full tick behind dispatch
        emitted = self.runner.collect(handle, discard=frozenset(discard))
        dt = self.metrics.clock() - t0
        if n_decode:
            self.metrics.record_decode(n_decode, dt)
        for i, w in enumerate(works):
            if w is None:
                continue
            slot = self.slots[i]
            if i in discard:
                # post-completion speculative work: its token was
                # dropped in collect; resolve the slot the way the
                # earlier harvest decided
                if slot.eject_pending:
                    self._eject(i)
                elif slot.state == DRAIN:
                    self._finish(i)
                continue
            toks = [int(x) for x in emitted[i]]
            if isinstance(w, PrefillWork):
                if slot.stream is not None and toks and meta[i] is not None:
                    t_en = slot.req.enable_time(*meta[i])
                    if t_en is not None:
                        self.metrics.record_emit(
                            max(self.metrics.clock() - t_en, 0.0))
                if toks:
                    first = not slot.req.out_tokens
                    slot.req.out_tokens.extend(toks)
                    if first:
                        self.metrics.record_first_token(slot.req.rid)
                if not w.final:
                    continue
                if self.runner.autoregressive:
                    slot.last_token = slot.req.out_tokens[-1]
                    self._resolve_done(i)
                else:
                    self._finish(i)     # slot sat in DRAIN since dispatch
            else:
                token = toks[0]
                slot.req.out_tokens.append(token)
                slot.last_token = token
                self._resolve_done(i)
        # read-until verdicts surface after the tick's tokens are booked
        pop = getattr(self.runner, "pop_ejections", None)
        if pop is not None:
            for i in pop():
                s = self.slots[i]
                if s.state == FREE or s.req is None or s.req.done:
                    continue
                if self._inflight is not None \
                        and self._inflight[0][i] is not None:
                    # a newer window is in flight: discard it at its
                    # harvest, then eject
                    s.eject_pending = True
                    self._inflight[2].add(i)
                else:
                    self._eject(i)

    def _resolve_done(self, i: int) -> None:
        """Completion check at harvest: finish now, or — when a newer
        speculative tick for the slot is already in flight — park in
        DRAIN and discard that tick's output at its harvest."""
        slot = self.slots[i]
        if not slot.req.done:
            return
        if self._inflight is not None and self._inflight[0][i] is not None:
            slot.state = DRAIN
            self._inflight[2].add(i)
        else:
            self._finish(i)

    def run(self) -> Dict[int, Request]:
        """Drain queue + slots to completion; returns completed requests
        (only the most recent ``history_limit`` when bounded). Raises
        instead of spinning when progress is blocked on an unfinished
        StreamingRequest — streaming callers drive ``step()`` from their
        own loop, interleaved with ``append()``/``finish()``."""
        stalled = 0
        while self.busy:
            marker = (len(self.completed), self._admit_seq, len(self.queue),
                      self._inflight is not None,
                      tuple(s.pos for s in self.slots))
            self.step()
            now = (len(self.completed), self._admit_seq, len(self.queue),
                   self._inflight is not None,
                   tuple(s.pos for s in self.slots))
            stalled = stalled + 1 if now == marker else 0
            if stalled > self.n_slots + 1 and self._stalled_on_streams():
                raise RuntimeError(
                    "run() is stalled on unfinished StreamingRequests — "
                    "drive step() from your own loop and append()/"
                    "finish() the streams as samples arrive")
        return self.completed

    def _stalled_on_streams(self) -> bool:
        live = [s.req for s in self.slots if s.req is not None]
        live += list(self.queue)
        return any(getattr(r, "streaming", False)
                   and not getattr(r, "stream_finished", True) for r in live)

    def drain_completed(self,
                        status: Optional[str] = None) -> Dict[int, Request]:
        """Hand over and forget completed requests — the long-running
        serve loop's hook for keeping host memory flat. The map holds
        both ``finished`` requests and read-until ``ejected`` ones
        (partial bases!); check each request's ``status`` — or pass
        ``status='finished'``/``'ejected'`` to drain only that kind and
        leave the rest for a later drain."""
        if status is None:
            done, self.completed = self.completed, {}
            return done
        done = {rid: r for rid, r in self.completed.items()
                if r.status == status}
        for rid in done:
            del self.completed[rid]
        return done

    def reset_stats(self) -> None:
        """Fresh metrics + completed map for a new measurement pass over
        the SAME warm engine (benchmarks drain the same workload
        repeatedly; each pass should report itself). Slot history and
        admission sequencing intentionally keep accumulating — they
        describe the engine's lifetime, not one drain."""
        self.metrics = ServingMetrics(self.metrics.clock,
                                      max_samples=self.history_limit)
        self.completed = {}

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.state != FREE or not self.queue:
                continue
            req = self.queue[0]
            streaming = bool(getattr(req, "streaming", False))
            chunks = [] if streaming else self.runner.make_chunks(req)
            if not self.runner.alloc_pool(i, sum(c.n_units for c in chunks)):
                break                   # FIFO: no skipping the queue head
            self.queue.popleft()
            self.runner.admit(i, req)   # stage per-request device state
            slot.state = PREFILL
            slot.req = req
            slot.pos = 0
            slot.pending = chunks
            slot.fresh = True           # row invalidated by the 1st chunk
            slot.seq = self._admit_seq
            self._admit_seq += 1
            if streaming:
                resume = getattr(req, "_stream_resume", None)
                if resume is not None:  # preempted mid-stream: continue
                    slot.stream, row_state = resume
                    req._stream_resume = None
                    self.runner.restore_row(i, row_state)
                    slot.pos = slot.stream.consumed
                else:
                    slot.stream = StreamState(self.runner.open_stream(req))
            slot.emitted = len(req.out_tokens)  # resumes count prior tokens
            req.status = "running"
            self.slot_history[i].append(req.rid)
            self.metrics.record_admit(req.rid)

    def _pop_chunk(self, works: List[Optional[Any]], i: int) -> None:
        """Pop slot ``i``'s next pending chunk into ``works[i]`` — or,
        for a live stream, pull the next coverable window span from its
        cursor (``works[i]`` stays None when no new frames' receptive
        fields are covered by arrived samples yet)."""
        slot = self.slots[i]
        if slot.stream is not None:
            sw = slot.stream.cursor.next_work(slot.req)
            if sw is None:
                return
            slot.stream.need = sw.need
            slot.stream.needs_finish = sw.needs_finish
            works[i] = PrefillWork(sw.payload, sw.n_units, slot.pos,
                                   slot.fresh, sw.final, slot.req)
            return
        chunk = slot.pending.pop(0)
        works[i] = PrefillWork(chunk.payload, chunk.n_units, slot.pos,
                               slot.fresh, not slot.pending, slot.req)

    def _add_decode_works(self, works: List[Optional[Any]]) -> None:
        for i, s in enumerate(self.slots):
            if s.state == DECODE and works[i] is None:
                works[i] = DecodeWork(s.last_token, s.pos, s.req)

    def _add_decode_works_async(self, works: List[Optional[Any]]) -> None:
        """Async decode rows carry dispatch-time state: the sampling
        step index is the emit counter (out_tokens lags one tick), and
        a slot whose latest token is still in flight CHAINS — the step
        program substitutes the previous tick's on-device output. Slots
        that already dispatched their last allowed token (max_new)
        schedule nothing and finish at that token's harvest."""
        for i, s in enumerate(self.slots):
            if s.state != DECODE or works[i] is not None:
                continue
            if s.emitted >= s.req.sampling.max_new_tokens:
                continue
            if s.inflight_emit:
                works[i] = DecodeWork(0, s.pos, s.req, step=s.emitted,
                                      chained=True)
            else:
                works[i] = DecodeWork(s.last_token, s.pos, s.req,
                                      step=s.emitted)

    def _schedule(self, async_: bool = False) -> List[Optional[Any]]:
        """Build the unified tick's work list: every DECODE slot gets a
        DecodeWork; PREFILL slots get their next chunk oldest-admission-
        first until the cumulative payload reaches ``max_prefill_tokens``
        (soft cap — the crossing chunk still runs, so one chunk always
        progresses; 0 = no budget)."""
        works: List[Optional[Any]] = [None] * self.n_slots
        left = self.max_prefill_tokens or None
        order = sorted((i for i, s in enumerate(self.slots)
                        if s.state == PREFILL),
                       key=lambda i: self.slots[i].seq)
        for i in order:
            self._pop_chunk(works, i)
            if works[i] is None:        # stream with nothing coverable
                continue
            if left is not None:
                left -= works[i].n_units
                if left <= 0:
                    break
        if async_:
            self._add_decode_works_async(works)
        else:
            self._add_decode_works(works)
        return works

    def _run_works(self, works: List[Optional[Any]]) -> None:
        """One runner step over the work list + all host bookkeeping:
        emitted tokens, prefill/decode metrics, PREFILL->DECODE
        transitions, completions."""
        if not any(w is not None for w in works):
            return
        n_decode = sum(isinstance(w, DecodeWork) for w in works)
        t0 = self.metrics.clock()
        # sync: runner.step reads the tick's emitted tokens back to the
        # host — the engine's one intentional sync point per tick
        emitted = self.runner.step(works)
        dt = self.metrics.clock() - t0
        if n_decode:
            self.metrics.record_decode(n_decode, dt)
        for i, w in enumerate(works):
            if w is None:
                continue
            slot = self.slots[i]
            toks = [int(x) for x in emitted[i]]
            if isinstance(w, PrefillWork):
                slot.fresh = False
                slot.pos += w.n_units
                self.metrics.record_prefill(w.n_units)
                if slot.stream is not None:
                    slot.stream.consumed = slot.pos
                    if toks:    # sample-arrival -> base-emission latency
                        t_en = slot.req.enable_time(slot.stream.need,
                                                    slot.stream.needs_finish)
                        if t_en is not None:
                            self.metrics.record_emit(
                                max(self.metrics.clock() - t_en, 0.0))
                if toks:
                    first = not slot.req.out_tokens
                    slot.req.out_tokens.extend(toks)
                    if first:
                        self.metrics.record_first_token(slot.req.rid)
                if not w.final:
                    continue
                if self.runner.autoregressive:
                    # prompt fully cached: the final chunk emitted the
                    # next generated token (token #1 for fresh requests;
                    # the resume point after a preemption)
                    slot.last_token = slot.req.out_tokens[-1]
                    slot.state = DECODE
                    if slot.req.done:   # max_new_tokens reached (or EOS)
                        self._finish(i)
                else:
                    self._finish(i)     # reads end with their last chunk
            else:
                slot.pos += 1           # last_token now cached at pos
                token = toks[0]
                slot.req.out_tokens.append(token)
                slot.last_token = token
                if slot.req.done:
                    self._finish(i)
        # read-until verdicts surface after the tick's tokens are booked
        # (a read finishing this very tick wins over its ejection — its
        # _finish already reset the row, clearing the pending verdict)
        pop = getattr(self.runner, "pop_ejections", None)
        if pop is not None:
            for i in pop():
                s = self.slots[i]
                if s.state != FREE and s.req is not None and not s.req.done:
                    self._eject(i)

    def _ensure_decode_blocks(self) -> None:
        """Every DECODE slot writes position ``slot.pos`` this tick;
        allocate the covering block, preempting the youngest running
        request whenever the pool is dry. ``submit`` guarantees a lone
        request always fits, so this terminates with progress."""
        for i in range(self.n_slots):
            if self.slots[i].state != DECODE:
                continue
            if self.async_dispatch and self.slots[i].emitted >= \
                    self.slots[i].req.sampling.max_new_tokens:
                continue    # last token in flight: schedules nothing more
            # re-read slots[i] each pass: _preempt may replace it (even i)
            while self.slots[i].state == DECODE and \
                    not self.runner.alloc_pool(i, self.slots[i].pos + 1):
                if self._inflight is not None:
                    # flush the pipeline before preempting: harvesting
                    # books the in-flight tokens a resume re-prefills
                    # from, resolves DRAIN slots (freeing their rows —
                    # often enough by itself), and guarantees no
                    # speculative work targets the victim's row
                    self.flush()
                    continue
                victim = max(
                    (j for j, s in enumerate(self.slots) if s.state != FREE),
                    key=lambda j: self.slots[j].seq)
                self._preempt(victim)   # may be slot i itself

    def _preempt(self, i: int) -> None:
        """Evict a running request, free its pool row, and requeue it at
        the FRONT for resume-by-re-prefill (streams stash their cursor +
        the runner's row state and resume exactly where they left)."""
        slot = self.slots[i]
        req = slot.req
        if slot.stream is not None:     # export BEFORE the row resets
            req._stream_resume = (slot.stream, self.runner.export_row(i))
        self.runner.reset_row(i)
        req.status = "preempted-pending"
        self.metrics.record_preempt(req.rid)
        self.queue.appendleft(req)
        self.slots[i] = _Slot()

    def _finish(self, i: int) -> None:
        slot = self.slots[i]
        req = slot.req
        self.runner.reset_row(i)        # pool row back to the free lists
        req.status = "finished"
        self.metrics.record_done(req.rid, len(req.out_tokens))
        self._complete(req)
        self.slots[i] = _Slot()         # back to FREE; reset at next admit

    def _eject(self, i: int) -> None:
        """Read-until: the classifier rejected this read — flush the CTC
        merge's best-so-far bases, free the slot + any pool rows, and
        complete the request with status ``ejected`` (its out_tokens are
        the PARTIAL bases emitted before ejection)."""
        slot = self.slots[i]
        req = slot.req
        flush = getattr(self.runner, "flush_row", None)
        if flush is not None:           # beam merges emit only at flush
            req.out_tokens.extend(int(t) for t in flush(i))
        self.runner.reset_row(i)
        req.status = "ejected"
        arrived = (int(np.asarray(req.signal).size)
                   if req.signal is not None else 0)
        self.metrics.record_eject(req.rid, consumed=slot.pos,
                                  arrived=arrived)
        self._complete(req)
        self.slots[i] = _Slot()

    def _complete(self, req: Request) -> None:
        self.completed[req.rid] = req
        if self.history_limit:
            while len(self.completed) > self.history_limit:
                self.completed.pop(next(iter(self.completed)))
