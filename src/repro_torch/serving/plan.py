"""Bucketed tick-plan cache: one staged step program per (tick kind,
chunk width, sampling flavor) bucket, captured once as a CUDA graph on
a card and replayed every tick.

The port's counterpart of ``repro.serving.plan``, which compiles each
bucket once into its own ``jax.jit`` program (the carry donated) and
warms every one at launch. On Hopper the counterpart of one compiled
program per bucket is one ``torch.cuda.CUDAGraph`` per bucket: a tick
then costs a few input copies and one replay on the host, not one
Python dispatch per kernel.

Staged plans
------------
A plan is ``fn(*inputs) -> outputs``; ``inputs`` holds tensors, numpy
arrays, ``None`` and dicts of them, ``outputs`` is a tensor or a tuple
of tensors. A call (:meth:`PlanCache.warm` at warmup,
``PlanCache.lookup(key)(*inputs)`` at a tick) copies every input into a
static buffer on the cache's device that the plan owns (allocated at
its first call) and runs ``fn`` over those buffers:

- **graphed** (a CUDA device, ``graphs=True``, no ``eager_reason``):
  the first call runs ``fn`` once eagerly on a side stream, which
  builds the kernels, sets their shared-memory attributes and returns
  this call's outputs, then captures ``fn`` over the same buffers;
  every later call copies the inputs in and replays. All graphs of one
  cache share one memory pool: they replay one at a time, on one
  stream.
- **eager** otherwise (the CPU; eager plans on a card for comparison;
  a runner whose ticks cannot be captured names why in
  ``eager_reason``): ``fn`` runs over the buffers each call.

Either way the outputs are cloned before the call returns, so none
aliases a static buffer: tick N's results survive tick N+1's staging
and replay (the async engine dispatches N+1 before it reads N back).

A captured plan must not read a tensor's contents on the host (a sync
raises during capture), rebind a tensor it reads or writes (the graph
keeps the old address: caches update in place), or derive a launch
parameter from tensor contents (frozen at capture). Kernel launches
during a capture go to the plan's tally (``kernels/_build.tally``) and
each replay counts them, so ``ops.launch_counts`` reads the same under
graphs as eagerly.

Warmup, misses and retraces, as the reference's: ``warmup()``
(runner-side) runs every registered key through :meth:`PlanCache.warm`,
so no capture happens mid-traffic; ``require_warm`` makes a lookup of an
unwarmed key a :class:`PlanMissError`; a warmed key whose inputs arrive
with another shape, dtype or device is staged and captured again, which
``stats()["retraces"]`` counts. ``fn(key)`` is the raw eager callable
(the analyzer records through it).

Bucket rounding rule
--------------------
``chunk_buckets(C)`` is the powers of two below ``C`` plus ``C``
itself (C=16 -> 1, 2, 4, 8, 16), and ``round_chunk(n)`` rounds a tick's
widest chunk up to the next bucket, so every schedulable tick shape maps
to a registered bucket (the trace-stability rule audits this closure).
"""
from __future__ import annotations

import functools
import gc
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

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
    """A tick needed a plan that was never registered, or (under
    ``require_warm``) one that warmup did not stage and capture: a
    mid-traffic capture is a hard error, not a stall."""


def _map(fn: Callable, inputs: Sequence) -> Tuple:
    """``fn`` over every array leaf of ``inputs`` (items and dict
    values), ``None`` kept."""
    def one(a):
        if isinstance(a, dict):
            return {k: one(v) for k, v in a.items()}
        return None if a is None else fn(a)
    return tuple(one(a) for a in inputs)


def _leaves(tree) -> List:
    if isinstance(tree, (tuple, list)):
        return [x for a in tree for x in _leaves(a)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def _signature(inputs: Sequence) -> Tuple:
    def sig(a):
        if isinstance(a, dict):
            return tuple((k, sig(v)) for k, v in sorted(a.items()))
        if a is None:
            return None
        a = _tensor(a)
        return (tuple(a.shape), a.dtype, a.device.type)
    return tuple(sig(a) for a in inputs)


class _Staged:
    """One key's static input buffers, and on a card its graph, static
    outputs and the launches its capture recorded."""

    def __init__(self, sig: Tuple, bufs: Tuple) -> None:
        self.sig = sig
        self.bufs = bufs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outs: Any = None
        self.tally: _build.Tally = {}


class PlanCache:
    """Registry of per-bucket staged step programs with hit/miss,
    retrace and graph accounting (see the module docstring).

    ``device``: where the static buffers live (the CPU by default);
    ``graphs``: capture each plan as a CUDA graph when ``device`` is a
    card; ``eager_reason``: why this runner's plans stay eager on a card
    (shown in :meth:`stats`)."""

    def __init__(self, device=None, *, graphs: bool = True,
                 eager_reason: Optional[str] = None) -> None:
        self.device = torch.device(device if device is not None else "cpu")
        self.eager_reason = eager_reason
        self.graphed = (graphs and self.device.type == "cuda"
                        and eager_reason is None)
        self._fns: Dict[PlanKey, Callable] = {}
        self._staged: Dict[PlanKey, _Staged] = {}
        self._warmed: set = set()
        self._pool = None                       # the graphs' memory pool
        self.hits = 0
        self.misses = 0
        self.retraces = 0
        self.require_warm = False
        self.calls: Dict[PlanKey, int] = {}     # tick lookups per key

    # ------------------------------------------------------------ build
    def register(self, key: PlanKey, fn: Callable) -> None:
        if key in self._fns:
            raise ValueError(f"plan {key} registered twice")
        self._fns[key] = fn

    def keys(self) -> List[PlanKey]:
        return list(self._fns)

    def __contains__(self, key: PlanKey) -> bool:
        return key in self._fns

    def fn(self, key: PlanKey) -> Callable:
        """Raw access to a plan's eager callable (analysis)."""
        return self._fns[key]

    def mark_warmed(self, key: PlanKey) -> None:
        self._warmed.add(key)

    @property
    def warmed(self) -> int:
        return len(self._warmed)

    def warm(self, key: PlanKey, *inputs) -> Any:
        """Stage ``inputs`` and run the plan once (capturing it on a
        card), outside the tick accounting; the key is warmed."""
        out = self._run(key, inputs)
        self._warmed.add(key)
        return out

    # ------------------------------------------------------------- tick
    def lookup(self, key: PlanKey) -> Callable:
        """Tick-time plan access with bucket accounting: the staged
        plan, called with the tick's inputs."""
        if key not in self._fns:
            raise PlanMissError(
                f"no plan registered for tick bucket {key}; registered: "
                f"{sorted(self._fns)}")
        self.calls[key] = self.calls.get(key, 0) + 1
        if key in self._warmed:
            self.hits += 1
        else:
            self.misses += 1
            if self.require_warm:
                raise PlanMissError(
                    f"plan {key} invoked before warmup — this tick would "
                    f"stage and capture mid-traffic (run warmup(), or clear "
                    f"require_warm to allow a lazy first use)")
            self._warmed.add(key)       # staged by this call: later uses hit
        return functools.partial(self._call, key)

    def _call(self, key: PlanKey, *inputs) -> Any:
        return self._run(key, inputs)

    def _run(self, key: PlanKey, inputs: Tuple) -> Any:
        st = self._staged.get(key)
        sig = _signature(inputs)
        if st is not None and st.sig == sig:
            self._copy_in(st, inputs)
            if st.graph is None:
                return _clone(self._fns[key](*st.bufs))
            st.graph.replay()
            _build.replay_launches(st.tally)
            return _clone(st.outs)
        if st is not None:
            self.retraces += 1          # a warmed key, staged again
        dev = self.device
        st = self._staged[key] = _Staged(sig, _map(
            lambda a: torch.empty_like(_tensor(a), device=dev), inputs))
        self._copy_in(st, inputs)
        if not self.graphed:
            return _clone(self._fns[key](*st.bufs))
        return self._capture(key, st)

    @staticmethod
    def _copy_in(st: _Staged, inputs: Tuple) -> None:
        for buf, a in zip(_leaves(st.bufs), _leaves(inputs)):
            if buf is not None:
                buf.copy_(_tensor(a), non_blocking=True)

    def _capture(self, key: PlanKey, st: _Staged) -> Any:
        """The eager pass on a side stream (this call's outputs), then
        the capture over the same buffers."""
        fn = self._fns[key]
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*st.bufs)
        cur.wait_stream(side)
        for o in _leaves(out):
            if o is not None:
                o.record_stream(cur)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # a cyclic collection inside the capture could destroy another
        # graph, a CUDA call that invalidates this capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _build.tally() as launched:
                with torch.cuda.graph(graph, pool=self._pool):
                    st.outs = fn(*st.bufs)
        finally:
            if collecting:
                gc.enable()
        st.graph, st.tally = graph, launched
        return out

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, Any]:
        """The reference's ``{plans, warmed, bucket_hits, bucket_misses,
        retraces}``, the captured ``graphs``, and ``eager_reason`` when
        the runner keeps its plans eager on a card."""
        out: Dict[str, Any] = {
            "plans": len(self._fns), "warmed": len(self._warmed),
            "bucket_hits": self.hits, "bucket_misses": self.misses,
            "retraces": self.retraces,
            "graphs": sum(st.graph is not None
                          for st in self._staged.values())}
        if self.eager_reason is not None:
            out["eager_reason"] = self.eager_reason
        return out


def _clone(out: Any) -> Any:
    if out is None:
        return None
    if isinstance(out, tuple):
        return tuple(o.clone() for o in out)
    return out.clone()
