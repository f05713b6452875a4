"""ModelRunner protocol + registry: the serving engine's model backend.

The engine (``repro_torch.serving.engine``) is pure host-side
scheduling — queue, slots, admission, preemption, metrics. Everything
model-shaped lives behind a :class:`ModelRunner`:

``validate``       submit-time payload checks (raise ValueError)
``make_chunks``    split a request's payload into prefill chunks
``admit``          stage per-request state into a slot
``alloc_pool``     back payload positions ``[0, upto)`` with pool blocks
``step``           run ONE co-batched tick over a per-slot work list of
                   :class:`PrefillWork` / :class:`DecodeWork` entries;
                   returns the tokens each slot commits
``dispatch``/      the async split of ``step``: ``dispatch`` enqueues
``collect``        the tick's device work and returns a handle with the
                   results still on the device; ``collect`` is the
                   deferred readback (plus host-side merge work).
                   ``step == collect(dispatch(works))`` exactly.
``warmup``         run every tick plan once at launch; ``plan_stats``
                   reports the bucket hit/miss counters
``reset_row``      release a slot's per-slot runner state

Registered here: :class:`BasecallerRunner` (squiggle in, bases out).
The token runners come with the LM slices; streaming and read-until
with the streaming slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import PackedTensor, tree_map
from repro_torch.models.basecaller import ctc
from repro_torch.models.basecaller import model as bc
from repro_torch.serving.plan import PlanCache


class Chunk(NamedTuple):
    """One prefill unit: an opaque payload + how many logical positions
    it advances a slot (tokens for LMs, squiggle samples for reads)."""
    payload: Any
    n_units: int


class PrefillWork(NamedTuple):
    """One scheduled prompt chunk for one slot in a unified tick."""
    payload: Any                # one Chunk's payload
    n_units: int                # logical positions the chunk advances
    pos: int                    # positions already consumed before it
    fresh: bool                 # first chunk: invalidate the slot's row
    final: bool                 # last chunk of the payload
    req: Any                    # repro_torch.serving.engine.Request


class DecodeWork(NamedTuple):
    """One scheduled lockstep decode token for one slot (``step`` is
    the sampling step at dispatch, -1 = ``len(req.out_tokens)``;
    ``chained`` marks a token still in flight from the previous tick)."""
    last_token: int
    pos: int
    req: Any
    step: int = -1
    chained: bool = False


# ---------------------------------------------------------------------------
# Protocol


class ModelRunner:
    """Duck-typed base for serving backends (see the module docstring
    for the contract). The engine only ever touches these members."""

    autoregressive: bool = True
    pool = None                         # cache pool or None
    supports_streaming: bool = False    # accepts StreamingRequest payloads
    supports_async: bool = False        # dispatch/collect pipeline the tick

    def validate(self, req) -> None:
        raise NotImplementedError

    def make_chunks(self, req) -> List[Chunk]:
        raise NotImplementedError

    def admit(self, slot: int, req) -> None:
        pass

    def alloc_pool(self, slot: int, upto: int) -> bool:
        return True

    def reset_row(self, slot: int) -> None:
        pass

    def pool_util(self) -> float:
        return 0.0

    # ---- streaming hooks (no port runner streams yet) ----
    def open_stream(self, req):
        raise NotImplementedError(
            f"{type(self).__name__} does not serve StreamingRequests")

    def export_row(self, slot: int):
        return None

    def restore_row(self, slot: int, state) -> None:
        pass

    def step(self, works: List[Optional[Any]]) -> List[List[int]]:
        """Run one co-batched tick; ``works`` has one entry per slot (a
        :class:`PrefillWork`, a :class:`DecodeWork`, or None)."""
        raise NotImplementedError

    def dispatch(self, works: List[Optional[Any]]) -> Any:
        return works

    def collect(self, handle: Any,
                discard: frozenset = frozenset()) -> List[List[int]]:
        """Deferred readback for a ``dispatch`` handle; ``discard``
        slots' tokens (post-completion speculative work) are dropped."""
        emitted = self.step(handle)
        return [[] if i in discard else toks
                for i, toks in enumerate(emitted)]

    def warmup(self) -> int:
        return 0

    def plan_stats(self) -> Dict[str, int]:
        return {}


def _device_of(tree) -> torch.device:
    for v in tree.values():
        if isinstance(v, dict):
            return _device_of(v)
        return (v.data if isinstance(v, PackedTensor) else v).device
    raise ValueError("empty parameter tree")


class BasecallerRunner(ModelRunner):
    """Serve nanopore reads through the CTC basecaller.

    A read's squiggle streams through fixed-size halo-padded windows;
    each window's core frames feed an incremental CTC merge. With the
    read-edge masking of ``repro_torch.models.basecaller.model`` the
    concatenated core frames equal the whole-read forward's, so greedy
    serving output == offline ``greedy_decode`` (near-exact for
    act-quantized configs like rubicall, whose activation scales see
    the window, not the read). ``beam > 0`` switches to the incremental
    prefix-beam merge, emitting the read when it completes.

    Reads are not autoregressive: no decode phase, no KV pool, never
    preempted; a read finishes with its final chunk.

    A tick batches EVERY slot's window into one ``(n_slots, W, 1)``
    forward on ``device`` (idle rows are zero windows with
    ``read_len == 0``). ``dispatch`` moves windows and bounds to the
    device and enqueues the forward; ``collect`` is the only readback.

    Payload contract: ``(window, f_lo, f_hi, start, read_len)`` — core
    frames ``[f_lo, f_hi)`` feed the merge; ``start``/``read_len`` are
    the read-edge mask bounds.
    """

    autoregressive = False
    pool = None
    supports_async = True

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int,
                 chunk_samples: int = 1024, beam: int = 0,
                 model_state=None, device=None, **_):
        self.params = params
        self.cfg = cfg
        self.device = (torch.device(device) if device is not None
                       else _device_of(params))
        self.n_slots = int(n_slots)
        self.stride = bc.total_stride(cfg)
        self.halo = bc.chunk_halo(cfg)
        self.core = max(-(-int(chunk_samples) // self.stride), 1) * self.stride
        self.beam = int(beam)
        state = model_state if model_state is not None else bc.init_state(cfg)
        self.state = tree_map(lambda t: t.to(self.device), state)
        self._merge: List[Optional[Any]] = [None] * self.n_slots

        def fwd(p, s, w, start, read_len):
            return bc.forward_window(p, s, w, cfg, start, read_len)
        # one window geometry -> one plan
        self._plan_key = ("window", self.core + 2 * self.halo, "fwd")
        self.plans = PlanCache()
        self.plans.register(self._plan_key, fwd)

    def plan_stats(self) -> Dict[str, int]:
        return self.plans.stats()

    def _forward(self, fwd, wins, start, read_len) -> torch.Tensor:
        dev = self.device
        with torch.inference_mode():
            return fwd(self.params, self.state,
                       torch.from_numpy(wins).to(dev),
                       torch.from_numpy(start).to(dev),
                       torch.from_numpy(read_len).to(dev))

    def warmup(self) -> int:
        """Run the window forward once on an all-idle tick (zero windows,
        ``read_len == 0``); nothing is fed to a merge."""
        B, W = self.n_slots, self.core + 2 * self.halo
        self._forward(self.plans.fn(self._plan_key),
                      np.zeros((B, W, 1), np.float32),
                      np.zeros((B,), np.int32), np.zeros((B,), np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.plans.mark_warmed(self._plan_key)
        return 1

    # ------------------------------------------------------------ intake
    def validate(self, req) -> None:
        if req.signal is None:
            raise ValueError(
                f"request {req.rid}: basecaller serving needs a `signal` "
                f"payload (1-D float squiggle)")
        if np.asarray(req.signal).size < 1:
            raise ValueError(f"request {req.rid}: empty signal")

    def make_chunks(self, req) -> List[Chunk]:
        sig = np.asarray(req.signal, np.float32).reshape(-1)
        wins = bc.chunk_windows(sig, self.core, self.halo, self.stride)
        return [Chunk((w, 0, nf, k * self.core - self.halo, sig.shape[0]),
                      ns)
                for k, (w, nf, ns) in enumerate(wins)]

    def admit(self, slot: int, req) -> None:
        self._merge[slot] = (ctc.BeamCTCMerge(self.beam) if self.beam
                             else ctc.GreedyCTCMerge())

    def reset_row(self, slot: int) -> None:
        self._merge[slot] = None

    # ------------------------------------------------------------ device
    def step(self, works: List[Optional[Any]]) -> List[List[int]]:
        return self.collect(self.dispatch(works))

    def dispatch(self, works: List[Optional[Any]]) -> Any:
        """Enqueue the tick's batched window forward; the log-probs stay
        on the device until ``collect``."""
        B = self.n_slots
        W = self.core + 2 * self.halo
        wins = np.zeros((B, W, 1), np.float32)
        start = np.zeros((B,), np.int32)
        read_len = np.zeros((B,), np.int32)     # 0 = idle row: all masked
        for i, w in enumerate(works):
            if w is None:
                continue
            window, _, _, st, rl = w.payload
            wins[i] = window
            start[i] = st
            read_len[i] = rl
        fwd = self.plans.lookup(self._plan_key)
        return works, self._forward(fwd, wins, start, read_len)

    def collect(self, handle: Any,
                discard: frozenset = frozenset()) -> List[List[int]]:
        """Deferred readback + host-side CTC merge. ``discard`` rows are
        dropped before the merge sees them."""
        works, dev = handle
        # sync: the CTC merge is host-side by design — every basecall
        # tick reads the window's log-probs back
        lp = dev.cpu().numpy()
        f0 = self.halo // self.stride
        out: List[List[int]] = []
        for i, w in enumerate(works):
            if w is None or i in discard:
                out.append([])
                continue
            _, f_lo, f_hi, _, _ = w.payload
            core = lp[i, f0 + f_lo:f0 + f_hi]
            merge = self._merge[i]
            toks = merge.feed(core if self.beam
                              else np.argmax(core, axis=-1))
            if w.final:
                toks = toks + merge.finalize()
            out.append(toks)
        return out


# ---------------------------------------------------------------------------
# Registry


_RUNNERS: List[Tuple[str, Callable[[ModelConfig], bool], Callable]] = []


def register_runner(name: str, predicate: Callable[[ModelConfig], bool],
                    factory: Callable) -> None:
    """Register a serving backend: first predicate match wins."""
    _RUNNERS.append((name, predicate, factory))


def runner_name_for(cfg: ModelConfig) -> Optional[str]:
    for name, pred, _ in _RUNNERS:
        if pred(cfg):
            return name
    return None


def make_runner(params, cfg: ModelConfig, **kw):
    """Build the registered runner for this config. Engine kwargs that a
    runner does not consume are ignored by that runner."""
    for name, pred, factory in _RUNNERS:
        if pred(cfg):
            return factory(params, cfg, **kw)
    raise NotImplementedError(
        f"no serving runner registered for {cfg.name} (family="
        f"{cfg.family!r}); registered: {[n for n, _, _ in _RUNNERS]}")


register_runner("basecaller", lambda cfg: cfg.family == "basecaller",
                BasecallerRunner)
