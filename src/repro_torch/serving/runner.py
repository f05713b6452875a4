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
``warmup``         stage every tick plan once at launch (on a card:
                   capture it as a CUDA graph); ``plan_stats`` reports
                   the bucket hit/miss, retrace and graph counters
``reset_row``      release a slot's per-slot runner state
``open_stream``    build the cursor that feeds a live
                   :class:`repro_torch.serving.stream.StreamingRequest`
``export_row``/    stash and restore a slot's runner state across a
``restore_row``    preemption (a live stream resumes where it left)
``flush_row``/     read-until: a slot's last bases, and the slots its
``pop_ejections``  classifier rejected this tick (basecaller only)

Registered here: :class:`BasecallerRunner` (squiggle in, bases out;
offline reads and live streams, with read-until ejection),
:class:`EncoderPrefixRunner` (the audio family: encoder K/V staged per
slot at admission, decoder tokens as :class:`TokenRunner` schedules
them) and :class:`TokenRunner` (token-only LMs over the paged KV pool,
per-request sampling). The vlm family has no runner, as in the
reference.

Tick plans (:mod:`repro_torch.serving.plan`): each runner stages a
tick's host inputs into static device buffers its plans own, and on a
card every plan is captured once as a CUDA graph at ``warmup()`` and
replayed each tick (``graphs=False`` keeps them eager, for comparison).
Caches, the previous tick's tokens and the encoder buffers update in
place and are never rebound, so a graph keeps reading the live tensors.
A MoE block's routing stays on the device at fixed shapes
(``moe._routed``), so MoE runners capture like the others.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import PackedTensor, tree_map
from repro_torch.models.basecaller import classifier as rc
from repro_torch.models.basecaller import ctc
from repro_torch.models.basecaller import model as bc
from repro_torch.serving.cache import CachePool
from repro_torch.serving.plan import PlanCache, chunk_buckets, round_chunk
from repro_torch.serving.sampling import any_sampled, pack_rows, sample_tokens


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

    # ---- streaming hooks (runners with ``supports_streaming``) ----
    def open_stream(self, req):
        raise NotImplementedError(
            f"{type(self).__name__} does not serve StreamingRequests "
            f"(only runners with supports_streaming do)")

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

    def plan_stats(self) -> Dict[str, Any]:
        return {}


def readback(*tensors) -> List[np.ndarray]:
    """The tick's device results on the host behind ONE synchronisation:
    every copy is enqueued before the stream is waited on."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    if tensors[0].is_cuda:
        torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


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

    Reads are not autoregressive: no decode phase, no KV pool
    (``alloc_pool`` always succeeds, so the engine never preempts a read
    for blocks); a read finishes with its final chunk, or is ejected.

    A tick batches EVERY slot's window into one ``(n_slots, W, 1)``
    forward on ``device`` (idle rows are zero windows with
    ``read_len == 0``). ``dispatch`` stages windows and bounds into the
    plan's buffers and enqueues the forward (a graph replay on a card);
    ``collect`` is the only readback.

    Payload contract: ``(window, f_lo, f_hi, start, read_len,
    classify)`` — the window's core frames ``[f_lo, f_hi)`` feed the
    merge (offline chunks always span the full window; streaming spans
    only the newly stable frames under the latency QoS), ``start`` /
    ``read_len`` are the read-edge mask bounds (``read_len`` is the
    :data:`repro_torch.serving.stream.UNBOUNDED` sentinel while a
    stream's end is unknown), and ``classify`` marks windows the
    read-until classifier scores.

    Streaming (``supports_streaming``): :class:`StreamingRequest`
    payloads skip ``make_chunks`` — the engine pulls works from the
    :class:`repro_torch.serving.stream.StreamCursor` built by
    :meth:`open_stream`; ``qos`` picks eager per-frame flushing
    (``"latency"``) or once-per-window forwards (``"accuracy"``).

    Read-until (``read_until=ReadUntil(...)``): the start-of-read
    classifier runs in the same tick plan, on the same device and
    windows (the plan returns ``(log_probs, on-target logits)``;
    ``collect`` reads both back behind one synchronisation). The host
    accumulates each read's logit over its first ``eject_after_chunks``
    fully covered windows and flags the slot for ejection when the mean
    falls below ``threshold``; the engine collects the flags via
    :meth:`pop_ejections` after booking the tick's bases.
    """

    autoregressive = False
    pool = None
    supports_streaming = True
    supports_async = True

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int,
                 chunk_samples: int = 1024, beam: int = 0,
                 model_state=None, qos: str = "accuracy", read_until=None,
                 device=None, graphs: bool = True, **_):
        self.params = params
        self.cfg = cfg
        self.device = (torch.device(device) if device is not None
                       else _device_of(params))
        self.n_slots = int(n_slots)
        self.stride = bc.total_stride(cfg)
        self.halo = bc.chunk_halo(cfg)
        self.core = max(-(-int(chunk_samples) // self.stride), 1) * self.stride
        self.beam = int(beam)
        self.qos = qos
        state = model_state if model_state is not None else bc.init_state(cfg)
        self.state = tree_map(lambda t: t.to(self.device), state)
        self._merge: List[Optional[Any]] = [None] * self.n_slots
        # read-until bookkeeping: per-slot logit accumulator + verdicts
        self._cls_sum = np.zeros((self.n_slots,), np.float64)
        self._cls_n = np.zeros((self.n_slots,), np.int64)
        self._cls_decided = [False] * self.n_slots
        self._eject_pending: set = set()
        self.read_until = read_until
        if read_until is not None:
            # the classifier runs where the forward runs, never beside it
            # on another device
            cls_params = {k: v.to(self.device)
                          for k, v in read_until.params.items()}
            self.read_until = dataclasses.replace(read_until,
                                                  params=cls_params)
        dev = self.device

        def fwd(w, start, read_len):
            """(B, W, 1) windows and (B,) bounds -> log-probs (and the
            classifier's logits), the inputs moved to the device (a
            no-op for the plan's staged buffers)."""
            w, start, read_len = (torch.as_tensor(a).to(dev, non_blocking=True)
                                  for a in (w, start, read_len))
            with torch.inference_mode():
                lp = bc.forward_window(self.params, self.state, w, cfg, start,
                                       read_len)
                if read_until is None:
                    return lp
                return lp, rc.forward(self.read_until.params, w)
        # one window geometry -> one plan
        self._plan_key = ("window", self.core + 2 * self.halo, "fwd")
        self.plans = PlanCache(dev, graphs=graphs)
        self.plans.register(self._plan_key, fwd)

    def plan_stats(self) -> Dict[str, Any]:
        return self.plans.stats()

    def warmup(self) -> int:
        """Stage the window forward on an all-idle tick (zero windows,
        ``read_len == 0``; on a card, capture it); nothing is fed to a
        merge."""
        B, W = self.n_slots, self.core + 2 * self.halo
        self.plans.warm(self._plan_key, np.zeros((B, W, 1), np.float32),
                        np.zeros((B,), np.int32), np.zeros((B,), np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return 1

    # ------------------------------------------------------------ intake
    def validate(self, req) -> None:
        if getattr(req, "streaming", False):
            return                      # samples arrive later via append()
        if req.signal is None:
            raise ValueError(
                f"request {req.rid}: basecaller serving needs a `signal` "
                f"payload (1-D float squiggle)")
        if np.asarray(req.signal).size < 1:
            raise ValueError(f"request {req.rid}: empty signal")

    def make_chunks(self, req) -> List[Chunk]:
        sig = np.asarray(req.signal, np.float32).reshape(-1)
        wins = bc.chunk_windows(sig, self.core, self.halo, self.stride)
        K = self._classify_chunks()
        return [Chunk((w, 0, nf, k * self.core - self.halo, sig.shape[0],
                       int(k < K)), ns)
                for k, (w, nf, ns) in enumerate(wins)]

    def _classify_chunks(self) -> int:
        return self.read_until.eject_after_chunks if self.read_until else 0

    def admit(self, slot: int, req) -> None:
        self._merge[slot] = (ctc.BeamCTCMerge(self.beam) if self.beam
                             else ctc.GreedyCTCMerge())
        self._clear_verdict(slot)

    def _clear_verdict(self, slot: int) -> None:
        self._cls_sum[slot] = 0.0
        self._cls_n[slot] = 0
        self._cls_decided[slot] = False

    def open_stream(self, req):
        # local: stream.py imports the engine, which imports this module
        from repro_torch.serving.stream import StreamCursor
        return StreamCursor(self.core, self.halo, self.stride, qos=self.qos,
                            classify_chunks=self._classify_chunks())

    # ------------------------------------------------------------- rows
    def reset_row(self, slot: int) -> None:
        self._merge[slot] = None
        self._clear_verdict(slot)
        self._eject_pending.discard(slot)

    def export_row(self, slot: int):
        """Preemption stash: the merge (cloned — ``feed`` mutates it in
        place) plus the read-until accumulator."""
        merge = self._merge[slot]
        return (merge.clone() if merge is not None else None,
                float(self._cls_sum[slot]), int(self._cls_n[slot]),
                self._cls_decided[slot])

    def restore_row(self, slot: int, state) -> None:
        merge, cls_sum, cls_n, decided = state
        self._merge[slot] = merge
        self._cls_sum[slot] = cls_sum
        self._cls_n[slot] = cls_n
        self._cls_decided[slot] = decided

    def flush_row(self, slot: int) -> List[int]:
        merge = self._merge[slot]
        return list(merge.finalize()) if merge is not None else []

    def pop_ejections(self) -> List[int]:
        out = sorted(self._eject_pending)
        self._eject_pending.clear()
        return out

    # ------------------------------------------------------------ device
    def step(self, works: List[Optional[Any]]) -> List[List[int]]:
        return self.collect(self.dispatch(works))

    def dispatch(self, works: List[Optional[Any]]) -> Any:
        """Enqueue the tick's batched window forward; the log-probs (and
        the classifier's logits) stay on the device until ``collect``."""
        B = self.n_slots
        W = self.core + 2 * self.halo
        wins = np.zeros((B, W, 1), np.float32)
        start = np.zeros((B,), np.int32)
        read_len = np.zeros((B,), np.int32)     # 0 = idle row: all masked
        for i, w in enumerate(works):
            if w is None:
                continue
            window, _, _, st, rl, _ = w.payload
            wins[i] = window
            start[i] = st
            read_len[i] = rl
        return works, self.plans.lookup(self._plan_key)(wins, start,
                                                        read_len)

    def collect(self, handle: Any,
                discard: frozenset = frozenset()) -> List[List[int]]:
        """Deferred readback + host-side CTC merge and read-until verdict.
        ``discard`` rows (post-completion or post-ejection speculative
        windows under the async engine) are dropped before the merge and
        the classifier see them, so an ejected read's bases match the
        synchronous engine exactly."""
        works, dev = handle
        if self.read_until is None:
            dev = (dev,)
        # sync: the CTC merge and the read-until verdict are host-side by
        # design — one readback per tick covers both
        lp, *cls = readback(*dev)
        cls = cls[0] if cls else None
        f0 = self.halo // self.stride
        out: List[List[int]] = []
        for i, w in enumerate(works):
            if w is None or i in discard:
                out.append([])
                continue
            _, f_lo, f_hi, _, _, classify = w.payload
            core = lp[i, f0 + f_lo:f0 + f_hi]
            merge = self._merge[i]
            toks = merge.feed(core if self.beam
                              else np.argmax(core, axis=-1))
            if w.final:
                toks = toks + merge.finalize()
            out.append(toks)
            if cls is not None and classify and not self._cls_decided[i]:
                self._cls_sum[i] += float(cls[i])
                self._cls_n[i] += 1
                ru = self.read_until
                if self._cls_n[i] >= ru.eject_after_chunks:
                    self._cls_decided[i] = True
                    if self._cls_sum[i] / self._cls_n[i] < ru.threshold:
                        self._eject_pending.add(i)
        return out


# ---------------------------------------------------------------------------
# TokenRunner — token-only archs over the paged KV pool


class TokenRunner(ModelRunner):
    """Drives ``transformer.decode_step_slots`` over a paged
    :class:`CachePool`, with per-request sampling, in two tick shapes:

    - decode-only ticks run the lockstep ``(B, 1)`` plans: pure argmax
      when every live row is greedy, the sampler otherwise;
    - mixed ticks (any prefill work) run one ``(B, C)`` plan: decode rows
      in column 0, prefill rows with up to C chunk tokens, a per-row
      ``fresh`` vector that recycles newly admitted slots in the step,
      and ``logits_at`` unembedding each row at its emitting column. C
      is the widest chunk rounded up to its bucket (powers of two and
      the full ``prefill_chunk``).

    ``attn_backend`` (``auto``/``gather``/``cuda``) picks the attention
    read path (``repro_torch.kernels.ops.decode_gqa``); ``auto`` is the
    CUDA kernels on a card. Inputs are built on the host each tick and
    staged into the plan's device buffers (the block tables too, copied
    from ``pool.host_tables()``); the pool's arenas update in place.

    Async dispatch: ``dispatch`` enqueues the tick and returns with the
    tokens on the device; ``collect`` reads them back. A ``chained``
    decode row's input token is the previous tick's on-device output
    (``chain``; ``_prev_tokens``, a device buffer the plans read and
    each tick fills in place), so the pipeline needs no readback in
    between.
    """

    autoregressive = True
    supports_async = True

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int,
                 cache_len: int, prefill_chunk: int, cache_dtype,
                 block_len: int = 0, n_blocks: int = 0,
                 attn_backend: str = "auto", quant_policy=None,
                 device=None, graphs: bool = True, _check: bool = True,
                 **_):
        from repro_torch.models.lm import transformer as tfm
        if _check and not tfm.supports_slot_serving(cfg):
            raise NotImplementedError(
                f"TokenRunner serves token-only archs whose block kinds are "
                f"ported ({tfm.SLOT_KINDS}); {cfg.name} has family="
                f"{cfg.family!r}")
        self._tfm = tfm
        self.params = params
        self.cfg = cfg
        self.device = (torch.device(device) if device is not None
                       else _device_of(params))
        self.n_slots = int(n_slots)
        self.cache_len = int(cache_len)
        self.chunk_tokens = int(prefill_chunk)
        self.pool = CachePool(cfg, n_slots, cache_len, cache_dtype,
                              block_len=block_len, n_blocks=n_blocks,
                              attn_backend=attn_backend,
                              quant_policy=quant_policy, device=self.device)
        self.attn_backend = self.pool.attn_backend       # resolved
        self.layers = tfm.param_layer_views(params, cfg)
        self.buckets = chunk_buckets(self.chunk_tokens)
        self.plans = PlanCache(self.device, graphs=graphs)
        for flavor in ("greedy", "sampled"):
            self.plans.register(("decode", 1, flavor),
                                self._plan(mixed=False,
                                           sampled=flavor == "sampled"))
            for w in self.buckets:
                self.plans.register(("mixed", w, flavor),
                                    self._plan(mixed=True,
                                               sampled=flavor == "sampled"))
        # the previous tick's on-device tokens (B,): chained rows' input
        self._prev_tokens = torch.zeros((self.n_slots,), dtype=torch.int32,
                                        device=self.device)
        # per-slot encoder K/V of the xdec groups (EncoderPrefixRunner)
        self.enc_kv: Optional[Dict[str, Dict[str, torch.Tensor]]] = None

    def _plan(self, *, mixed: bool, sampled: bool) -> Callable:
        """One tick program: (tok, t, chain, fresh, last, tables, sp) ->
        (B,) int32 tokens on the device (``fresh``/``last`` are None on
        decode-only ticks, ``sp`` on greedy ones; ``tables`` {group: (B,
        T)}). The inputs move to the device here, a no-op for the plan's
        staged buffers."""
        cfg, tfm, pool, dev = self.cfg, self._tfm, self.pool, self.device

        def to_dev(a):
            return torch.as_tensor(a).to(dev, non_blocking=True)

        def step(tok, t, chain, fresh, last, tables, sp):
            with torch.inference_mode():
                tok_d = to_dev(tok)
                col0 = torch.where(to_dev(chain) > 0, self._prev_tokens,
                                   tok_d[:, 0])
                tok_d = torch.cat([col0[:, None], tok_d[:, 1:]], dim=1)
                if mixed:
                    pool.mask_fresh_rows(pool.caches, to_dev(fresh))
                logits, _ = tfm.decode_step_slots(
                    self.params, pool.caches, tok_d, to_dev(t), cfg,
                    logits_at=None if last is None else to_dev(last),
                    tables={g: to_dev(tb) for g, tb in tables.items()},
                    attn_backend=self.attn_backend, layers=self.layers,
                    enc_kv=self.enc_kv)
                logits = logits[:, 0, :]
                if sampled:
                    return sample_tokens(logits, {k: to_dev(v)
                                                  for k, v in sp.items()})
                return torch.argmax(logits, dim=-1).to(torch.int32)
        return step

    def plan_stats(self) -> Dict[str, Any]:
        return self.plans.stats()

    def warmup(self) -> int:
        """Stage every plan once over an all-pad tick (``t = -1``:
        nothing is written, so the pool is unchanged); on a card each is
        captured as a CUDA graph."""
        B = self.n_slots
        sp = pack_rows([None] * B)
        warmed = 0
        for key in self.plans.keys():
            kind, w, flavor = key
            if kind not in ("decode", "mixed"):
                continue
            tok = torch.zeros((B, w), dtype=torch.int32)
            t = torch.full((B, w), -1, dtype=torch.int32)
            zeros = torch.zeros((B,), dtype=torch.int32)
            mixed = kind == "mixed"
            self.plans.warm(key, tok, t, zeros, zeros if mixed else None,
                            zeros if mixed else None, self.pool.host_tables(),
                            sp if flavor == "sampled" else None)
            warmed += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return warmed

    # ------------------------------------------------------------ intake
    def validate(self, req) -> None:
        if getattr(req, "streaming", False):
            raise ValueError(
                f"request {req.rid}: {type(self).__name__} cannot serve a "
                f"StreamingRequest (token prompts arrive whole)")
        if req.signal is not None:
            raise ValueError(
                f"request {req.rid}: {type(self).__name__} serves token "
                f"prompts, not squiggle signals (use a basecaller arch)")
        if not req.prompt:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1 (got "
                f"{req.max_new_tokens})")
        # positions written are 0 .. P + max_new - 2: the last generated
        # token is returned but never written back
        need = len(req.prompt) + req.max_new_tokens - 1
        if need > self.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new-1 = {need} positions "
                f"exceed cache_len {self.cache_len}")
        if not self.pool.fits(need):
            bl = self.pool.block_len
            raise ValueError(
                f"request {req.rid}: needs {-(-need // bl)} blocks of "
                f"{bl}, more than the arena holds "
                f"({min(self.pool.n_blocks.values())}); raise n_blocks")

    def make_chunks(self, req) -> List[Chunk]:
        # a resumed (preempted) request re-prefills prompt + generated
        # tokens: greedy decode is deterministic and sampled noise is
        # keyed by (seed, rid, step), so it replays
        seq = list(req.prompt) + list(req.out_tokens)
        C = self.chunk_tokens
        return [Chunk(seq[i:i + C], len(seq[i:i + C]))
                for i in range(0, len(seq), C)]

    # ------------------------------------------------------------- pool
    def alloc_pool(self, slot: int, upto: int) -> bool:
        return self.pool.alloc(slot, upto)

    def reset_row(self, slot: int) -> None:
        self.pool.release_slot(slot)

    def pool_util(self) -> float:
        return self.pool.block_stats()["util"]

    # ------------------------------------------------------------ device
    def step(self, works: List[Optional[Any]]) -> List[List[int]]:
        return self.collect(self.dispatch(works))

    def dispatch(self, works: List[Optional[Any]]) -> Any:
        """Enqueue one tick; the tokens stay on the device until
        ``collect``."""
        if any(isinstance(w, PrefillWork) for w in works):
            return self._dispatch_mixed(works)
        return self._dispatch_decode_only(works)

    def collect(self, handle: Any,
                discard: frozenset = frozenset()) -> List[List[int]]:
        works, toks = handle
        # sync: the scheduler needs the tick's tokens on the host
        toks = toks.cpu().numpy()
        out: List[List[int]] = []
        for i, w in enumerate(works):
            if w is None or i in discard:
                out.append([])
            elif isinstance(w, DecodeWork) or w.final:
                out.append([int(toks[i])])
            else:
                out.append([])
        return out

    def _row(self, w) -> Tuple:
        """Sampling row: the step is dispatch-time state under async."""
        step = w.step if isinstance(w, DecodeWork) and w.step >= 0 \
            else len(w.req.out_tokens)
        return (w.req.sampling, w.req.rid, step)

    def _run(self, kind: str, width: int, rows, *args) -> Any:
        sampled = any_sampled(rows)
        fn = self.plans.lookup((kind, width,
                                "sampled" if sampled else "greedy"))
        toks = fn(*args, self.pool.host_tables(),
                  pack_rows(rows) if sampled else None)
        self._prev_tokens.copy_(toks)        # in place: the plans read it
        return toks

    def _dispatch_decode_only(self, works) -> Any:
        B = self.n_slots
        tok = np.zeros((B, 1), np.int32)
        t = np.full((B, 1), -1, np.int32)
        chain = np.zeros((B,), np.int32)
        rows: List[Optional[Tuple]] = [None] * B
        for i, w in enumerate(works):
            if w is None:
                continue
            tok[i, 0] = w.last_token
            t[i, 0] = w.pos
            chain[i] = int(w.chained)
            rows[i] = self._row(w)
        toks = self._run("decode", 1, rows, torch.from_numpy(tok),
                         torch.from_numpy(t), torch.from_numpy(chain),
                         None, None)
        return (works, toks)

    def _dispatch_mixed(self, works) -> Any:
        """Decode rows (column 0) and prefill chunks in one (B, C) plan;
        mid-prompt chunk rows pack as greedy (their token is dropped)."""
        B = self.n_slots
        width = max(len(w.payload) for w in works
                    if isinstance(w, PrefillWork))
        C = round_chunk(width, self.buckets)
        tok = np.zeros((B, C), np.int32)
        t = np.full((B, C), -1, np.int32)
        chain = np.zeros((B,), np.int32)
        fresh = np.zeros((B,), np.int32)
        last = np.zeros((B,), np.int32)
        rows: List[Optional[Tuple]] = [None] * B
        for i, w in enumerate(works):
            if w is None:
                continue
            if isinstance(w, DecodeWork):
                tok[i, 0] = w.last_token
                t[i, 0] = w.pos
                chain[i] = int(w.chained)
                rows[i] = self._row(w)
                continue
            n = len(w.payload)
            tok[i, :n] = w.payload
            t[i, :n] = w.pos + np.arange(n)
            fresh[i] = int(w.fresh)
            last[i] = n - 1
            if w.final and w.req.sampling.temperature > 0:
                rows[i] = self._row(w)
        toks = self._run("mixed", C, rows, *map(torch.from_numpy, (
            tok, t, chain, fresh, last)))
        return (works, toks)


# ---------------------------------------------------------------------------
# EncoderPrefixRunner — the audio family's encoder-decoder (Whisper)


class EncoderPrefixRunner(TokenRunner):
    """Serve an encoder-decoder audio arch under the slot machinery.

    Each request carries ``frames`` (the stub log-mel embeddings,
    ``(frontend_tokens, d_model)``). At admission the encoder runs once
    and every decoder layer's cross-attention K/V is written into the
    slot's row of a per-slot device buffer (``{xdec group: {"k", "v":
    (n_layers, n_slots, Se, Hkv, hd)}}`` in ``cache_dtype``); the tick
    plans read the slots' rows, so the decoder tokens then schedule
    exactly as a token-only arch's: chunked prefill, paged
    self-attention KV, sampling, preemption (a resumed request is
    admitted again and restages: ``encode`` is deterministic)."""

    def __init__(self, params, cfg: ModelConfig, *, cache_dtype, **kw):
        if cfg.family != "audio":
            raise NotImplementedError(
                f"EncoderPrefixRunner serves audio enc-dec archs, not "
                f"{cfg.name} (family={cfg.family!r})")
        super().__init__(params, cfg, cache_dtype=cache_dtype, _check=False,
                         **kw)
        Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        shape = (self.n_slots, cfg.frontend_tokens, Hkv, hd)
        self.enc_kv = {
            gname: {name: torch.zeros((n, *shape), dtype=cache_dtype,
                                      device=self.device)
                    for name in ("k", "v")}
            for gname, kind, n in self._tfm.group_names(cfg)
            if kind == "xdec"}
        self._stage_key = ("stage", 0, "enc")
        self.plans.register(self._stage_key, self._stage)

    def _stage(self, frames: torch.Tensor, slot: torch.Tensor) -> None:
        """Encode one request's frames (F, d) and write every xdec
        layer's cross K/V into row ``slot`` (an int, or (1,) int64 as
        the staged plan takes it) of the buffer, in place."""
        from repro_torch.models.lm import encdec
        tfm = self._tfm
        with torch.inference_mode():
            slot = torch.as_tensor(slot).to(self.device,
                                            non_blocking=True).reshape(-1)
            enc_out = encdec.encode(self.params["encoder"],
                                    frames.to(self.device)[None], self.cfg)
            for gname, bufs in self.enc_kv.items():
                for i, p in enumerate(self.layers[gname]):
                    kv = tfm.enc_kv_for_layer(p["xattn"], enc_out, self.cfg)
                    for name in ("k", "v"):
                        bufs[name][i].index_copy_(
                            0, slot, kv[name].to(bufs[name].dtype))

    def warmup(self) -> int:
        """Every tick plan once, then the staging plan on zero frames
        into slot 0 (each admission restages its slot, so nothing
        leaks into traffic)."""
        warmed = super().warmup()
        cfg = self.cfg
        self.plans.warm(self._stage_key,
                        torch.zeros((cfg.frontend_tokens, cfg.d_model)),
                        torch.zeros((1,), dtype=torch.int64))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return warmed + 1

    def validate(self, req) -> None:
        super().validate(req)
        Se, d = self.cfg.frontend_tokens, self.cfg.d_model
        if req.frames is None:
            raise ValueError(
                f"request {req.rid}: audio serving needs a `frames` "
                f"payload of shape ({Se}, {d})")
        if tuple(np.shape(req.frames)) != (Se, d):
            raise ValueError(
                f"request {req.rid}: frames shape "
                f"{tuple(np.shape(req.frames))} != ({Se}, {d})")

    def admit(self, slot: int, req) -> None:
        frames = torch.from_numpy(np.asarray(req.frames, np.float32))
        self.plans.lookup(self._stage_key)(
            frames, torch.full((1,), slot, dtype=torch.int64))


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
        f"{cfg.family!r}, frontend_tokens={cfg.frontend_tokens}); "
        f"registered: {[n for n, _, _ in _RUNNERS]}")


def _token_supported(cfg: ModelConfig) -> bool:
    from repro_torch.models.lm import transformer as tfm
    return tfm.supports_slot_serving(cfg)


register_runner("basecaller", lambda cfg: cfg.family == "basecaller",
                BasecallerRunner)
register_runner("encoder_prefix", lambda cfg: cfg.family == "audio",
                EncoderPrefixRunner)
register_runner("token", _token_supported, TokenRunner)
