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

Registered here: :class:`TokenRunner` (token-only LMs over the paged KV
pool, per-request sampling) and :class:`BasecallerRunner` (squiggle in,
bases out). Streaming and read-until come with the streaming slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import PackedTensor, tree_map
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
    move to the device once; the pool's arenas update in place.

    Async dispatch: ``dispatch`` enqueues the tick and returns with the
    tokens on the device; ``collect`` reads them back. A ``chained``
    decode row's input token is the previous tick's on-device output
    (``chain``/``prev``), so the pipeline needs no readback in between.
    """

    autoregressive = True
    supports_async = True

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int,
                 cache_len: int, prefill_chunk: int, cache_dtype,
                 block_len: int = 0, n_blocks: int = 0,
                 attn_backend: str = "auto", quant_policy=None,
                 device=None, **_):
        from repro_torch.models.lm import transformer as tfm
        if not tfm.supports_slot_serving(cfg):
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
        self.plans = PlanCache()
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

    def _plan(self, *, mixed: bool, sampled: bool) -> Callable:
        """One tick program: (tok, t, chain, fresh, last, sp) host inputs
        -> (B,) int32 tokens on the device (``fresh``/``last`` are None
        on decode-only ticks, ``sp`` on greedy ones)."""
        cfg, tfm, pool = self.cfg, self._tfm, self.pool

        def step(tok, t, chain, fresh, last, sp):
            dev = self.device
            with torch.inference_mode():
                tok_d = tok.to(dev, non_blocking=True)
                ch = chain.to(dev, non_blocking=True) > 0
                tok_d[:, 0] = torch.where(ch, self._prev_tokens, tok_d[:, 0])
                if mixed:
                    pool.mask_fresh_rows(pool.caches, fresh)
                logits, _ = tfm.decode_step_slots(
                    self.params, pool.caches, tok_d, t, cfg,
                    logits_at=last, tables=pool.host_tables(),
                    attn_backend=self.attn_backend, layers=self.layers)
                logits = logits[:, 0, :]
                if sampled:
                    spd = {k: torch.from_numpy(v).to(dev, non_blocking=True)
                           for k, v in sp.items()}
                    return sample_tokens(logits, spd)
                return torch.argmax(logits, dim=-1).to(torch.int32)
        return step

    def plan_stats(self) -> Dict[str, int]:
        return self.plans.stats()

    def warmup(self) -> int:
        """Run every plan once over an all-pad tick (``t = -1``: nothing
        is written, so the pool is unchanged)."""
        B = self.n_slots
        sp = pack_rows([None] * B)
        warmed = 0
        for key in self.plans.keys():
            kind, w, flavor = key
            tok = torch.zeros((B, w), dtype=torch.int32)
            t = torch.full((B, w), -1, dtype=torch.int32)
            zeros = torch.zeros((B,), dtype=torch.int32)
            mixed = kind == "mixed"
            self.plans.fn(key)(tok, t, zeros, zeros if mixed else None,
                               zeros if mixed else None,
                               sp if flavor == "sampled" else None)
            self.plans.mark_warmed(key)
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
        toks = fn(*args, pack_rows(rows) if sampled else None)
        self._prev_tokens = toks
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


def _token_supported(cfg: ModelConfig) -> bool:
    from repro_torch.models.lm import transformer as tfm
    return tfm.supports_slot_serving(cfg)


register_runner("basecaller", lambda cfg: cfg.family == "basecaller",
                BasecallerRunner)
register_runner("token", _token_supported, TokenRunner)
