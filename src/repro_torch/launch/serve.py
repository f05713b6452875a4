"""Serving launcher: basecaller reads or token LM requests.

Basecallers
-----------
``python -m repro_torch.launch.serve --arch rubicall --wbits 8 --warmup``
replays a synthetic Poisson stream of simulated squiggle reads
(``--requests`` reads at ``--rate`` reads/s, ``--read-bases`` mean
bases each) into :class:`repro_torch.serving.engine.ServingEngine`:
reads queue on the host, ``--slots`` slots admit them as capacity
frees, and every tick runs ONE batched window forward of every
scheduled slot (``--chunk-samples`` core samples per window plus the
receptive-field halo), merged by incremental greedy (or ``--beam``
prefix-beam) CTC. ``--wbits 8`` serves packed int8 weights, so the
stride-1 square blocks run the fused CUDA ``qconv1d`` kernel.
``--async-dispatch`` pipelines the tick (dispatch N, read back N-1);
``--max-queue``/``--queue-timeout`` bound admission. The run ends with
reads/s, bases/s and the tick-latency percentiles.

``--stream`` makes the reads LIVE: Poisson read starts, then each
read's samples arrive over wall-clock time at ``PORE_HZ`` and are
``append()``-ed to a :class:`repro_torch.serving.stream.StreamingRequest`;
bases emit as their receptive field is covered (``--qos latency``) or
once per fully covered window (``--qos accuracy``, identical to the
offline chunked path). ``--read-until`` trains the start-of-read
classifier at launch, on the engine's device, and ejects off-target
reads (with ``--stream``, a ``1 - --target-frac`` share of the reads is
normalized white noise) after ``--eject-after-chunks`` windows; an
ejected read frees its slot, keeps its bases so far, and its generator
stops appending. The streamed run reports emit-latency p50/p99 and,
with read-until, ejections and samples saved.

Token LMs (the dense, moe, ssm, hybrid and audio families)
----------------------------------------------------------
``python -m repro_torch.launch.serve --arch qwen1.5-4b --wbits 8
--warmup`` replays ``--requests`` prompts of up to ``--prompt-len``
random tokens, each asking for up to ``--tokens`` new ones, arriving as
a Poisson stream at ``--rate``. ``--slots`` decode slots admit them;
every tick runs one co-batched step in which prompts prefill in
``--prefill-chunk`` chunks beside the running slots' decode tokens
(``--max-prefill-tokens`` caps a tick's prefill). KV lives in a paged
block pool (``--block-len``, ``--n-blocks``, ``--cache-len``; storage
``--cache-dtype`` or per group ``--quant-policy``); ``--attn-backend``
``auto`` reads it through the CUDA paged-attention kernels on a card
and the gather reference on the CPU. ``--temperature``/``--top-k``/
``--top-p``/``--seed``/``--sampled-frac`` mix sampled requests in;
``--eos-id`` sets a stop token. ``--wbits 8|4`` packs the weights and
carries those weight bits in the config's quantization policy, so every
packed projection runs the CUDA ``qmatmul`` kernel (the JAX launcher's
``--wbits`` packs without the policy, so its projections dequantize on
read); the weights are packed as they are drawn on the device. The
moe family (``--arch deepseek-v3-671b``, MLA attention over a latent
pool, or ``granite-moe-1b-a400m``) goes the same way, as do the ssm
family (``--arch mamba2-130m``: per-slot recurrent state, no KV pool)
and the hybrid family (``--arch hymba-1.5b``: attention beside SSM
heads in every layer, sliding-window layers paged as rings of their
window, full-attention ones at ``--cache-len``) and the audio family
(``--arch whisper-tiny``: each request carries seeded stub frames; its
encoder runs once at admission into a per-slot cross-attention buffer,
read by the paged kernel on decode ticks). The vlm family
(``internvl2-1b``) has no serving runner, as in the reference, and
serves only under ``--static``. ``--split-tick``
runs the legacy scheduler (one step per prefilling slot, then a
decode-only step) instead of the co-batched tick; ``--history-limit N``
keeps only the newest N entries of the host-side per-request history.
The run ends with tok/s, TTFT percentiles, the decode interval, pool
utilisation, preemptions and the resolved attention backend.

``--knob-search`` (token LMs) runs QABAS's measure-and-rank loop over
the serving knobs instead (``core/qabas/serving.py``): KV-cache
storage bf16, fp8 and int8, ``--block-len`` and half of it, and the
attention backend (``--attn-backend auto`` tries both ``gather`` and
``cuda``), each candidate serving the same small greedy workload;
``--knob-budget`` caps the candidates measured (taken in
roofline-prior order) and ``--per-group`` adds the per-layer-group
refinement. It prints the table ranked by decode tok/s per cache byte
and the best knobs as flags.

The static path (``--static``, every LM family)
-----------------------------------------------
``python -m repro_torch.launch.serve --arch mamba2-130m --static
--slots 4 --prompt-len 2048 --tokens 32`` runs the reference's legacy
single-shot loop: one fixed batch of ``--slots`` random prompts of
``--prompt-len`` tokens, one whole-prompt prefill into contiguous caches
(the ``ssd_scan`` kernel for mamba2's SSD layers, ``flash_attention``
for qwen1.5-4b's attention, both for hymba-1.5b's full-attention
layers and ``ssd_scan`` alone for its sliding-window ones,
``flash_attention`` for granite-moe-1b-a400m's attention and no kernel
for deepseek-v3-671b's MLA, whose prefill runs the plain
``blockwise_attn`` as the reference's; Whisper's encoder runs the
kernel without the causal mask over its seeded frames, and
internvl2-1b's seeded patch embeddings sit before the prompt), then
``--tokens`` - 1 lockstep greedy decode steps (MLA over contiguous
latent rows, MoE with the batch as one dispatch group). ``--wbits`` packs the
weights as they are drawn and dequantizes them once, up front, as the
reference's static path does. As the reference jits its prefill and its
decode step, the loop runs two staged plans (:class:`StaticPlans`): on
a card each is captured once as a CUDA graph and replayed, the decode
step's position staged as a device scalar. It prints the capture
seconds, the prefill time, decode tok/s, the kernel launches of each
half and the plans' graphs and retraces.

Runs on CUDA; ``--device cpu`` runs the plain PyTorch versions on the
CPU instead. Without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import functools
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.config import QuantPolicy, get_config
from repro_torch.core.quant.policy import (PackedTensor, dequantize,
                                           quantize_tree)
from repro_torch.kernels import ops
from repro_torch.models import api


def quantize_for_serving(params, wbits: int):
    return quantize_tree(params, QuantPolicy(weight_bits=wbits, act_bits=0))


def dequantize_tree(params, dtype):
    """Every packed weight dequantized once, up front (the static path's
    weights, as the reference's ``dequantize_tree``)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = dequantize_tree(v, dtype)
        else:
            out[k] = dequantize(v, dtype) if isinstance(v, PackedTensor) else v
    return out


def build_reads(args, seed: int = 0):
    """Simulated squiggle reads with Poisson arrival times."""
    from repro_torch.data.squiggle import (SquiggleConfig, normalize,
                                           pore_table, simulate_read)
    from repro_torch.serving.engine import Request
    rs = np.random.RandomState(seed)
    arrivals = np.cumsum(rs.exponential(1.0 / args.rate, size=args.requests))
    sim = SquiggleConfig(noise=0.1, drift=0.0)
    table = pore_table()
    reqs = []
    for i in range(args.requests):
        n_bases = int(rs.randint(max(args.read_bases // 2, 8),
                                 args.read_bases + 1))
        sig, _ = simulate_read(rs, sim, table, n_bases)
        reqs.append(Request(rid=i, signal=normalize(sig),
                            arrival_time=float(arrivals[i])))
    return reqs


PORE_HZ = 4000.0          # nanopore sample rate the streamed traffic mimics


def make_read_until(cfg, args, device):
    """Train the start-of-read classifier on ``device`` on synthetic
    windows of the engine's window geometry and wrap it in a ReadUntil
    policy."""
    from repro_torch.models.basecaller import classifier as rc
    from repro_torch.models.basecaller import model as bc
    from repro_torch.serving.stream import ReadUntil
    stride = bc.total_stride(cfg)
    halo = bc.chunk_halo(cfg)
    core = max(-(-args.chunk_samples // stride), 1) * stride
    window = core + 2 * halo
    rs = np.random.RandomState(args.seed + 77)
    x, y = rc.make_training_set(rs, window, n_per_class=32)
    cp = rc.init_params(torch.Generator().manual_seed(args.seed + 1))
    cp = {k: v.to(device) for k, v in cp.items()}
    cp, loss = rc.fit(cp, x, y, steps=150, lr=0.1)
    print(f"[serve] read-until: classifier trained on {device} on "
          f"{x.shape[0]} windows of {window} samples (bce {loss:.3f}), "
          f"ejecting after {args.eject_after_chunks} chunks")
    return ReadUntil(params=cp, eject_after_chunks=args.eject_after_chunks)


def build_streamed_reads(args, seed: int = 0):
    """Streamed basecaller traffic: Poisson read starts; each entry is
    ``(start_time, on_target, full_signal)`` and the run loop appends
    the signal in wall-clock order at PORE_HZ. With --read-until, a
    ``1 - target_frac`` fraction are off-target white-noise reads."""
    from repro_torch.data.squiggle import (SquiggleConfig, normalize,
                                           pore_table, simulate_read)
    rs = np.random.RandomState(seed)
    starts = np.cumsum(rs.exponential(1.0 / args.rate, size=args.requests))
    sim = SquiggleConfig(noise=0.1, drift=0.0)
    table = pore_table()
    target_frac = args.target_frac if args.read_until else 1.0
    reads = []
    for i in range(args.requests):
        n_bases = int(rs.randint(max(args.read_bases // 2, 8),
                                 args.read_bases + 1))
        on_target = bool(rs.rand() < target_frac)
        if on_target:
            sig, _ = simulate_read(rs, sim, table, n_bases)
            sig = normalize(sig)
        else:
            sig = normalize(rs.randn(n_bases * 9).astype(np.float32))
        reads.append((float(starts[i]), on_target, sig))
    return reads


def stream_reads(engine, reads, *, clock=time.perf_counter,
                 sleep=time.sleep) -> dict:
    """Drive the engine from live StreamingRequests: submit each read at
    its start on ``clock``, append its samples as that clock covers them
    (PORE_HZ per pore), finish it at its end, and step the engine until
    every read is done. Ejected reads stop appending — the forgone tail
    is booked as samples saved. Returns the drained requests by rid. A
    ``clock`` that advances a fixed step per call, with a no-op
    ``sleep``, replays one append schedule exactly."""
    from repro_torch.serving.stream import StreamingRequest
    live = {}                       # rid -> [req, signal, appended]
    t0 = clock()
    i = 0
    while i < len(reads) or live:
        now = clock() - t0
        while i < len(reads) and reads[i][0] <= now:
            req = StreamingRequest(rid=i, arrival_time=reads[i][0],
                                   clock=engine.metrics.clock)
            engine.submit(req)
            live[i] = [req, reads[i][2], 0]
            i += 1
        for rid in list(live):
            req, sig, ptr = live[rid]
            if req.done:
                if req.ejected and ptr < sig.shape[0]:
                    engine.metrics.record_samples_saved(sig.shape[0] - ptr)
                del live[rid]
                continue
            due = min(int((now - req.arrival_time) * PORE_HZ), sig.shape[0])
            if due > ptr:
                req.append(sig[ptr:due])
                live[rid][2] = due
            elif ptr >= sig.shape[0] and not req.stream_finished:
                req.finish()
        if engine.busy:
            engine.step()
        else:
            sleep(0.002)
    return engine.drain_completed()


def run_streamed(engine, args, **kw) -> dict:
    """Stream ``--requests`` live reads (:func:`build_streamed_reads`,
    seeded by ``--seed``) through ``engine`` (:func:`stream_reads`, which
    takes ``kw``) and print the emit-latency and read-until report.
    Returns the drained requests, the reads and the metrics summary."""
    reads = build_streamed_reads(args, seed=args.seed)
    done = stream_reads(engine, reads, **kw)
    on_target = {i: tgt for i, (_, tgt, _) in enumerate(reads)}
    ejected = [r for r in done.values() if r.ejected]
    n_off = sum(not on_target[rid] for rid in done)
    off_ejected = sum(not on_target[r.rid] for r in ejected)
    total_samples = sum(sig.shape[0] for _, _, sig in reads)
    s = engine.metrics.summary()
    print(f"[serve] streamed: {len(done)} reads ({n_off} off-target), "
          f"qos={engine.runner.qos}, emit latency p50 "
          f"{s['emit_latency_p50_s'] * 1e3:.1f}ms p99 "
          f"{s['emit_latency_p99_s'] * 1e3:.1f}ms "
          f"({s['emit_events']} emissions)")
    if engine.runner.read_until is not None:
        print(f"[serve] read-until: {s['ejections']:.0f} ejections "
              f"({off_ejected}/{n_off} off-target rejected, "
              f"{len(ejected) - off_ejected} on-target lost) | samples "
              f"saved {s['samples_saved']:.0f}/{total_samples} "
              f"({s['samples_saved'] / max(total_samples, 1) * 100:.0f}%) | "
              f"basecalled {s['ejected_consumed_samples']:.0f} samples on "
              f"ejected reads")
    print_tick_report(s, args)
    if done:
        first = done[min(done)]
        print(f"[serve] sample ({first.status}):", first.out_tokens[:16])
    return {"done": done, "reads": reads, "summary": s}


def run(engine, reqs) -> None:
    """Submit each read at its arrival time and step until all are done."""
    t0 = time.perf_counter()
    i = 0
    while i < len(reqs) or engine.busy:
        now = time.perf_counter() - t0
        while i < len(reqs) and reqs[i].arrival_time <= now:
            engine.submit(reqs[i])
            i += 1
        if engine.busy:
            engine.step()
        elif i < len(reqs):
            time.sleep(min(reqs[i].arrival_time - now, 0.01))


# ---------------------------------------------------------------------------
# Token LMs


def request_samples(args, i: int) -> bool:
    """Request ``i`` samples iff the running count of sampled requests
    crosses an integer at i: ``--sampled-frac`` spread evenly."""
    frac = min(max(args.sampled_frac, 0.0), 1.0)
    if args.temperature <= 0 or frac <= 0:
        return False
    return int((i + 1) * frac) > int(i * frac)


def build_requests(cfg, args, seed: int = 0):
    """Poisson arrivals of random-token prompts (the reference's stream);
    an audio arch's requests carry standard-normal stub frames, drawn
    after each request's sampling parameters from the same stream."""
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import SamplingParams
    rs = np.random.RandomState(seed)
    arrivals = np.cumsum(rs.exponential(1.0 / args.rate, size=args.requests))
    eos = args.eos_id if args.eos_id >= 0 else None
    reqs = []
    for i in range(args.requests):
        plen = int(rs.randint(max(args.prompt_len // 2, 1),
                              args.prompt_len + 1))
        mnew = int(rs.randint(max(args.tokens // 4, 1), args.tokens + 1))
        prompt = rs.randint(1, cfg.vocab_size, size=plen).tolist()
        if request_samples(args, i):
            sp = SamplingParams(max_new_tokens=mnew, eos_id=eos,
                                temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p,
                                seed=args.seed + i)
        else:
            sp = SamplingParams(max_new_tokens=mnew, eos_id=eos)
        frames = (rs.randn(cfg.frontend_tokens, cfg.d_model)
                  .astype(np.float32) if cfg.family == "audio" else None)
        reqs.append(Request(rid=i, prompt=prompt, sampling=sp,
                            frames=frames, arrival_time=float(arrivals[i])))
    return reqs


def resolve_quant_policy(cfg, args):
    """``--quant-policy``/``--cache-dtype`` checked before any device
    memory is taken; None = the config's dtype."""
    spec = args.quant_policy or args.cache_dtype or None
    if spec is None:
        return None
    from repro_torch.models.lm import transformer as tfm
    from repro_torch.serving.cache import CacheQuantPolicy
    try:
        policy = CacheQuantPolicy.parse(spec)
        policy.validate_groups([g for g, _, _ in tfm.group_names(cfg)])
    except ValueError as e:
        raise SystemExit(f"[serve] error: invalid cache quantization "
                         f"spec {spec!r}: {e}")
    return spec


def draw_lm_params(cfg, args, device):
    """Seeded parameters drawn on ``device`` and packed under
    ``--wbits`` as they are drawn, with those weight bits carried into
    the config's quantization policy. Returns (cfg, params)."""
    if args.wbits:
        cfg = replace(cfg, quant=QuantPolicy(weight_bits=args.wbits,
                                             act_bits=0))
    params = api.init_params(0, cfg, device=device, wbits=args.wbits)
    if args.wbits:
        print(f"[serve] weights quantized to int{args.wbits} (packed; "
              f"projections run the qmatmul kernel)")
    return cfg, params


def build_lm_engine(cfg, args, device):
    """Seeded parameters drawn on ``device``, packed under ``--wbits``,
    and the engine over them."""
    cfg, params = draw_lm_params(cfg, args, device)
    engine = api.make_serving_engine(
        params, cfg, device=device, n_slots=args.slots,
        cache_len=args.cache_len or args.prompt_len + args.tokens,
        prefill_chunk=args.prefill_chunk,
        max_prefill_tokens=args.max_prefill_tokens,
        co_batch=not args.split_tick,
        cache_dtype=getattr(torch, cfg.dtype), block_len=args.block_len,
        n_blocks=args.n_blocks, history_limit=args.history_limit or None,
        async_dispatch=args.async_dispatch,
        max_queue=args.max_queue, queue_timeout_s=args.queue_timeout,
        attn_backend=args.attn_backend,
        quant_policy=resolve_quant_policy(cfg, args))
    return cfg, engine


def run_lm(cfg, args, device) -> None:
    cfg, engine = build_lm_engine(cfg, args, device)
    if args.warmup:
        t0 = time.perf_counter()
        n = engine.warmup()
        print(f"[serve] warmup: {n} tick plans run in "
              f"{time.perf_counter() - t0:.2f}s")
    reqs = build_requests(cfg, args)
    n_sampled = sum(r.sampling.temperature > 0 for r in reqs)
    pool = engine.pool
    by = pool.nbytes_by_class()
    print(f"[serve] engine ({type(engine.runner).__name__} on {device}): "
          f"{cfg.name}, {args.requests} requests over "
          f"{reqs[-1].arrival_time:.2f}s (rate {args.rate}/s), "
          f"{args.slots} slots, chunk {args.prefill_chunk}")
    print(f"[serve] sampler mix: {len(reqs) - n_sampled} greedy, "
          f"{n_sampled} sampled"
          + (f" (T={args.temperature}, top_k={args.top_k}, "
             f"top_p={args.top_p}, seeds {args.seed}+rid)"
             if n_sampled else ""))
    print(f"[serve] paged pool: block_len {pool.block_len}, "
          f"{pool.block_stats()['blocks_total']} blocks "
          f"({pool.nbytes() / 2 ** 20:.2f} MiB = "
          f"{by['arena'] / 2 ** 20:.2f} arena + "
          f"{by['scales'] / 2 ** 20:.2f} scales + "
          f"{by['pos'] / 2 ** 20:.2f} pos + "
          f"{by['state'] / 2 ** 20:.2f} state)"
          + (f", history_limit {args.history_limit}"
             if args.history_limit else "")
          + f", cache quantization {pool.quant_policy.describe()}")
    enc = getattr(engine.runner, "enc_kv", None)
    if enc:
        nb = sum(t.numel() * t.element_size() for g in enc.values()
                 for t in g.values())
        print(f"[serve] encoder buffer: {nb / 2 ** 20:.2f} MiB "
              f"({cfg.frontend_tokens} frames a slot, staged at admission)")
    print(f"[serve] attn backend: {engine.runner.attn_backend} "
          f"(requested {args.attn_backend!r})")
    run(engine, reqs)
    s = engine.metrics.summary()
    print(f"[serve] done: {s['requests_done']} requests, "
          f"{s['generated_tokens']} tokens in {s['elapsed_s']:.2f}s "
          f"({s['tokens_per_s']:.1f} tok/s end-to-end, "
          f"{s['decode_tokens_per_s']:.1f} tok/s decode)")
    print(f"[serve] ttft mean {s['ttft_mean_s'] * 1e3:.0f}ms "
          f"p50 {s['ttft_p50_s'] * 1e3:.0f}ms "
          f"p95 {s['ttft_p95_s'] * 1e3:.0f}ms "
          f"p99 {s['ttft_p99_s'] * 1e3:.0f}ms | queue depth max "
          f"{s['queue_depth_max']} | slot occupancy "
          f"{s['slot_occupancy']:.2f}/{args.slots}")
    print(f"[serve] decode interval p50 "
          f"{s['decode_interval_p50_s'] * 1e3:.1f}ms p99 "
          f"{s['decode_interval_p99_s'] * 1e3:.1f}ms "
          f"({'split-tick' if args.split_tick else 'unified tick'}"
          + (f", prefill budget {args.max_prefill_tokens} tok"
             if args.max_prefill_tokens else "") + ")")
    print(f"[serve] pool util mean {s['pool_util_mean']:.2f} max "
          f"{s['pool_util_max']:.2f} | preemptions {s['preemptions']:.0f} | "
          f"attn backend {engine.runner.attn_backend}")
    print_tick_report(s, args)
    done = engine.drain_completed()
    if done:
        print("[serve] sample:", done[min(done)].out_tokens[:16])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _static_prefill(params, cfg, caches, tokens, patch_embeds, frames):
    """The static prefill plan: (first token (B, 1), last-position
    logits (B, 1, V)), ``caches`` filled in place."""
    from repro_torch.models.lm import encdec
    from repro_torch.models.lm import transformer as tfm
    with torch.no_grad():
        enc_out = (encdec.encode(params["encoder"], frames, cfg)
                   if frames is not None else None)
        logits, _ = tfm.prefill(params, tokens, cfg, patch_embeds=patch_embeds,
                                enc_out=enc_out, caches=caches)
        return logits.argmax(-1).to(torch.int32), logits


def _static_decode(params, cfg, caches, tok, t):
    """The static decode plan: the next token (B, 1) after ``tok`` at
    the 0-d position ``t``, ``caches`` updated in place."""
    from repro_torch.models.lm import transformer as tfm
    with torch.no_grad():
        logits, _ = tfm.decode_step(params, caches, tok, t, cfg)
        return logits.argmax(-1).to(torch.int32)


class StaticPlans:
    """The static loop's two staged plans over one set of caches: the
    reference's two jitted programs (the prefill, and the decode step
    with its position traced), through :class:`PlanCache`.

    ``("static_prefill", S, "greedy")``: the prompt tokens (B, S), a vlm
    prompt's ``patch_embeds`` and an audio prompt's ``frames`` in; the
    encoder, the prefill into the caches (reset first:
    ``transformer.reset_caches``) and the argmax inside; the first token
    (B, 1) int32 and the last-position logits (B, 1, V) out.
    ``("static_decode", 1, "greedy")``: the token (B, 1) and the
    position ``t`` (0-d int32) in; ``decode_step`` and the argmax
    inside; the next token out. The caches are allocated once by
    ``init_caches``, outside both plans, which close over them and fill
    them in place; only the small outputs are cloned. On a card the
    plans are CUDA graphs, captured at :meth:`warm`; ``graphs=False``
    keeps them eager, for comparison only. On the CPU they run eagerly.
    A plan that fails to capture raises."""

    def __init__(self, params, cfg, batch: int, prompt: int,
                 cache_len: int, *, cache_dtype=torch.bfloat16,
                 device=None, enc_len: int = 0, graphs: bool = True):
        from repro_torch.models.lm import transformer as tfm
        from repro_torch.serving.plan import PlanCache
        self.caches = tfm.init_caches(
            cfg, batch, cache_len, cache_dtype, device=device,
            state_dtype=getattr(torch, cfg.dtype), enc_len=enc_len)
        self.plans = PlanCache(device, graphs=graphs)
        self.prefill_key = ("static_prefill", prompt, "greedy")
        self.decode_key = ("static_decode", 1, "greedy")
        # the plans hold no reference back to this object, so its graphs
        # are freed when it is, never by a cyclic collection (which may
        # run inside another capture)
        closure = (params, cfg, self.caches)
        self.plans.register(self.prefill_key,
                            functools.partial(_static_prefill, *closure))
        self.plans.register(self.decode_key,
                            functools.partial(_static_decode, *closure))

    def warm(self, tokens, patch_embeds, frames, t) -> None:
        """Stage and run both plans once (capturing them on a card), as
        the reference's first jitted calls compile: the prefill on these
        inputs, then one decode step at ``t``. What they leave in the
        caches the next prefill resets."""
        tok, _ = self.plans.warm(self.prefill_key, tokens, patch_embeds,
                                 frames)
        self.plans.warm(self.decode_key, tok, t)

    def prefill(self, tokens, patch_embeds=None, frames=None):
        """(first token (B, 1), last-position logits (B, 1, V))."""
        return self.plans.lookup(self.prefill_key)(tokens, patch_embeds,
                                                   frames)

    def decode(self, tok, t):
        """The next token (B, 1) after ``tok`` at position ``t``."""
        return self.plans.lookup(self.decode_key)(tok, t)


def static_generate(params, cfg, tokens, n_new: int, *, cache_len=None,
                    cache_dtype=torch.bfloat16, patch_embeds=None,
                    frames=None, graphs: bool = True,
                    plans=None) -> dict:
    """The static loop over prompts ``tokens`` (B, S): whole-prompt
    prefill, then ``n_new`` - 1 lockstep greedy decode steps (every row
    at the same position, from the prefilled length). ``patch_embeds``
    (B, P, d): a vlm prompt's patches, before the tokens; the decode
    then starts P positions further on, at S + 2 P, as the reference's
    loop starts it (its prompt length counts the patches, and it adds
    them again; the positions between stay empty). ``frames`` (B, F,
    d): an audio prompt's, through the encoder inside the prefill.

    It runs through :class:`StaticPlans` (``plans``: staged plans of
    this shape to run again, else new ones; ``graphs=False``: eager
    plans on a card, for comparison only): both plans are warmed first
    (on a card, captured), then one prefill and ``n_new`` - 1 decode
    steps are replayed, the positions staged from one device vector.
    Returns the greedy tokens (B, n_new), the prefill's last-position
    logits, the caches, the warm-up, prefill and decode seconds (host
    clock around work that ends in a device synchronisation), the
    kernel launches of each half (counted through the captures' tallies
    under graphs) and the plans' ``stats()``."""
    dev = tokens.device
    B, S = tokens.shape
    start = S + (2 * patch_embeds.shape[1] if patch_embeds is not None
                 else 0)
    if plans is None:
        plans = StaticPlans(params, cfg, B, S, cache_len or start + n_new,
                            cache_dtype=cache_dtype, device=dev,
                            enc_len=0 if frames is None else frames.shape[1],
                            graphs=graphs)
    steps = torch.arange(start, start + max(n_new, 1), dtype=torch.int32,
                         device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    plans.warm(tokens, patch_embeds, frames, steps[0])
    _sync(dev)
    t_capture = time.perf_counter() - t0
    before = ops.launch_counts()
    t0 = time.perf_counter()
    tok, logits = plans.prefill(tokens, patch_embeds, frames)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    mid = ops.launch_counts()
    out = [tok]
    t0 = time.perf_counter()
    for i in range(n_new - 1):
        tok = plans.decode(tok, steps[i])
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    after = ops.launch_counts()
    return {"tokens": torch.cat(out, dim=1), "logits": logits,
            "caches": plans.caches, "capture_s": t_capture,
            "prefill_s": t_prefill, "decode_s": t_decode,
            "launches_prefill": {k: mid[k] - before[k] for k in mid
                                 if mid[k] - before[k]},
            "launches_decode": {k: after[k] - mid[k] for k in after
                                if after[k] - mid[k]},
            "plans": plans.plans.stats()}


def run_static(params, cfg, args, device, graphs: bool = True) -> dict:
    """The reference's legacy single-shot loop: ``--slots`` random
    prompts of ``--prompt-len`` tokens (seeded by ``--seed``), ``--tokens``
    greedy new tokens each; prints the capture seconds, the prefill
    time, decode tok/s, each half's kernel launches and the plans'
    graphs and retraces. A vlm batch's prompts keep ``--prompt-len
    - frontend_tokens`` tokens after its patches, as the reference's
    smoke batch, so its decode starts at ``--prompt-len +
    frontend_tokens`` (:func:`static_generate`); the caches hold
    ``prompt + tokens + frontend_tokens`` positions. ``graphs=False``
    keeps the plans eager on a card, for comparison only (the launcher
    has no flag for it). Returns :func:`static_generate`'s result."""
    batch = api.make_smoke_batch(args.seed, cfg, args.slots,
                                 args.prompt_len, device=device)
    r = static_generate(params, cfg, batch["tokens"], args.tokens,
                        cache_len=(args.prompt_len + args.tokens
                                   + cfg.frontend_tokens),
                        patch_embeds=batch.get("patch_embeds"),
                        frames=batch.get("frames"), graphs=graphs)
    st = r["plans"]
    print(f"[serve] static plans: {st['plans']} ({st['graphs']} graphs, "
          f"retraces={st['retraces']}), capture {r['capture_s']:.2f} s")
    print(f"[serve] prefill {args.slots}x{args.prompt_len} in "
          f"{r['prefill_s'] * 1e3:.2f} ms; kernel launches "
          f"{r['launches_prefill'] or 'none'}")
    total = args.slots * (args.tokens - 1)
    print(f"[serve] decoded {total} tokens in {r['decode_s']:.3f}s "
          f"({total / max(r['decode_s'], 1e-9):.1f} tok/s); kernel "
          f"launches {r['launches_decode'] or 'none'}")
    print("[serve] sample:", r["tokens"][0, :16].tolist())
    return r


def print_tick_report(s, args) -> None:
    """Dispatch section of the end-of-run report: plan-cache health (the
    ``retraces=`` figure is the mid-traffic capture gate), the captured
    graphs and the tick-latency percentiles."""
    print(f"[serve] ticks ({'async' if args.async_dispatch else 'sync'}): "
          f"p50 {s['tick_latency_p50_s'] * 1e3:.2f}ms "
          f"p99 {s['tick_latency_p99_s'] * 1e3:.2f}ms | idle skipped "
          f"{s['idle_ticks']:.0f} | queue hwm "
          f"{s['queue_depth_hwm']:.0f} | rejected {s['rejections']:.0f} | "
          f"plans {s['plans']:.0f} ({s['plans_warmed']:.0f} warmed, "
          f"{s['graphs']:.0f} graphs), hits {s['bucket_hits']:.0f} misses "
          f"{s['bucket_misses']:.0f} | retraces={s['retraces']:.0f}")
    if args.warmup and s["retraces"] > 0:
        raise SystemExit(
            f"[serve] error: {s['retraces']:.0f} mid-traffic retrace(s) "
            f"after --warmup — a warmed plan was staged and captured again "
            f"for inputs of another shape, dtype or device")


def run_knob_search(cfg, args, device) -> None:
    """QABAS-style serving-knob search on ``device``: rank (cache policy,
    block_len, attn backend) by measured decode tok/s per cache byte,
    over seeded weights drawn as the engine path draws them."""
    if cfg.family == "basecaller":
        raise SystemExit(
            f"[serve] error: --knob-search tunes the paged KV arena; "
            f"basecaller arch {cfg.name!r} has no KV cache")
    from repro_torch.core.qabas.serving import (format_knob_table,
                                                search_serving_knobs)
    cfg, params = draw_lm_params(cfg, args, device)
    cache_len = args.cache_len or args.prompt_len + args.tokens
    backends = ([args.attn_backend] if args.attn_backend != "auto"
                else ["gather", "cuda"])
    block_lens = sorted({args.block_len, max(args.block_len // 2, 4)})
    results = search_serving_knobs(
        params, cfg, block_lens=block_lens, backends=backends,
        n_slots=args.slots, cache_len=cache_len,
        prompt_len=min(args.prompt_len, cache_len // 2),
        max_tokens=min(args.tokens, cache_len // 2),
        per_group=args.per_group,
        budget=args.knob_budget or None, emit=print, device=device)
    print(f"[serve] knob search over {cfg.name}: ranked by measured "
          f"decode tok/s per cache byte")
    print(format_knob_table(results))
    best = results[0]
    print(f"[serve] best: --quant-policy '{best.knobs.quant_policy}' "
          f"--block-len {best.knobs.block_len} "
          f"--attn-backend {best.knobs.attn_backend} "
          f"({best.decode_tok_s:.1f} tok/s at "
          f"{best.cache_bytes/2**20:.2f} MiB, "
          f"{best.bytes_vs_bf16:.2f}x smaller than bf16)")


# ---------------------------------------------------------------------------
# Entry point


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4,
                    help="decode slots (engine) / batch size (static)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=16.0,
                    help="Poisson read arrivals per second")
    ap.add_argument("--read-bases", type=int, default=300,
                    help="mean bases per simulated read")
    ap.add_argument("--chunk-samples", type=int, default=1024,
                    help="core squiggle samples per window")
    ap.add_argument("--beam", type=int, default=0,
                    help="prefix-beam width (0 = greedy CTC)")
    ap.add_argument("--wbits", type=int, default=0, choices=[0, 4, 8])
    ap.add_argument("--warmup", action="store_true",
                    help="run every tick plan once before traffic")
    ap.add_argument("--async-dispatch", action="store_true")
    ap.add_argument("--max-queue", type=int, default=0)
    ap.add_argument("--queue-timeout", type=float, default=0.0)
    ap.add_argument("--split-tick", action="store_true",
                    help="legacy scheduler: one runner step per prefill "
                         "slot, then a decode-only step (admissions "
                         "stall decode)")
    ap.add_argument("--history-limit", type=int, default=0,
                    help="bound host-side per-request history to the "
                         "most recent N (0 = unbounded)")
    # ---- streaming + read-until (basecaller archs only) ----
    ap.add_argument("--stream", action="store_true",
                    help="live reads: samples arrive over wall-clock time "
                         "at the pore rate and are appended to "
                         "StreamingRequests")
    ap.add_argument("--qos", default="accuracy",
                    choices=["latency", "accuracy"],
                    help="streaming: 'latency' re-forwards the live window "
                         "as frames become stable; 'accuracy' forwards "
                         "each window once, when fully covered")
    ap.add_argument("--read-until", action="store_true",
                    help="train the start-of-read classifier at launch and "
                         "eject off-target reads")
    ap.add_argument("--target-frac", type=float, default=0.5,
                    help="streamed read-until traffic: share of on-target "
                         "reads (the rest are white noise)")
    ap.add_argument("--eject-after-chunks", type=int, default=2,
                    help="read-until: decide after this many "
                         "window-complete classifier scores")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--static", action="store_true",
                    help="token LMs: the single-shot static loop (one "
                         "whole-prompt prefill, lockstep greedy decode)")
    # ---- token LMs ----
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32,
                    help="max new tokens per request")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--max-prefill-tokens", type=int, default=0,
                    help="per-tick prefill token budget (0 = unlimited)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop token of every request (-1 = none)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="request i samples with seed + i")
    ap.add_argument("--sampled-frac", type=float, default=1.0,
                    help="share of requests that sample when "
                         "--temperature > 0")
    ap.add_argument("--cache-len", type=int, default=0,
                    help="per-request KV capacity (0 = prompt+tokens)")
    ap.add_argument("--block-len", type=int, default=16,
                    help="KV positions per paged-pool arena block")
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="arena blocks per layer group (0 = full backing)")
    ap.add_argument("--attn-backend", default="auto",
                    choices=["auto", "gather", "cuda"],
                    help="attention read path: 'cuda' the paged kernels "
                         "(their plain versions on the CPU), 'gather' "
                         "the reference; 'auto' = cuda on a card")
    ap.add_argument("--cache-dtype", default="",
                    help="KV arena storage: bf16, fp16, fp32, fp8 or int8")
    ap.add_argument("--quant-policy", default="",
                    help="per-group storage, e.g. 'default=bf16,"
                         "g0_dense=int8' (overrides --cache-dtype)")
    ap.add_argument("--knob-search", action="store_true",
                    help="QABAS-style serving-knob search: measure "
                         "per-layer cache dtype x block_len x attn "
                         "backend on a small greedy workload, print the "
                         "ranked tok/s-per-cache-byte table, and exit")
    ap.add_argument("--knob-budget", type=int, default=0,
                    help="cap measured knob-search candidates (taken in "
                         "roofline-prior order; 0 = measure all)")
    ap.add_argument("--per-group", action="store_true",
                    help="knob search: add the coordinate-descent "
                         "per-group precision refinement pass")
    args = ap.parse_args(argv)

    device = api.resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    if (args.stream or args.read_until) and cfg.family != "basecaller":
        raise SystemExit(
            f"[serve] error: --stream/--read-until serve live squiggle "
            f"reads; arch {cfg.name!r} is not a basecaller")
    if args.knob_search:
        run_knob_search(cfg, args, device)
        return
    if args.static:
        if cfg.family == "basecaller":
            raise SystemExit("[serve] error: --static serves token LMs")
        params = api.init_params(0, cfg, device=device, wbits=args.wbits)
        if args.wbits:
            params = dequantize_tree(params, getattr(torch, cfg.dtype))
            print(f"[serve] weights packed to int{args.wbits} and "
                  f"dequantized once, up front")
        run_static(params, cfg, args, device)
        return
    if cfg.family != "basecaller":
        from repro_torch.serving.runner import runner_name_for
        if runner_name_for(cfg) is None:
            raise NotImplementedError(
                f"[serve] {cfg.name} (family={cfg.family!r}) has no "
                f"serving runner, as in the reference; serve it with "
                f"--static")
        run_lm(cfg, args, device)
        return
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    if args.wbits:
        params = quantize_for_serving(params, args.wbits)
        print(f"[serve] weights quantized to int{args.wbits} (packed)")
    read_until = make_read_until(cfg, args, device) if args.read_until \
        else None
    engine = api.make_serving_engine(
        params, cfg, device=device, n_slots=args.slots,
        chunk_samples=args.chunk_samples, beam=args.beam, qos=args.qos,
        read_until=read_until, co_batch=not args.split_tick,
        history_limit=args.history_limit or None,
        async_dispatch=args.async_dispatch,
        max_queue=args.max_queue, queue_timeout_s=args.queue_timeout)
    if args.warmup:
        t0 = time.perf_counter()
        n = engine.warmup()
        print(f"[serve] warmup: {n} tick plans run in "
              f"{time.perf_counter() - t0:.2f}s")
    r = engine.runner
    if args.stream:
        print(f"[serve] engine ({type(r).__name__} on {device}): "
              f"{args.requests} LIVE reads (rate {args.rate}/s, "
              f"{PORE_HZ:.0f} samples/s per pore), {args.slots} slots, "
              f"chunk {r.core} samples (halo {r.halo}), qos={args.qos}")
        run_streamed(engine, args)
        return
    reqs = build_reads(args)
    print(f"[serve] engine ({type(r).__name__} on {device}): "
          f"{args.requests} reads over {reqs[-1].arrival_time:.2f}s "
          f"(rate {args.rate}/s), {args.slots} slots, chunk {r.core} "
          f"samples (halo {r.halo}), "
          f"{'prefix-beam ' + str(args.beam) if args.beam else 'greedy'} "
          f"CTC merge")
    run(engine, reqs)
    s = engine.metrics.summary()
    print(f"[serve] done: {s['requests_done']} reads, "
          f"{s['generated_tokens']} bases in {s['elapsed_s']:.2f}s "
          f"({s['requests_done'] / max(s['elapsed_s'], 1e-9):.2f} reads/s, "
          f"{s['tokens_per_s']:.0f} bases/s)")
    if read_until is not None:
        print(f"[serve] read-until: {s['ejections']:.0f} ejections | "
              f"samples saved {s['samples_saved']:.0f} | basecalled "
              f"{s['ejected_consumed_samples']:.0f} samples on ejected "
              f"reads")
    print_tick_report(s, args)
    done = engine.drain_completed()
    if done:
        print("[serve] sample:", done[min(done)].out_tokens[:16])


if __name__ == "__main__":
    main()
