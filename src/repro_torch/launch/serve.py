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

Token LMs (the dense family)
----------------------------
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
read). The run ends with tok/s, TTFT percentiles, the decode interval,
pool utilisation, preemptions and the resolved attention backend.

Runs on CUDA; ``--device cpu`` runs the plain PyTorch versions on the
CPU instead. Without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.config import QuantPolicy, get_config
from repro_torch.core.quant.policy import quantize_tree
from repro_torch.models import api


def quantize_for_serving(params, wbits: int):
    return quantize_tree(params, QuantPolicy(weight_bits=wbits, act_bits=0))


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
    """Poisson arrivals of random-token prompts (the reference's stream)."""
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
        reqs.append(Request(rid=i, prompt=prompt, sampling=sp,
                            arrival_time=float(arrivals[i])))
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


def build_lm_engine(cfg, args, device):
    """Seeded parameters drawn on ``device``, packed under ``--wbits``,
    and the engine over them."""
    if args.wbits:
        cfg = replace(cfg, quant=QuantPolicy(weight_bits=args.wbits,
                                             act_bits=0))
    params = api.init_params(0, cfg, device=device)
    if args.wbits:
        params = quantize_for_serving(params, args.wbits)
        print(f"[serve] weights quantized to int{args.wbits} (packed; "
              f"projections run the qmatmul kernel)")
    engine = api.make_serving_engine(
        params, cfg, device=device, n_slots=args.slots,
        cache_len=args.cache_len or args.prompt_len + args.tokens,
        prefill_chunk=args.prefill_chunk,
        max_prefill_tokens=args.max_prefill_tokens,
        cache_dtype=getattr(torch, cfg.dtype), block_len=args.block_len,
        n_blocks=args.n_blocks, async_dispatch=args.async_dispatch,
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
          f"{by['pos'] / 2 ** 20:.2f} pos), cache quantization "
          f"{pool.quant_policy.describe()}")
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
          f"{s['decode_interval_p99_s'] * 1e3:.1f}ms")
    print(f"[serve] pool util mean {s['pool_util_mean']:.2f} max "
          f"{s['pool_util_max']:.2f} | preemptions {s['preemptions']:.0f} | "
          f"attn backend {engine.runner.attn_backend}")
    print_tick_report(s, args)
    done = engine.drain_completed()
    if done:
        print("[serve] sample:", done[min(done)].out_tokens[:16])


def print_tick_report(s, args) -> None:
    print(f"[serve] ticks ({'async' if args.async_dispatch else 'sync'}): "
          f"p50 {s['tick_latency_p50_s'] * 1e3:.2f}ms "
          f"p99 {s['tick_latency_p99_s'] * 1e3:.2f}ms | queue hwm "
          f"{s['queue_depth_hwm']:.0f} | rejected {s['rejections']:.0f} | "
          f"plans {s['plans']:.0f} ({s['plans_warmed']:.0f} warmed), "
          f"hits {s['bucket_hits']:.0f} misses {s['bucket_misses']:.0f}")


# ---------------------------------------------------------------------------
# Entry point


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="rubicall")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
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
    args = ap.parse_args(argv)

    device = api.resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    if cfg.family != "basecaller":
        run_lm(cfg, args, device)
        return
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    if args.wbits:
        params = quantize_for_serving(params, args.wbits)
        print(f"[serve] weights quantized to int{args.wbits} (packed)")
    engine = api.make_serving_engine(
        params, cfg, device=device, n_slots=args.slots,
        chunk_samples=args.chunk_samples, beam=args.beam,
        async_dispatch=args.async_dispatch, max_queue=args.max_queue,
        queue_timeout_s=args.queue_timeout)
    if args.warmup:
        t0 = time.perf_counter()
        n = engine.warmup()
        print(f"[serve] warmup: {n} tick plans run in "
              f"{time.perf_counter() - t0:.2f}s")
    reqs = build_reads(args)
    r = engine.runner
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
    print_tick_report(s, args)
    done = engine.drain_completed()
    if done:
        print("[serve] sample:", done[min(done)].out_tokens[:16])


if __name__ == "__main__":
    main()
