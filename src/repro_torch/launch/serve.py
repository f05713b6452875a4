"""Serving launcher (basecaller archs, offline reads).

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

Runs on CUDA; ``--device cpu`` runs the plain PyTorch versions on the
CPU instead. Without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import time

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
    args = ap.parse_args(argv)

    device = api.resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    if cfg.family != "basecaller":
        raise SystemExit(f"[serve] error: {cfg.name!r} is not a basecaller "
                         f"(only the basecaller family is ported)")
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
    print(f"[serve] ticks ({'async' if args.async_dispatch else 'sync'}): "
          f"p50 {s['tick_latency_p50_s'] * 1e3:.2f}ms "
          f"p99 {s['tick_latency_p99_s'] * 1e3:.2f}ms | queue hwm "
          f"{s['queue_depth_hwm']:.0f} | rejected {s['rejections']:.0f} | "
          f"plans {s['plans']:.0f} ({s['plans_warmed']:.0f} warmed), "
          f"hits {s['bucket_hits']:.0f} misses {s['bucket_misses']:.0f}")
    done = engine.drain_completed()
    if done:
        print("[serve] sample:", done[min(done)].out_tokens[:16])


if __name__ == "__main__":
    main()
