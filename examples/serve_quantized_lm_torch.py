"""Serve a (smoke-scale) LM through the port's continuous-batching
engine with RUBICON-style weight quantization — packed int8/int4
weights consumed directly by the engine, plus per-request
``SamplingParams`` (a mixed greedy + sampled request stream shares every
decode batch).

The twin of ``examples/serve_quantized_lm.py``, on ``repro_torch``.
As there, the weights are packed by ``quantize_tree`` without setting
the config's quantization policy, so every projection dequantizes its
packed weight on read. Runs on CUDA; ``--device cpu`` runs it on the
CPU.

Run: PYTHONPATH=src python examples/serve_quantized_lm_torch.py \
         [--arch qwen1.5-4b] [--wbits 8] [--requests 8] [--tokens 12] \
         [--device cpu]
Compares bf16 vs packed-int engine decode throughput and prints the
weight read of one decode step of the full config on one H100, from
the H100 roofline table (``analysis/roofline.py``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.analysis.roofline import HBM_BW
from repro_torch.config import QuantPolicy, get_config
from repro_torch.core.quant.policy import quantize_tree
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving.engine import Request
from repro_torch.serving.sampling import SamplingParams


def serve_stream(params, cfg, args, label, device):
    """Drain a mixed greedy+sampled stream twice (warm, then timed);
    returns (decode tok/s, outputs) — outputs are deterministic, so the
    two drains must agree token-for-token."""
    engine = api.make_serving_engine(params, cfg, device=device,
                                     n_slots=args.slots,
                                     cache_len=args.prompt_len + args.tokens,
                                     prefill_chunk=8,
                                     cache_dtype=getattr(torch, cfg.dtype))
    rs = np.random.RandomState(0)
    workload = []
    for i in range(args.requests):
        prompt = rs.randint(1, cfg.vocab_size, size=args.prompt_len).tolist()
        sp = (SamplingParams(max_new_tokens=args.tokens, temperature=0.7,
                             top_k=16, top_p=0.95, seed=i)
              if i % 2 else SamplingParams(max_new_tokens=args.tokens))
        workload.append((prompt, sp))

    def drain():
        engine.reset_stats()
        for i, (prompt, sp) in enumerate(workload):
            engine.submit(Request(rid=i, prompt=list(prompt), sampling=sp))
        done = engine.run()
        return {i: r.out_tokens for i, r in done.items()}

    first = drain()                       # warm
    t0 = time.time()
    second = drain()
    dt = time.time() - t0
    assert first == second, "sampled decode must be deterministic"
    s = engine.metrics.summary()
    print(f"[{label}] {s['generated_tokens']} tokens in {dt:.2f}s "
          f"({s['decode_tokens_per_s']:.1f} tok/s decode, "
          f"{args.requests // 2} sampled + "
          f"{args.requests - args.requests // 2} greedy requests)")
    return s["decode_tokens_per_s"], second


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--wbits", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch + "-smoke")
    full = get_config(args.arch)
    params = api.init_params(0, cfg, device=device)

    tps_fp, _ = serve_stream(params, cfg, args, "engine bf16", device)
    qt = quantize_tree(params, QuantPolicy(weight_bits=args.wbits),
                       min_size=256)
    tps_q, _ = serve_stream(qt, cfg, args, f"engine int{args.wbits}",
                            device)
    print(f"[smoke] packed int{args.wbits} vs bf16 decode: "
          f"{tps_q:.1f} vs {tps_fp:.1f} tok/s ({device.type} wall time; "
          f"the packed weights dequantize on read here, the config "
          f"carrying no weight bits)")

    # one-H100 projection at full scale: decode is weight+cache
    # bandwidth bound
    n_params = api.active_params(full)
    w_bf16 = 2 * n_params / HBM_BW
    w_q = (args.wbits / 8) * n_params / HBM_BW
    print(f"[H100 projection, {full.name} on one H100 SXM5 80GB] "
          f"weight-read per decode step: bf16 {w_bf16*1e3:.2f} ms -> "
          f"int{args.wbits} {w_q*1e3:.2f} ms ({w_bf16/w_q:.2f}x)")
    print("done.")


if __name__ == "__main__":
    main()
