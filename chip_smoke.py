#!/usr/bin/env python3
"""Smoke-run the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build  — compile every CUDA source of the port with nvcc (one
   process per source, started together) and print the build seconds
   and ptxas's register/shared-memory report.
2. kernel — hold each kernel against its plain PyTorch version on the
   card at the main path's shapes (qconv1d_block: C=344, every RUBICALL
   k, B=4, T=2500 and a ragged T, ReLU on and off; fp32 with TF32 off
   at 1e-3, bf16 at one bf16 ulp), then time kernel, plain version,
   the library composition and the computed bound at B=4, T=2500.
3. serve  — full-width RUBICALL (28 blocks, C=344, bf16), random
   seeded weights packed to int8 as ``launch/serve.py --wbits 8`` does,
   served through the port's ServingEngine (4 slots, 1024-sample
   chunks, warmup) on 8 simulated reads. Checks every read finishes,
   the kernel launched 19 times per forward, and one tick's log-probs
   through the kernels agree with the same tick through the plain
   versions on the card.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero
without CUDA, and when run outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
import types
from dataclasses import replace
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.config import QuantPolicy, get_config  # noqa: E402
from repro_torch.core.quant.policy import quantize_tensor  # noqa: E402
from repro_torch.kernels import _build, ops, qconv1d, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.basecaller import model as bc  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s
# by operand type (bf16 on tensor cores, fp32 on CUDA cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

C = 344                       # RUBICALL width
B = 4                         # serving slots -> windows per forward
T_MAIN = 2500                 # frames per 7500-sample serving window
T_RAGGED = 1001               # not a multiple of the kernel's frame tile
KS = (5, 9, 25, 31, 55, 75)   # every RUBICALL kernel size
KERNEL_BLOCKS = range(5, 24)  # blocks 05-23 take qconv1d under --wbits 8
# fp32: the reference test's tolerance (tests/test_kernels.py). bf16:
# kernel and plain version both round an fp32 result to bf16, and their
# different fp32 summation orders can land on either side of a rounding
# boundary: one bf16 ulp, at most 2^-7 relative; atol covers fp32 order
# noise near zero (~1e2-sized terms, ~400 of them).
TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (2 ** -7, 1e-2)}
# one served tick, kernel path vs plain path: (mean, max) |d log-prob|
# and the least share of frames whose argmax agrees. As served (bf16,
# 8- and 4-bit activation fake-quant), a one-ulp difference of a block
# output can flip an activation grid step (1/7 of the tensor's max at 4
# bits) and that flip propagates: the first chip run measured mean 0.023,
# max 0.51, 99.7% agreement (PERF.md). In fp32 with the activation
# quantizers off only the fp32 summation order differs.
TICK_BF16 = (0.05, 2.0, 0.99)
TICK_FP32 = (1e-4, 1e-3, 0.999)


def qconv1d_bytes(b: int, t: int, c: int, k: int, esize: int) -> int:
    """Least bytes the function moves: x and y once, weights, scales."""
    return (b * (t + k - 1) * c * esize + k * c + c * c + 4 * c * 4
            + b * t * c * esize)


def qconv1d_flops(b: int, t: int, c: int, k: int) -> int:
    """Depthwise k-tap FMAs plus the C x C pointwise product."""
    return 2 * b * t * c * (k + c)


def bound_ms(nbytes: int, flops: int, dtype) -> tuple:
    """(least ms on an H100, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` (L2 warm, as inside a forward)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def qconv_inputs(rs: np.random.RandomState, b: int, t: int, k: int, dtype):
    """Padded x and packed weights for one kernel call, on the card."""
    dev = "cuda"
    x = torch.from_numpy(rs.randn(b, t + k - 1, C).astype(np.float32))
    dw = quantize_tensor(torch.from_numpy(rs.randn(k, C).astype(np.float32)), 8)
    pw = quantize_tensor(torch.from_numpy(rs.randn(C, C).astype(np.float32)), 8)
    g = torch.from_numpy(rs.rand(1, C).astype(np.float32))
    bt = torch.from_numpy(rs.randn(1, C).astype(np.float32))
    return (x.to(dev, dtype), dw.data.to(dev), pw.data.to(dev),
            dw.scale.to(dev), pw.scale.to(dev), g.to(dev), bt.to(dev))


def library_qconv(args):
    """The same function (no ReLU, as RUBICALL's blocks call it) from
    library calls, timed only and never used by the port: cuDNN
    depthwise conv + cuBLAS linear with beta as bias."""
    xp, dw_q, pw_q, dws, pws, g, bt = args
    w_dw = (dw_q.float() * dws).t().unsqueeze(1).to(xp.dtype)   # (C, 1, k)
    w_pw = (pw_q.float() * pws * g).t().contiguous().to(xp.dtype)
    xc = xp.transpose(1, 2).contiguous()                       # (B, C, Tp)
    bias = bt.reshape(-1).to(xp.dtype)
    return lambda: F.linear(F.conv1d(xc, w_dw, groups=C).transpose(1, 2),
                            w_pw, bias)


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] nvcc {built or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, log in _build.LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernel() -> dict:
    """Kernel vs plain version at every shape, then the timings."""
    rs = np.random.RandomState(0)
    err_main = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = TOL[dtype]
        for k in KS:
            for t in (T_MAIN, T_RAGGED):
                args = qconv_inputs(rs, B, t, k, dtype)
                for relu in (True, False):
                    got = qconv1d.qconv1d_block_cuda(*args, relu=relu)
                    want = ref.qconv1d_block_ref(*args, relu=relu)
                    torch.cuda.synchronize()
                    if got.shape != (B, t, C) or got.dtype != dtype:
                        raise AssertionError(f"qconv1d {tuple(got.shape)} "
                                             f"{got.dtype}")
                    torch.testing.assert_close(got.float(), want.float(),
                                               rtol=rtol, atol=atol)
                    err = float((got.float() - want.float()).abs().max())
                    print(f"[kernel] qconv1d_block {str(dtype)[6:]} k={k} "
                          f"T={t} relu={int(relu)}: max|err| {err:.3g} ok")
                    if dtype == torch.bfloat16 and t == T_MAIN:
                        err_main = max(err_main, err)
    per_k = {}
    for k in KS:
        args = qconv_inputs(rs, B, T_MAIN, k, torch.bfloat16)
        nb = qconv1d_bytes(B, T_MAIN, C, k, 2)
        bms, by = bound_ms(nb, qconv1d_flops(B, T_MAIN, C, k), torch.bfloat16)
        # relu=False: each RUBICALL block has one repeat, and sep_conv
        # calls the kernel without ReLU for a block's last repeat
        row = {
            "ms": median_ms(lambda: qconv1d.qconv1d_block_cuda(
                *args, relu=False)),
            "plain_ms": median_ms(lambda: ref.qconv1d_block_ref(
                *args, relu=False), iters=5),
            "library_ms": median_ms(library_qconv(args)),
            "bound_ms": bms, "bound_by": by}
        per_k[k] = row
        print(f"[kernel] qconv1d_block bf16 B={B} T={T_MAIN} C={C} k={k}: "
              f"kernel {row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms "
              f"| library {row['library_ms']:.4f} ms | bound "
              f"{bms * 1e3:.2f} us ({by})")
    return {"err_main": err_main, "per_k": per_k}


def unit_gain(params) -> None:
    """Rescale each separable conv's random taps to unit gain. With the
    reference's init scale (dw std 0.2, pw std 0.02) a block's gain is
    0.12-0.35 in std, so some 15 blocks in the activations fall under
    the activation quantizer's 1e-8 scale floor and round to zero; a
    trained network's folded BN keeps them O(1), as this does."""
    for name, blk in params.items():
        if not name.startswith("block"):
            continue
        for rep in blk.values():
            if isinstance(rep, dict) and "dw" in rep:
                dw, pw = rep["dw"], rep["pw"]
                rep["dw"] = dw / (dw.std() * dw.shape[0] ** 0.5)
                rep["pw"] = pw * (2.0 / pw.shape[1]) ** 0.5 / pw.std()


def tick_both_paths(runner, cfg, window):
    """One batched window forward through the kernels and through the
    plain versions (the kernel wrapper swapped for its plain version),
    on the card; checks the log-probs' shape and finiteness."""
    wins, start, rlen = (torch.from_numpy(a).to(runner.device)
                         for a in window)
    out = []
    for plain in (False, True):
        swap = (mock.patch.object(qconv1d, "qconv1d_block_cuda",
                                  ref.qconv1d_block_ref)
                if plain else contextlib.nullcontext())
        with torch.inference_mode(), swap:
            out.append(bc.forward_window(runner.params, runner.state, wins,
                                         cfg, start, rlen).float())
    frames = wins.shape[1] // runner.stride
    for lp in out:
        if lp.shape != (B, frames, cfg.n_bases) or \
                not bool(torch.isfinite(lp).all()):
            raise AssertionError(f"log-probs {tuple(lp.shape)} not finite "
                                 f"or not ({B}, {frames}, {cfg.n_bases})")
    return out


def trace_tick(runner, window) -> None:
    """Where one served tick's time goes. Without the profiler: host time
    to enqueue the forward, device time from enqueue to end (CUDA
    events), and wall time to the readback. Under torch.profiler (CUPTI):
    the device time of every kernel, summed and by kernel."""
    from torch.profiler import ProfilerActivity, profile
    fwd = runner.plans.fn(runner._plan_key)
    runner._forward(fwd, *window)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    lp = runner._forward(fwd, *window)
    b.record()
    t_host = time.perf_counter() - t0
    lp.cpu()
    t_wall = time.perf_counter() - t0
    print(f"[trace] one tick: host enqueue {t_host * 1e3:.2f} ms, device "
          f"{a.elapsed_time(b):.2f} ms from first enqueue to last kernel, "
          f"wall to readback {t_wall * 1e3:.2f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner._forward(fwd, *window).cpu()
        t_prof = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    print(f"[trace] same tick under torch.profiler: device kernels "
          f"{busy:.2f} ms in {sum(r[1] for r in rows)} launches, wall "
          f"{t_prof * 1e3:.2f} ms (device busy {busy / (t_prof * 1e3):.1%})")
    for us, n, key in rows[:8]:
        print(f"[trace]   {us / 1e3:8.3f} ms  {n:4d}x  {key[:90]}")


def phase_serve() -> dict:
    cfg = get_config("rubicall")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    unit_gain(params)
    params = serve.quantize_for_serving(params, 8)
    engine = api.make_serving_engine(params, cfg, device="cuda", n_slots=B,
                                     chunk_samples=1024)
    runner = engine.runner
    t0 = time.perf_counter()
    engine.warmup()
    print(f"[serve] rubicall {cfg.n_blocks} blocks C={cfg.channels[0]} "
          f"{cfg.dtype}, window {runner.core + 2 * runner.halo} samples; "
          f"warmup {time.perf_counter() - t0:.2f}s")
    reads = serve.build_reads(types.SimpleNamespace(
        requests=8, rate=1.0, read_bases=300))
    ops.reset_launch_counts()
    # all reads queued up front: the batch composition, and so the bases
    # (activation fake-quant scales span the batch), repeat run to run
    for r in reads:
        engine.submit(r)
    engine.run()
    torch.cuda.synchronize()
    launches = ops.launch_counts()["qconv1d_block"]
    st = engine.metrics.summary()
    forwards = st["bucket_hits"] + st["bucket_misses"]
    done = engine.completed
    if len(done) != len(reads) or any(r.status != "finished"
                                       for r in done.values()):
        raise AssertionError(f"reads not all finished: "
                             f"{[(r.rid, r.status) for r in done.values()]}")
    if forwards < 1 or launches != len(KERNEL_BLOCKS) * forwards:
        raise AssertionError(f"qconv1d_block launched {launches} times in "
                             f"{forwards} forwards, want "
                             f"{len(KERNEL_BLOCKS)} per forward")
    ticks = list(engine.metrics.tick_latency_samples)
    print(f"[serve] {st['requests_done']} reads, {st['generated_tokens']} "
          f"bases in {st['elapsed_s']:.3f}s: "
          f"{st['requests_done'] / st['elapsed_s']:.2f} reads/s, "
          f"{st['tokens_per_s']:.0f} bases/s | {forwards} forwards, "
          f"tick p50 {st['tick_latency_p50_s'] * 1e3:.2f} ms mean "
          f"{1e3 * sum(ticks) / len(ticks):.2f} ms | qconv1d_block "
          f"launches {launches} = {len(KERNEL_BLOCKS)} x {forwards}")

    # one tick, kernel path vs the plain versions on the card: as served
    # (bf16, activation fake-quant on), then in fp32 with the activation
    # quantizers off (same 19 kernel blocks; no grid step can flip)
    chunks = [runner.make_chunks(r)[0].payload for r in reads[:B]]
    window = (np.stack([c[0] for c in chunks]),
              np.array([c[3] for c in chunks], np.int32),
              np.array([c[4] for c in chunks], np.int32))
    exact = replace(cfg, dtype="float32", quant=QuantPolicy(
        8, 0, overrides=tuple((p, (w, 0)) for p, (w, _) in
                              cfg.quant.overrides)))
    for name, c, bound in (("bf16 as served", cfg, TICK_BF16),
                           ("fp32, no act-quant", exact, TICK_FP32)):
        lp_k, lp_p = tick_both_paths(runner, c, window)
        d = (lp_k - lp_p).abs()
        agree = float((lp_k.argmax(-1) == lp_p.argmax(-1)).float().mean())
        print(f"[serve] one tick kernel vs plain, {name}: mean|d logp| "
              f"{float(d.mean()):.3g} max {float(d.max()):.3g}, argmax "
              f"agree {agree:.4f}")
        if float(d.mean()) > bound[0] or float(d.max()) > bound[1] \
                or agree < bound[2]:
            raise AssertionError(f"served tick ({name}): kernel path "
                                 f"disagrees with the plain path")
    trace_tick(runner, window)
    return {"launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    phase_build()
    kern = phase_kernel()
    served = phase_serve()
    pk = kern["per_k"]
    blocks_k = [get_config("rubicall").kernel_sizes[i] for i in KERNEL_BLOCKS]

    def total(key):
        return sum(pk[k][key] for k in blocks_k)
    kernels = [{
        "name": "qconv1d_block", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/qconv1d.cu",
        "replaces": "src/repro/kernels/qconv1d.py:38",
        "launches": served["launches"], "max_abs_err": kern["err_main"],
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": pk[max(blocks_k)]["bound_by"],
        "library_ms": total("library_ms"),
        "shape": f"sum over one forward's {len(blocks_k)} launches, bf16 "
                 f"B={B} T={T_MAIN} C={C} k={blocks_k}",
        "per_k": {str(k): v for k, v in pk.items()},
    }]
    print(f"[chip_smoke] all phases ok in {time.perf_counter() - t0:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
