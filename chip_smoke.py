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
4. kernel (LM) — hold qmatmul (int8 and int4 at every qwen1.5-4b
   projection shape, M = 4 and 64, a ragged shape) and the paged
   attention kernels (qwen1.5-4b's 20 x 128 heads and chatglm3-6b's 2
   KV heads x group 16; block_len 16; fp32, bf16, fp8 and int8 arenas;
   holes, out-of-order blocks, pad rows, a ring window; C = 1, 4, 16)
   against their plain versions, then time kernel, plain version,
   library call and bound at the served shapes.
5. serve (LM) — full-width qwen1.5-4b (40 layers, d 2560, no depth
   cut), seeded random weights drawn on the card and packed to int8
   under QuantPolicy(8, 0), a bf16 paged arena (block_len 16), 4 slots,
   prefill chunk 16, warmup; 8 greedy and 2 sampled requests of 32-128
   prompt tokens and 32 new tokens. Checks every request finishes, the
   kernel launches reconcile with the ticks the plans ran (281 qmatmul
   per tick, 40 attention launches per tick: gqa_paged on C = 1 ticks,
   gqa_paged_chunk on wider ones), and one mixed and one decode tick
   through the kernels agree with the same ticks through the plain
   versions on the same pool state.
6. trace (LM) — host enqueue, device and wall time of one decode and
   one mixed tick, then the device busy share and top kernels under
   torch.profiler.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero
without CUDA, and when run outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import functools
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
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import qmatmul as qmm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.basecaller import model as bc  # noqa: E402
from repro_torch.models.lm import transformer as tfm  # noqa: E402
from repro_torch.serving.engine import Request  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402

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


def device_ms(calls, reps: int = 5) -> float:
    """Median device time of one call of ``calls`` run back to back with
    the host out of the way: a sleep kernel holds the stream while the
    host enqueues every call, and the CUDA events bracket device work
    only. ``calls`` read distinct copies of their weights or arenas, so
    these come from HBM, as on the served path, not from L2."""
    for fn in calls[:2]:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    # sleep for twice the host's time to enqueue (and run) the calls, in
    # cycles of an SM clock of at most 2 GHz
    cycles = int((time.perf_counter() - t0) * 4e9) + 1_000_000
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for fn in calls:
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / len(calls))
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


def trace(label: str, enqueue) -> dict:
    """Where one served tick's time goes. ``enqueue()`` enqueues the
    tick and returns its output on the card. Without the profiler: host
    time to enqueue, device time from the first enqueue to the last
    kernel (CUDA events), and wall time to the readback. Under
    torch.profiler (CUPTI): the device time of every kernel, summed and
    by kernel."""
    from torch.profiler import ProfilerActivity, profile
    enqueue()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = enqueue()
    b.record()
    t_host = time.perf_counter() - t0
    out.cpu()
    t_wall = time.perf_counter() - t0
    print(f"[trace] {label}: host enqueue {t_host * 1e3:.2f} ms, device "
          f"{a.elapsed_time(b):.2f} ms from first enqueue to last kernel, "
          f"wall to readback {t_wall * 1e3:.2f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enqueue().cpu()
        t_prof = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    print(f"[trace] {label} under torch.profiler: device kernels "
          f"{busy:.2f} ms in {sum(r[1] for r in rows)} launches, wall "
          f"{t_prof * 1e3:.2f} ms (device busy {busy / (t_prof * 1e3):.1%})")
    for us, n, key in rows[:8]:
        print(f"[trace]   {us / 1e3:8.3f} ms  {n:4d}x  {key[:90]}")
    return {"host_ms": t_host * 1e3, "device_ms": a.elapsed_time(b),
            "wall_ms": t_wall * 1e3, "busy_ms": busy}


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
    fwd = runner.plans.fn(runner._plan_key)
    trace("one tick", lambda: runner._forward(fwd, *window))
    return {"launches": launches}

# ---------------------------------------------------------------------------
# LM slice: full-width qwen1.5-4b

LM_ARCH = "qwen1.5-4b"
LM_SLOTS = 4
LM_CHUNK = 16                 # prefill chunk
LM_CACHE = 256                # per-request KV capacity -> 16 blocks/slot
BLOCK = 16                    # block_len
HD = 128                      # head_dim (qwen1.5-4b and chatglm3-6b)
# (K, N) of qwen1.5-4b's projections and how often a layer runs each:
# wq, wk, wv, wo; wi, wg; the MLP's wo. lm_head once per tick.
QWEN_PROJ = {(2560, 2560): 4, (2560, 6912): 2, (6912, 2560): 1}
QWEN_HEAD = (2560, 151936)
# the reference tests' tolerances: fp32 arenas 1e-5; bf16, fp8 and int8
# arenas (bf16 compute) and qmatmul 2e-2
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2,
            torch.float8_e4m3fn: 2e-2, torch.int8: 2e-2}
QMM_TOL = 2e-2
# One served tick, kernel path vs plain path on the same pool state:
# (largest |d logit| of a live row, least share of live rows whose
# argmax agrees). Bounds stated before the first run on the card. With
# seeded random weights (std 0.02) the final norm and the 2560-wide
# head give logits of std ~1. bf16 as served: both paths round every
# projection's fp32 sum to bf16 but in other summation orders, so a
# one-ulp difference (2^-8 relative) can start in any of 281 products
# per tick and carry through 40 residual layers: a few hundredths
# expected, 0.25 allowed; an argmax may flip where the top two logits
# are that close. fp32 compute (same weights and bf16 arena): only fp32
# summation order and the odd bf16 arena rounding that it moves.
LM_TICK_BF16 = (0.25, 0.5)
LM_TICK_FP32 = (0.02, 0.75)


def paged_inputs(rs, b, hkv, group, c, fills, arena, *, holes=(),
                 t_blocks=LM_CACHE // BLOCK, q_dtype=torch.bfloat16):
    """Paged attention inputs on the card as the read sees them mid-tick:
    row i has positions [0, fills[i] + c) written (its c query tokens
    last) in arena blocks handed out in random order; every other byte
    is stale (99.0); ``holes`` (i, j) punches table entry j of row i back
    to -1 with its positions emptied. ``arena`` is the storage dtype
    (int8 comes with its fp32 scale arenas)."""
    bl, T = BLOCK, t_blocks
    n_blocks = b * T + 3
    k = torch.full((n_blocks, bl, hkv, HD), 99.0)
    v = torch.full((n_blocks, bl, hkv, HD), 99.0)
    table = torch.full((b, T), -1, dtype=torch.int32)
    pos = torch.full((b, T * bl), pa.EMPTY_POS, dtype=torch.int32)
    free = list(rs.permutation(n_blocks))
    t = torch.zeros((b, c), dtype=torch.int32)
    for i, n in enumerate(fills):
        t[i] = torch.arange(n, n + c)
        for j in range(-(-(n + c) // bl)):
            table[i, j] = int(free.pop())
        p = torch.arange(n + c)
        blk, off = table[i, p // bl].long(), p % bl
        k[blk, off] = torch.from_numpy(rs.randn(n + c, hkv, HD).astype(
            np.float32))
        v[blk, off] = torch.from_numpy(rs.randn(n + c, hkv, HD).astype(
            np.float32))
        pos[i, :n + c] = p.to(torch.int32)
    for i, j in holes:
        table[i, j] = -1
        pos[i, j * bl:(j + 1) * bl] = pa.EMPTY_POS
    if arena == torch.int8:
        (k, ks), (v, vs) = pa.quantize_kv(k), pa.quantize_kv(v)
        ks, vs = ks.cuda(), vs.cuda()
    else:
        k, v, ks, vs = k.to(arena), v.to(arena), None, None
    q = torch.from_numpy(rs.randn(b, c, hkv * group, HD).astype(np.float32))
    return dict(q=q.to("cuda", q_dtype), k=k.cuda(), v=v.cuda(), k_scale=ks,
                v_scale=vs, pos=pos.cuda(), t=t.cuda(), table=table.cuda())


def attn_call(x, fn_chunk, fn_single):
    """(kernel-or-plain) call on ``paged_inputs``: the single-token
    function for C == 1 (q folded to (B, Hkv, group, hd)), the chunk
    function otherwise; returns (B, C, H*hd)."""
    q = x["q"]
    B, Cq, H, hd = q.shape
    hkv = x["k"].shape[2]
    kw = dict(window=x.get("window", 0), k_scale=x["k_scale"],
              v_scale=x["v_scale"])
    if Cq == 1:
        return fn_single(q.reshape(B, hkv, H // hkv, hd), x["k"], x["v"],
                         x["pos"], x["t"][:, 0].contiguous(), x["table"],
                         **kw).reshape(B, 1, H * hd)
    return fn_chunk(q, x["k"], x["v"], x["pos"], x["t"], x["table"], **kw)


def attn_kernel(x):
    return attn_call(x, pa.gqa_paged_chunk_cuda, pa.gqa_paged_cuda)


def attn_plain(x):
    return attn_call(x, ref.gqa_paged_chunk_ref, ref.gqa_paged_ref)


def attn_library(x):
    """Gather + F.scaled_dot_product_attention with the validity mask:
    the same function from library calls, timed only, never used by the
    port."""
    q, k, v, pos, t, table = (x[n] for n in ("q", "k", "v", "pos", "t",
                                             "table"))
    B, Cq, H, hd = q.shape
    hkv, bl = k.shape[2], k.shape[1]
    L = table.shape[1] * bl

    def fn():
        idx = table.long().clamp(min=0)
        kr = k[idx].reshape(B, L, hkv, hd).transpose(1, 2).to(q.dtype)
        vr = v[idx].reshape(B, L, hkv, hd).transpose(1, 2).to(q.dtype)
        mask = (pos[:, None, :] >= 0) & (pos[:, None, :] <= t[:, :, None])
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kr, vr, attn_mask=mask[:, None],
            enable_gqa=H != hkv)
    return fn


def library_qmatmul(x, w_q, scale):
    """The same function from library calls (dequantize to x's dtype,
    ``torch.matmul``, scale), timed only, never used by the port."""
    return torch.matmul(x, w_q.to(x.dtype)) * scale


def attn_bound(x) -> tuple:
    """Least time for one call on this run's data: each assigned block's
    K and V (and positions) read once, q and t read, out written; 4 flops
    per query row, head dim and cached position of an assigned block."""
    q, k = x["q"], x["k"]
    B, Cq, H, hd = q.shape
    hkv, bl = k.shape[2], k.shape[1]
    blocks = int((x["table"] >= 0).sum())
    kv = blocks * bl * hkv * hd * k.element_size() * 2
    if x["k_scale"] is not None:
        kv += blocks * bl * hkv * 4 * 2
    nbytes = (kv + blocks * bl * 4 + 2 * q.numel() * q.element_size()
              + x["t"].numel() * 4 + x["table"].numel() * 4)
    flops = 4 * blocks * bl * Cq * H * hd
    return bound_ms(nbytes, flops, torch.bfloat16)


def phase_lm_kernel() -> dict:
    """qmatmul and paged attention vs their plain versions, then timed."""
    rs = np.random.RandomState(1)
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    err = {"qmatmul": 0.0, "gqa_paged": 0.0, "gqa_paged_chunk": 0.0}
    # ---- qmatmul: every projection shape, int8 and int4, M = 4 and 64
    shapes = [(m, k, n, bits, torch.bfloat16)
              for (k, n) in list(QWEN_PROJ) + [QWEN_HEAD]
              for m in (4, 64) for bits in (8, 4)]
    shapes += [(5, 37, 50, 4, torch.float32), (130, 301, 200, 8,
                                                torch.bfloat16)]
    for m, k, n, bits, dt in shapes:
        w = quantize_tensor(randn(k, n), bits)
        x = randn(m, k).to(dt)
        got = qmm.qmatmul_cuda(x, w.data, w.scale, bits=bits)
        want = ref.qmatmul_ref(x, w.data, w.scale, bits=bits)
        torch.cuda.synchronize()
        if got.shape != (m, n) or got.dtype != dt:
            raise AssertionError(f"qmatmul {tuple(got.shape)} {got.dtype}")
        torch.testing.assert_close(got.float(), want.float(), rtol=QMM_TOL,
                                   atol=QMM_TOL)
        e = float((got.float() - want.float()).abs().max())
        if dt == torch.bfloat16 and bits == 8 and (k, n) != (301, 200):
            err["qmatmul"] = max(err["qmatmul"], e)
        print(f"[kernel] qmatmul int{bits} {str(dt)[6:]} M={m} K={k} N={n}: "
              f"max|err| {e:.3g} ok")
    # ---- paged attention: qwen1.5-4b heads and chatglm3-6b's GQA
    cases = [(hkv, group, c, arena, 0)
             for hkv, group in ((20, 1), (2, 16))
             for arena in ATTN_TOL for c in (1, 4, 16)]
    cases.append((20, 1, 4, torch.bfloat16, 40))           # ring window
    for hkv, group, c, arena, window in cases:
        x = paged_inputs(rs, 4, hkv, group, c, [LM_CACHE - c, BLOCK - 1, 0,
                                                159], arena,
                         holes=[(0, 5)],
                         q_dtype=(torch.float32 if arena == torch.float32
                                  else torch.bfloat16))
        x["t"][3, 1:] = -1                 # a decode row padded to C
        if c == 1:
            x["t"][2] = -1                 # a free slot
        x["window"] = window
        got, want = attn_kernel(x), attn_plain(x)
        torch.cuda.synchronize()
        live = x["t"] >= 0
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("gqa_paged: non-finite output")
        tol = ATTN_TOL[arena]
        torch.testing.assert_close(got.float()[live], want.float()[live],
                                   rtol=tol, atol=tol)
        e = float((got.float() - want.float())[live].abs().max())
        name = "gqa_paged" if c == 1 else "gqa_paged_chunk"
        if (hkv, arena, window) == (20, torch.bfloat16, 0):
            err[name] = max(err[name], e)
        print(f"[kernel] {name} Hkv={hkv} group={group} C={c} "
              f"{str(arena)[6:]} window={window}: max|err| {e:.3g} ok")
    # ---- device times at the served shapes (bf16, 4 slots), each call
    # on its own copy of the weights or arena (>= 128 MB in all, past L2)
    timing = {"qmatmul": {}, "attn": {}}
    for k, n in list(QWEN_PROJ) + [QWEN_HEAD]:
        copies = max(1, -(-(128 << 20) // (k * n)))
        ws = [quantize_tensor(randn(k, n), 8) for _ in range(copies)]
        for m in (4, 64):
            x = randn(m, k).to(torch.bfloat16)
            nbytes = k * n + 4 * n + 2 * m * k + 2 * m * n
            bms, by = bound_ms(nbytes, 2 * m * k * n, torch.bfloat16)
            row = {
                "ms": device_ms([functools.partial(
                    qmm.qmatmul_cuda, x, w.data, w.scale) for w in ws]),
                "plain_ms": device_ms([functools.partial(
                    ref.qmatmul_ref, x, w.data, w.scale) for w in ws]),
                "library_ms": device_ms([functools.partial(
                    library_qmatmul, x, w.data, w.scale) for w in ws]),
                "bound_ms": bms, "bound_by": by}
            timing["qmatmul"][f"M={m} K={k} N={n}"] = row
            print(f"[kernel] qmatmul int8 bf16 M={m} K={k} N={n}: kernel "
                  f"{row['ms']:.4f} ms | plain {row['plain_ms']:.4f} ms | "
                  f"library {row['library_ms']:.4f} ms | bound "
                  f"{bms * 1e3:.2f} us ({by})")
        del ws
    for c in (1, 16):
        x = paged_inputs(rs, LM_SLOTS, 20, 1, c, [159 - c + 1] * LM_SLOTS,
                         torch.bfloat16)
        x["window"] = 0
        bms, by = attn_bound(x)
        arena = x["k"].numel() * x["k"].element_size() * 2
        xs = [dict(x, k=x["k"].clone(), v=x["v"].clone())
              for _ in range(max(1, -(-(128 << 20) // arena)))]
        row = {"ms": device_ms([functools.partial(attn_kernel, xi)
                                for xi in xs]),
               "plain_ms": device_ms([functools.partial(attn_plain, xi)
                                      for xi in xs], reps=3),
               "library_ms": device_ms([attn_library(xi) for xi in xs]),
               "bound_ms": bms, "bound_by": by}
        name = "gqa_paged" if c == 1 else "gqa_paged_chunk"
        timing["attn"][name] = row
        print(f"[kernel] {name} bf16 B={LM_SLOTS} C={c} Hkv=20 hd={HD} "
              f"positions 0..159: kernel {row['ms']:.4f} ms | plain "
              f"{row['plain_ms']:.4f} ms | library {row['library_ms']:.4f} "
              f"ms | bound {bms * 1e3:.2f} us ({by})")
        del xs
    return {"err": err, "timing": timing}


def lm_tick(runner, cfg, tok, t, last=None, fresh=None, plain=False):
    """One step of the served model on the runner's pool, through the
    kernels or (``plain``) with every kernel wrapper swapped for its
    plain version; returns the live logits (B, V) in fp32."""
    pool = runner.pool
    swaps = ((qmm, "qmatmul_cuda", ref.qmatmul_ref),
             (pa, "gqa_paged_cuda", ref.gqa_paged_ref),
             (pa, "gqa_paged_chunk_cuda", ref.gqa_paged_chunk_ref))
    with contextlib.ExitStack() as stack, torch.inference_mode():
        if plain:
            for mod, name, fn in swaps:
                stack.enter_context(mock.patch.object(mod, name, fn))
        if fresh is not None:
            pool.mask_fresh_rows(pool.caches, fresh)
        logits, _ = tfm.decode_step_slots(
            runner.params, pool.caches, tok, t, cfg, logits_at=last,
            tables=pool.host_tables(), attn_backend=runner.attn_backend,
            layers=runner.layers)
    return logits[:, 0].float()


def phase_lm_serve() -> dict:
    cfg = replace(get_config(LM_ARCH), quant=QuantPolicy(8, 0))
    t0 = time.perf_counter()
    params = serve.quantize_for_serving(
        api.init_params(0, cfg, device="cuda"), 8)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    engine = api.make_serving_engine(
        params, cfg, device="cuda", n_slots=LM_SLOTS, cache_len=LM_CACHE,
        prefill_chunk=LM_CHUNK, block_len=BLOCK,
        cache_dtype=torch.bfloat16)
    del params
    runner = engine.runner
    t0 = time.perf_counter()
    engine.warmup()
    print(f"[serve-lm] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.dtype}, int8 weights ({torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB on the card), {runner.attn_backend} attention over a "
          f"{runner.pool.quant_policy.describe()} arena of "
          f"{runner.pool.nbytes() / 2**30:.3f} GiB; drawn + packed in "
          f"{t_init:.1f}s, warmup {time.perf_counter() - t0:.2f}s")
    rs = np.random.RandomState(0)
    reqs = []
    for i in range(10):
        plen = int(rs.randint(32, 129))
        sp = (SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50,
                             top_p=0.95, seed=i) if i in (3, 7)
              else SamplingParams(max_new_tokens=32))
        reqs.append(Request(rid=i, prompt=rs.randint(
            1, cfg.vocab_size, size=plen).tolist(), sampling=sp))
    ops.reset_launch_counts()
    runner.plans.calls.clear()
    for r in reqs:
        engine.submit(r)
    engine.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    calls = dict(runner.plans.calls)
    done = engine.completed
    if len(done) != len(reqs) or any(r.status != "finished" or
                                      len(r.out_tokens) != 32
                                      for r in done.values()):
        raise AssertionError(f"requests not all finished: "
                             f"{[(r.rid, r.status) for r in done.values()]}")
    ticks = sum(calls.values())
    narrow = sum(n for (_, w, _), n in calls.items() if w == 1)
    per_tick = cfg.n_layers * 7 + 1
    want = {"qmatmul": per_tick * ticks,
            "gqa_paged": cfg.n_layers * narrow,
            "gqa_paged_chunk": cfg.n_layers * (ticks - narrow)}
    for name, n in want.items():
        if counts[name] != n or n == 0:
            raise AssertionError(f"{name} launched {counts[name]} times in "
                                 f"{ticks} ticks ({calls}), want {n}")
    st = engine.metrics.summary()
    decode_ticks = sum(n for (kind, _, _), n in calls.items()
                       if kind == "decode")
    print(f"[serve-lm] {st['requests_done']} requests (8 greedy, 2 "
          f"sampled), {st['generated_tokens']} tokens in "
          f"{st['elapsed_s']:.3f}s: {st['tokens_per_s']:.1f} tok/s, decode "
          f"{st['decode_tokens_per_s']:.1f} tok/s, TTFT p50 "
          f"{st['ttft_p50_s'] * 1e3:.1f} ms, decode interval p50 "
          f"{st['decode_interval_p50_s'] * 1e3:.2f} ms, tick p50 "
          f"{st['tick_latency_p50_s'] * 1e3:.2f} ms")
    print(f"[serve-lm] {ticks} ticks ({decode_ticks} decode-only, "
          f"{ticks - decode_ticks} mixed, {narrow} of width 1): launches "
          f"qmatmul {counts['qmatmul']} = {per_tick} x {ticks}, gqa_paged "
          f"{counts['gqa_paged']} = {cfg.n_layers} x {narrow}, "
          f"gqa_paged_chunk {counts['gqa_paged_chunk']} = {cfg.n_layers} x "
          f"{ticks - narrow}")

    # one mixed and one decode tick, kernels vs plain versions, on the
    # same pool state: rows 0-3 hold 48 positions written by the kernels
    pool = runner.pool
    for slot in range(LM_SLOTS):
        pool.release_slot(slot)
    for slot in range(LM_SLOTS):
        assert pool.alloc(slot, 64)
    trs = np.random.RandomState(1)
    dev_tok = torch.from_numpy(trs.randint(1, cfg.vocab_size, (LM_SLOTS, 64))
                               .astype(np.int32))
    for c0 in (0, 16, 32):
        t = torch.arange(c0, c0 + 16, dtype=torch.int32).repeat(LM_SLOTS, 1)
        fresh = torch.full((LM_SLOTS,), int(c0 == 0), dtype=torch.int32)
        lm_tick(runner, cfg, dev_tok[:, c0:c0 + 16], t,
                last=torch.full((LM_SLOTS,), 15, dtype=torch.int32),
                fresh=fresh)
    snap = {g: {n: a.clone() for n, a in tree.items()}
            for g, tree in pool.caches.items()}

    def restore():
        for g, tree in pool.caches.items():
            for n, a in tree.items():
                a.copy_(snap[g][n])
    t_mixed = torch.full((LM_SLOTS, 16), -1, dtype=torch.int32)
    t_mixed[0:2] = torch.arange(48, 64, dtype=torch.int32)
    t_mixed[2, 0] = 48                     # a decode row; row 3 is a pad
    mixed = (dev_tok[:, 48:64], t_mixed,
             torch.tensor([15, 15, 0, 0], dtype=torch.int32))
    decode = (dev_tok[:, 48:49],
              torch.full((LM_SLOTS, 1), 48, dtype=torch.int32), None)
    live = {"mixed": [0, 1, 2], "decode": [0, 1, 2, 3]}
    exact = replace(cfg, dtype="float32")
    agree = {}
    for label, c, bound in (("bf16 as served", cfg, LM_TICK_BF16),
                            ("fp32 compute", exact, LM_TICK_FP32)):
        for kind, (tok, t, last) in (("mixed", mixed), ("decode", decode)):
            out = []
            for plain in (False, True):
                restore()
                out.append(lm_tick(runner, c, tok, t, last, plain=plain))
            lk, lp = (o[live[kind]] for o in out)
            if not bool(torch.isfinite(lk).all()):
                raise AssertionError("LM tick: non-finite logits")
            d = float((lk - lp).abs().max())
            a = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
            agree[f"{kind}, {label}"] = (d, a)
            print(f"[serve-lm] one {kind} tick kernel vs plain, {label}: "
                  f"max|d logit| {d:.4g} (logit std "
                  f"{float(lk.std()):.3g}), argmax agree {a:.3f} over "
                  f"{len(live[kind])} live rows")
            if d > bound[0] or a < bound[1]:
                raise AssertionError(f"served {kind} tick ({label}): kernel "
                                     f"path disagrees with the plain path")
    restore()
    return {"launches": counts, "runner": runner, "cfg": cfg,
            "mixed": mixed, "decode": decode, "restore": restore}


def phase_lm_trace(served: dict) -> dict:
    """Trace one decode and one mixed tick of the served plans on the
    comparison state (re-running a tick rewrites the same positions
    with the same values, so repeats see the same state)."""
    runner = served["runner"]
    served["restore"]()
    out = {}
    for kind, (tok, t, last) in (("decode", served["decode"]),
                                 ("mixed", served["mixed"])):
        B = LM_SLOTS
        zeros = torch.zeros((B,), dtype=torch.int32)
        fn = runner.plans.fn((kind, t.shape[1], "greedy"))
        args = ((tok, t, zeros, zeros, last) if kind == "mixed"
                else (tok, t, zeros, None, None))

        def enqueue():
            return fn(*args, None)
        out[kind] = trace(f"one {kind} tick (qwen1.5-4b, B={B}, C="
                          f"{t.shape[1]})", enqueue)
    return out


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
    lm_kern = phase_lm_kernel()
    lm = phase_lm_serve()
    phase_lm_trace(lm)
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
    cfg = lm["cfg"]
    qt = lm_kern["timing"]["qmatmul"]
    per_tick = {f"M=4 K={k} N={n}": cfg.n_layers * m
                for (k, n), m in QWEN_PROJ.items()}
    per_tick[f"M=4 K={QWEN_HEAD[0]} N={QWEN_HEAD[1]}"] = 1

    def tick_sum(key):
        return sum(qt[s][key] * m for s, m in per_tick.items())
    kernels.append({
        "name": "qmatmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/qmatmul.cu",
        "replaces": "src/repro/kernels/qmatmul.py:57",
        "launches": lm["launches"]["qmatmul"],
        "max_abs_err": lm_kern["err"]["qmatmul"],
        "ms": tick_sum("ms"), "plain_ms": tick_sum("plain_ms"),
        "bound_ms": tick_sum("bound_ms"), "bound_by": "bytes",
        "library_ms": tick_sum("library_ms"),
        "shape": f"sum over one decode tick's {sum(per_tick.values())} "
                 f"launches, int8 weights, bf16 x, M={LM_SLOTS}",
        "per_shape": qt})
    for name, replaces in (("gqa_paged", 260), ("gqa_paged_chunk", 492)):
        row = lm_kern["timing"]["attn"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": f"src/repro/kernels/paged_attention.py:{replaces}",
            "launches": lm["launches"][name],
            "max_abs_err": lm_kern["err"][name],
            **{key: (row[key] * cfg.n_layers if key.endswith("ms")
                     else row[key]) for key in row},
            "shape": f"sum over one tick's {cfg.n_layers} launches, bf16 "
                     f"arena, B={LM_SLOTS} Hkv=20 hd={HD} block_len={BLOCK}"
                     f", positions 0..159, C="
                     f"{1 if name == 'gqa_paged' else 16}",
            "per_call": row})
    print(f"[chip_smoke] all phases ok in {time.perf_counter() - t0:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
