#!/usr/bin/env python3
"""Smoke-run the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build  — compile every CUDA source of the port with nvcc (one
   process per source, started together) and print the build seconds
   and ptxas's register/shared-memory report; count the tensor-core
   instructions (HGMMA in flash_tc_kernel, HMMA in gqa_chunk_tc_kernel,
   mla_tc_kernel, qconv1d_tc_kernel, ssd_state_tc_kernel and
   ssd_chunk_tc_kernel, HMMA or HGMMA in each qmatmul_tc_kernel: HGMMA
   at 64 rows) in ``cuobjdump -sass`` of the built libraries, and fail
   on none.
2. kernel — hold each kernel against its plain PyTorch version on the
   card at the main path's shapes (qconv1d_block on the unpadded
   window, the plain version on the padded one: C=344, every RUBICALL
   k, B=4, T=2500, a ragged T and T < k, ReLU on and off; fp32 on the
   CUDA-core route with TF32 off at 1e-3, bf16 on the tensor-core route
   at one bf16 ulp), then time each route's kernel, plain version, the
   library composition (device time, host excluded, L2-warm) and the
   computed bound at B=4, T=2500.
3. serve  — full-width RUBICALL (28 blocks, C=344, bf16), random
   seeded weights packed to int8 as ``launch/serve.py --wbits 8`` does,
   served through the port's ServingEngine (4 slots, 1024-sample
   chunks, warmup) on 8 simulated reads. Checks every read finishes,
   the kernel launched 19 times per forward, all on the tensor-core
   route, and one tick's log-probs through the kernels agree with the
   same tick through the plain versions on the card (bf16 on the
   tensor-core route, fp32 on the CUDA-core route).
4. kernel (LM) — hold qmatmul (int8 and int4 at every qwen1.5-4b
   projection shape, M = 4 and 64, ragged shapes; each call on the
   route the wrapper picks, asserted: bf16 tensor-core, fp32 CUDA-core)
   and the paged
   attention kernels (qwen1.5-4b's 20 x 128 heads and chatglm3-6b's 2
   KV heads x group 16; block_len 16; fp32, bf16, fp8, int8 and fp16
   arenas; holes, out-of-order blocks, pad rows, a ring window; C = 1,
   4, 16; also at 2048 positions, where the tensor-core kernel splits
   the walk across CTAs, at R = C * group = 1, 4, 16 and 256) against
   their plain versions, checking each call's route (tensor-core over
   bf16, fp8, int8 and fp16 arenas at any C, CUDA-core over fp32),
   then time kernel, plain version, library call and bound at the
   served shapes (qmatmul on both routes at M = 4 and 64, summed over
   one qwen1.5-4b decode and one mixed tick; the decode at 160, 256 and
   2048 positions and on its fp32 route, the chunk at 160 and 2048).
5. serve (LM) — full-width qwen1.5-4b (40 layers, d 2560, no depth
   cut), seeded random weights drawn on the card and packed to int8
   under QuantPolicy(8, 0), a bf16 paged arena (block_len 16), 4 slots,
   prefill chunk 16, warmup; 8 greedy and 2 sampled requests of 32-128
   prompt tokens and 32 new tokens. Checks every request finishes, the
   kernel launches reconcile with the ticks the plans ran (281 qmatmul
   per tick, 40 attention launches per tick: gqa_paged on C = 1 ticks,
   gqa_paged_chunk on wider ones, every one of both and every qmatmul
   launch on the tensor-core route), and one mixed and one decode tick
   through the kernels agree
   with the same ticks through the plain versions on the same pool
   state: bf16 as served, over an fp16 copy of the arena (both on the
   tensor-core route) and in fp32 (the CUDA-core route).
6. trace (LM) — host enqueue, device and wall time of one decode and
   one mixed tick, then the device busy share and top kernels under
   torch.profiler. The qwen engine is then freed.
7. kernel (MLA) — hold mla_paged (C = 1) and mla_paged_chunk (C = 16)
   against their plain versions at deepseek-v3's widths (128 heads,
   latent 512, rope 64, block_len 16; fp32, bf16, fp8, int8 and fp16
   arenas; holes, out-of-order blocks, pad rows) at 160 and 2048
   positions, checking each call's route (tensor-core over bf16, fp8,
   int8 and fp16 arenas, CUDA-core over fp32), then time both routes
   (``path=``), plain version, library call and bound (bf16): the
   decode at 160, 256 and 2048 positions, the chunk at 160 and 2048.
8. serve (MLA) — full-width deepseek-v3-671b cut to 4 layers (3
   mla_dense + 1 mla_moe with all 256 experts, top-8 and the shared
   expert), seeded random weights drawn on the card and packed to int8
   as they are drawn, a bf16 latent arena, the same engine settings and
   traffic as phase 5. Checks as phase 5: every request finishes,
   launches reconcile with the ticks (mla_paged on C = 1 ticks,
   mla_paged_chunk on wider ones, 4 a tick; qmatmul per tick counted
   from the projections; every one of the three on the tensor-core
   route), kernel vs plain ticks (bf16 and the fp16 arena on the
   tensor-core route, fp32 on the CUDA-core one); peak device memory.
9. trace (MLA) — as phase 6, for the deepseek ticks. The deepseek
   engine is then freed.
10. kernel (prefill) — hold flash_attention (qwen1.5-4b's 20 x 128
   heads and a GQA case of group 8; causal and not; S 512 and 2048,
   ragged S 333 and 129 and Sq != Sk; fp32 at 1e-4 on the CUDA-core
   route, bf16 at one bf16 ulp on the tensor-core route) and ssd_scan
   (mamba2-130m's 24 heads of 64, state 128, chunk 256; S 2048 and a
   ragged 2000; y and the final state; fp32 at 5e-3 on the CUDA-core
   route, bf16 y at one bf16 ulp on both routes, the route asserted)
   against their plain versions, print the error of P . V with p as one
   bf16 term and as the kernel's two, then time kernel (ssd_scan on both
   routes), plain version, library call
   (F.scaled_dot_product_attention for flash; none for the SSD scan)
   and bound at the served shapes.
11. static (mamba2) — full-width mamba2-130m (24 layers, no cut),
   seeded bf16 weights drawn on the card, through launch/serve.py's
   static path (run_static): 4 prompts of 2048 tokens, 32 greedy new
   tokens. Checks ssd_scan launched 24 times in the prefill, all on the
   tensor-core route, and never in the decode (and nothing else), and
   that the prefill's
   last-position logits and every layer's handed-off h/conv state
   through the kernel agree with the same prefill through the plain
   version, in fp32 and bf16; prints prefill ms, decode tok/s, peak
   device memory and a trace of one prefill with ssd_scan's share.
12. static (qwen1.5-4b) — the same for full-width qwen1.5-4b (40
   layers, no cut), weights drawn again on the card as int8 packed as
   drawn and dequantized once to bf16 (``--static --wbits 8``), 4
   prompts of 512 tokens: flash_attention launched 40 times in the
   prefill, all on the tensor-core route, never in the decode.

Prints each phase's seconds, the card's name and power limit, a
``{"kernels": [...]}`` line, and as its last line ``{"ok": true,
"device": {...}}``. Exits non-zero
without CUDA, and when run outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import re
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
from repro_torch.core.quant.policy import (Packer, quantize_tensor,  # noqa: E402
                                           tree_map)
from repro_torch.kernels import _build, ops, qconv1d, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import qmatmul as qmm  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.basecaller import model as bc  # noqa: E402
from repro_torch.models.lm import common  # noqa: E402
from repro_torch.models.lm import moe as moe_mod  # noqa: E402
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


def device_ms(calls, reps: int = 5) -> float:
    """Median device time of one call of ``calls`` run back to back with
    the host out of the way: a sleep kernel holds the stream while the
    host enqueues every call, and the CUDA events bracket device work
    only. The LM phases' ``calls`` read distinct copies of their weights
    or arenas, so these come from HBM, as on the served path; the
    qconv1d calls repeat one window, L2-warm, as inside a forward."""
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
    """Unpadded x and packed weights for one kernel call, on the card."""
    dev = "cuda"
    x = torch.from_numpy(rs.randn(b, t, C).astype(np.float32))
    dw = quantize_tensor(torch.from_numpy(rs.randn(k, C).astype(np.float32)), 8)
    pw = quantize_tensor(torch.from_numpy(rs.randn(C, C).astype(np.float32)), 8)
    g = torch.from_numpy(rs.rand(1, C).astype(np.float32))
    bt = torch.from_numpy(rs.randn(1, C).astype(np.float32))
    return (x.to(dev, dtype), dw.data.to(dev), pw.data.to(dev),
            dw.scale.to(dev), pw.scale.to(dev), g.to(dev), bt.to(dev))


def qconv_plain(x, *w, relu=True):
    """The plain version on the unpadded window: the halo padded as
    ``ops.qconv1d_block`` pads it on the CPU, then
    ``ref.qconv1d_block_ref`` (the JAX kernel's signature)."""
    k = w[0].shape[0]
    pad = (k - 1) // 2
    return ref.qconv1d_block_ref(F.pad(x, (0, 0, pad, k - 1 - pad)), *w,
                                 relu=relu)


def library_qconv(args):
    """The same function (no ReLU, as RUBICALL's blocks call it) from
    library calls, timed only and never used by the port: cuDNN
    depthwise conv (its own zero padding; every k is odd) + cuBLAS
    linear with beta as bias."""
    x, dw_q, pw_q, dws, pws, g, bt = args
    k = dw_q.shape[0]
    w_dw = (dw_q.float() * dws).t().unsqueeze(1).to(x.dtype)    # (C, 1, k)
    w_pw = (pw_q.float() * pws * g).t().contiguous().to(x.dtype)
    xc = x.transpose(1, 2).contiguous()                        # (B, C, T)
    bias = bt.reshape(-1).to(x.dtype)
    return lambda: F.linear(F.conv1d(xc, w_dw, padding=(k - 1) // 2,
                                     groups=C).transpose(1, 2), w_pw, bias)


# the tensor-core kernels: (library, kernel name, the SASS instructions
# that show the tensor cores at work, as a regex alternation)
TENSOR_CORE_SASS = (("flash_attention", "flash_tc_kernel", "HGMMA"),
                    ("paged_attention", "gqa_chunk_tc_kernel", "HMMA"),
                    ("mla_paged_attention", "mla_tc_kernel", "HMMA"),
                    ("qconv1d", "qconv1d_tc_kernel", "HMMA"),
                    ("qmatmul", "qmatmul_tc_kernel", "HMMA|HGMMA"),
                    ("ssd_scan", "ssd_state_tc_kernel", "HMMA"),
                    ("ssd_scan", "ssd_chunk_tc_kernel", "HMMA"))


def sass_counts(lib: str, kernel: str, op: str) -> dict:
    """{mangled function: count of ``op`` instructions} over the
    functions of the built ``lib`` whose name holds ``kernel``, from
    ``cuobjdump -sass``."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build._target(lib))],
                          capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            if fn:
                counts[fn] = 0
        elif fn and re.search(rf"\b(?:{op})\b", line):
            counts[fn] += 1
    return counts


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] nvcc {built or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, log in _build.LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    for lib, kernel, op in TENSOR_CORE_SASS:
        counts = sass_counts(lib, kernel, op)
        if not counts or min(counts.values()) == 0:
            raise AssertionError(f"{kernel}: no {op} in the SASS of "
                                 f"{lib}: {counts}")
        print(f"[build] {lib}: {kernel}, {len(counts)} instantiations, "
              f"{op} instructions {sorted(counts.values())}")


QCONV_ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}


def phase_kernel() -> dict:
    """Kernel vs plain version at every shape, on the route each dtype
    takes, then each route's timings."""
    rs = np.random.RandomState(0)
    err_main = 0.0
    fn = qconv1d.qconv1d_block_cuda
    for dtype, route in QCONV_ROUTES.items():
        rtol, atol = TOL[dtype]
        for k in KS:
            for t in (T_MAIN, T_RAGGED, k // 2):     # k // 2: T < k
                args = qconv_inputs(rs, B, t, k, dtype)
                for relu in (True, False):
                    before = dict(fn.routes)
                    got = fn(*args, relu=relu)
                    if fn.routes != {**before, route: before[route] + 1}:
                        raise AssertionError(f"qconv1d {dtype} k={k}: "
                                             f"routes {before} -> "
                                             f"{fn.routes}, want {route}")
                    want = qconv_plain(*args, relu=relu)
                    torch.cuda.synchronize()
                    if got.shape != (B, t, C) or got.dtype != dtype:
                        raise AssertionError(f"qconv1d {tuple(got.shape)} "
                                             f"{got.dtype}")
                    torch.testing.assert_close(got.float(), want.float(),
                                               rtol=rtol, atol=atol)
                    err = float((got.float() - want.float()).abs().max())
                    print(f"[kernel] qconv1d_block {str(dtype)[6:]} k={k} "
                          f"T={t} relu={int(relu)} ({route}): max|err| "
                          f"{err:.3g} ok")
                    if dtype == torch.bfloat16 and t == T_MAIN:
                        err_main = max(err_main, err)
    per_route = {}
    for dtype, route in QCONV_ROUTES.items():
        per_k = per_route[route] = {}
        for k in KS:
            args = qconv_inputs(rs, B, T_MAIN, k, dtype)
            esize = torch.finfo(dtype).bits // 8
            nb = qconv1d_bytes(B, T_MAIN, C, k, esize)
            bms, by = bound_ms(nb, qconv1d_flops(B, T_MAIN, C, k), dtype)
            # relu=False: each RUBICALL block has one repeat, and sep_conv
            # calls the kernel without ReLU for a block's last repeat.
            # Device time with the host out of the way, the same call back
            # to back: L2-warm, as a block reads the window the block
            # before it just wrote
            row = {
                "ms": device_ms([lambda: fn(*args, relu=False)] * 20),
                "plain_ms": device_ms(
                    [lambda: qconv_plain(*args, relu=False)] * 5, reps=3),
                "library_ms": device_ms([library_qconv(args)] * 20),
                "bound_ms": bms, "bound_by": by}
            per_k[k] = row
            print(f"[kernel] qconv1d_block {str(dtype)[6:]} ({route}) B={B} "
                  f"T={T_MAIN} C={C} k={k}: kernel {row['ms']:.4f} ms | "
                  f"plain {row['plain_ms']:.4f} ms | library "
                  f"{row['library_ms']:.4f} ms | bound {bms * 1e3:.2f} us "
                  f"({by})")
    return {"err_main": err_main, "per_route": per_route}


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
    plain versions (the kernel wrapper swapped for its plain version on
    the unpadded window), on the card; checks the log-probs' shape and
    finiteness."""
    wins, start, rlen = (torch.from_numpy(a).to(runner.device)
                         for a in window)
    out = []
    for plain in (False, True):
        swap = (mock.patch.object(qconv1d, "qconv1d_block_cuda",
                                  qconv_plain)
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


def trace(label: str, enqueue, share: tuple = ()) -> dict:
    """Where one served tick's time goes. ``enqueue()`` enqueues the
    tick and returns its output on the card. Without the profiler: host
    time to enqueue, device time from the first enqueue to the last
    kernel (CUDA events), and wall time to the readback. Under
    torch.profiler (CUPTI): the device time of every kernel, summed and
    by kernel, and the share of the kernels whose names hold one of
    ``share``."""
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
    # the top 8, then the port's own kernels further down
    for i, (us, n, key) in enumerate(rows):
        if i < 8 or key.startswith("void (anonymous namespace)::"):
            print(f"[trace]   {us / 1e3:8.3f} ms  {n:4d}x  {key[:90]}")
    out = {"host_ms": t_host * 1e3, "device_ms": a.elapsed_time(b),
           "wall_ms": t_wall * 1e3, "busy_ms": busy}
    if share:
        mine = [r for r in rows if any(k in r[2] for k in share)]
        out["share_ms"] = sum(r[0] for r in mine) / 1e3
        print(f"[trace] {label}: {'/'.join(share)} {out['share_ms']:.3f} ms "
              f"in {sum(r[1] for r in mine)} launches, "
              f"{out['share_ms'] / busy:.1%} of the device kernels")
    return out


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
    routes = ops.launch_counts(routes=True)
    check_routes(routes, ("qconv1d_block",), "rubicall served")
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
          f"launches {launches} = {len(KERNEL_BLOCKS)} x {forwards}, "
          f"routes {routes['qconv1d_block']}")

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
        ops.reset_launch_counts()
        lp_k, lp_p = tick_both_paths(runner, c, window)
        r = ops.launch_counts(routes=True)
        check_routes(r, ("qconv1d_block",) if c is cfg else (),
                     f"rubicall tick, {name}")
        if r["qconv1d_block"] != {
                QCONV_ROUTES[getattr(torch, c.dtype)]: len(KERNEL_BLOCKS),
                "tensor_core" if c is exact else "cuda_core": 0}:
            raise AssertionError(f"rubicall tick, {name}: routes "
                                 f"{r['qconv1d_block']}")
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
    return {"launches": launches, "routes": routes["qconv1d_block"]}

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
# arenas (bf16 compute), fp16 arenas (fp16 compute) and qmatmul 2e-2
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2,
            torch.float8_e4m3fn: 2e-2, torch.int8: 2e-2,
            torch.float16: 2e-2}
QMM_TOL = 2e-2
QMM_ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
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
MIXED_POSITIONS = 160         # cached positions of a row in the timed tick
FULL_POSITIONS = 256          # a row's whole table at LM_CACHE
LONG_POSITIONS = 2048         # a long row: the walk split across CTAs


def paged_inputs(rs, b, hkv, group, c, fills, arena, *, holes=(),
                 t_blocks=LM_CACHE // BLOCK, q_dtype=torch.bfloat16,
                 hd=HD):
    """Paged attention inputs on the card as the read sees them mid-tick:
    row i has positions [0, fills[i] + c) written (its c query tokens
    last) in arena blocks handed out in random order; every other byte
    is stale (99.0); ``holes`` (i, j) punches table entry j of row i back
    to -1 with its positions emptied. ``arena`` is the storage dtype
    (int8 comes with its fp32 scale arenas)."""
    bl, T = BLOCK, t_blocks
    n_blocks = b * T + 3
    k = torch.full((n_blocks, bl, hkv, hd), 99.0)
    v = torch.full((n_blocks, bl, hkv, hd), 99.0)
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
        k[blk, off] = torch.from_numpy(rs.randn(n + c, hkv, hd).astype(
            np.float32))
        v[blk, off] = torch.from_numpy(rs.randn(n + c, hkv, hd).astype(
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
    q = torch.from_numpy(rs.randn(b, c, hkv * group, hd).astype(np.float32))
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


def qwen_qmatmul_plan() -> dict:
    """{(K, N): launches} of one qwen1.5-4b tick: each layer's
    projections and the head."""
    layers = get_config(LM_ARCH).n_layers
    return {**{kn: layers * m for kn, m in QWEN_PROJ.items()}, QWEN_HEAD: 1}


def qmatmul_tick(timing: dict, m: int) -> dict:
    """The qmatmul timings of one qwen1.5-4b tick at M = ``m``: each
    timed quantity summed over the tick's launches."""
    plan = qwen_qmatmul_plan()
    return {key: sum(timing[(m, k, n)][key] * c for (k, n), c in
                     plan.items())
            for key in (*qmm.ROUTES, "ms", "plain_ms", "library_ms",
                        "bound_ms")}


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
    return bound_ms(nbytes, flops, torch.float32 if k.dtype == torch.float32
                    else torch.bfloat16)


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
    fn = qmm.qmatmul_cuda
    for m, k, n, bits, dt in shapes:
        w = quantize_tensor(randn(k, n), bits)
        x = randn(m, k).to(dt)
        route = QMM_ROUTES[dt]
        if qmm.route(dt, m) != route:
            raise AssertionError(f"qmatmul {dt} M={m}: route "
                                 f"{qmm.route(dt, m)}, want {route}")
        before = dict(fn.routes)
        got = fn(x, w.data, w.scale, bits=bits)
        if fn.routes != {**before, route: before[route] + 1}:
            raise AssertionError(f"qmatmul {dt} M={m}: routes {before} -> "
                                 f"{fn.routes}, want {route}")
        want = ref.qmatmul_ref(x, w.data, w.scale, bits=bits)
        torch.cuda.synchronize()
        if got.shape != (m, n) or got.dtype != dt:
            raise AssertionError(f"qmatmul {tuple(got.shape)} {got.dtype}")
        torch.testing.assert_close(got.float(), want.float(), rtol=QMM_TOL,
                                   atol=QMM_TOL)
        e = float((got.float() - want.float()).abs().max())
        if dt == torch.bfloat16 and bits == 8 and (k, n) != (301, 200):
            err["qmatmul"] = max(err["qmatmul"], e)
        print(f"[kernel] qmatmul int{bits} {str(dt)[6:]} M={m} K={k} N={n} "
              f"({route}): max|err| {e:.3g} ok")
    # ---- paged attention: qwen1.5-4b heads and chatglm3-6b's GQA
    cases = [(hkv, group, c, arena, 0, LM_CACHE)
             for hkv, group in ((20, 1), (2, 16))
             for arena in ATTN_TOL for c in (1, 4, 16)]
    cases.append((20, 1, 4, torch.bfloat16, 40, LM_CACHE))   # ring window
    # 2048 positions: the tensor-core kernel splits the walk across CTAs;
    # R = C * group = 1, 4, 16 and 256 query rows
    cases += [(hkv, group, c, arena, 0, LONG_POSITIONS)
              for hkv, group, c in ((20, 1, 1), (20, 1, 4), (20, 1, 16),
                                    (2, 16, 16))
              for arena in ATTN_TOL]
    for hkv, group, c, arena, window, cache in cases:
        x = paged_inputs(rs, 4, hkv, group, c, [cache - c, BLOCK - 1, 0,
                                                159], arena,
                         holes=[(0, 5)], t_blocks=cache // BLOCK,
                         q_dtype=(torch.float32 if arena == torch.float32
                                  else torch.bfloat16))
        x["t"][3, 1:] = -1                 # a decode row padded to C
        if c == 1:
            x["t"][2] = -1                 # a free slot
        x["window"] = window
        fn = pa.gqa_paged_cuda if c == 1 else pa.gqa_paged_chunk_cuda
        route = "tensor_core" if arena != torch.float32 else "cuda_core"
        before = dict(fn.routes)
        got = attn_kernel(x)
        if fn.routes != {**before, route: before[route] + 1}:
            raise AssertionError(f"gqa_paged C={c} {arena}: routes "
                                 f"{before} -> {fn.routes}, want {route}")
        want = attn_plain(x)
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
              f"{str(arena)[6:]} window={window} positions {cache} "
              f"({route}): max|err| {e:.3g} ok")
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
            row = {path: device_ms([functools.partial(
                qmm.qmatmul_cuda, x, w.data, w.scale, path=path)
                for w in ws]) for path in qmm.ROUTES}
            row.update({
                "ms": row[qmm.route(torch.bfloat16, m)],
                "plain_ms": device_ms([functools.partial(
                    ref.qmatmul_ref, x, w.data, w.scale) for w in ws]),
                "library_ms": device_ms([functools.partial(
                    library_qmatmul, x, w.data, w.scale) for w in ws]),
                "bound_ms": bms, "bound_by": by})
            timing["qmatmul"][(m, k, n)] = row
            print(f"[kernel] qmatmul int8 bf16 M={m} K={k} N={n}: "
                  f"tensor_core {row['tensor_core']:.4f} ms | cuda_core "
                  f"{row['cuda_core']:.4f} ms | plain {row['plain_ms']:.4f} "
                  f"ms | library {row['library_ms']:.4f} ms | bound "
                  f"{bms * 1e3:.2f} us ({by})")
        del ws
    for m, kind in ((LM_SLOTS, "decode"), (LM_SLOTS * LM_CHUNK, "mixed")):
        tick = qmatmul_tick(timing["qmatmul"], m)
        print(f"[kernel] qmatmul over one qwen1.5-4b {kind} tick (M={m}, "
              f"{sum(qwen_qmatmul_plan().values())} launches): tensor_core "
              f"{tick['tensor_core']:.4f} ms | cuda_core "
              f"{tick['cuda_core']:.4f} ms | plain {tick['plain_ms']:.4f} ms "
              f"| library {tick['library_ms']:.4f} ms | bound "
              f"{tick['bound_ms']:.4f} ms")
    # the decode on both routes (fp32 arena: CUDA cores) at the served
    # fill, the whole table and 2048 positions; the chunk at 160 and 2048
    for c, n, kv in ((1, MIXED_POSITIONS, torch.bfloat16),
                     (1, MIXED_POSITIONS, torch.float32),
                     (1, FULL_POSITIONS, torch.bfloat16),
                     (1, LONG_POSITIONS, torch.bfloat16),
                     (16, MIXED_POSITIONS, torch.bfloat16),
                     (16, LONG_POSITIONS, torch.bfloat16)):
        x = paged_inputs(rs, LM_SLOTS, 20, 1, c, [n - c] * LM_SLOTS,
                         kv, t_blocks=max(n, LM_CACHE) // BLOCK,
                         q_dtype=(torch.float32 if kv == torch.float32
                                  else torch.bfloat16))
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
        key = name if n == MIXED_POSITIONS else f"{name}@{n}"
        if kv == torch.float32:
            key = f"{name}/cuda_core"
        timing["attn"][key] = row
        print(f"[kernel] {name} {str(kv)[6:]} B={LM_SLOTS} C={c} Hkv=20 "
              f"hd={HD} positions 0..{n - 1}: kernel {row['ms']:.4f} ms | "
              f"plain {row['plain_ms']:.4f} ms | library "
              f"{row['library_ms']:.4f} ms | bound {bms * 1e3:.2f} us "
              f"({by})")
        del xs
    return {"err": err, "timing": timing}


def lm_tick(runner, cfg, tok, t, last=None, fresh=None, plain=False,
            caches=None):
    """One step of the served model on ``caches`` (the runner's pool by
    default), through the kernels or (``plain``) with every kernel
    wrapper swapped for its plain version; returns the live logits
    (B, V) in fp32."""
    pool = runner.pool
    caches = pool.caches if caches is None else caches
    swaps = ((qmm, "qmatmul_cuda", ref.qmatmul_ref),
             (pa, "gqa_paged_cuda", ref.gqa_paged_ref),
             (pa, "gqa_paged_chunk_cuda", ref.gqa_paged_chunk_ref),
             (pa, "mla_paged_cuda", ref.mla_paged_ref),
             (pa, "mla_paged_chunk_cuda", ref.mla_paged_chunk_ref))
    with contextlib.ExitStack() as stack, torch.inference_mode():
        if plain:
            for mod, name, fn in swaps:
                stack.enter_context(mock.patch.object(mod, name, fn))
        if fresh is not None:
            pool.mask_fresh_rows(caches, fresh)
        logits, _ = tfm.decode_step_slots(
            runner.params, caches, tok, t, cfg, logits_at=last,
            tables=pool.host_tables(), attn_backend=runner.attn_backend,
            layers=runner.layers)
    return logits[:, 0].float()


def lm_requests(cfg):
    """The LM phases' traffic: 8 greedy and 2 sampled requests of 32-128
    random prompt tokens and 32 new tokens, all queued at once."""
    rs = np.random.RandomState(0)
    reqs = []
    for i in range(10):
        plen = int(rs.randint(32, 129))
        sp = (SamplingParams(max_new_tokens=32, temperature=0.8, top_k=50,
                             top_p=0.95, seed=i) if i in (3, 7)
              else SamplingParams(max_new_tokens=32))
        reqs.append(Request(rid=i, prompt=rs.randint(
            1, cfg.vocab_size, size=plen).tolist(), sampling=sp))
    return reqs


def qmatmul_per_tick(cfg) -> int:
    """Projections of one tick that take the quantized-matmul kernel: the
    packed ones (a group's stack holds ``min_size`` values or more, as
    ``api.init_params(wbits=8)`` packs) whose (M, K, N) meet the
    reference kernel's tiling contract (``common._qmatmul_tiles``, the
    same at every M a tick makes: 4 to 64). wukv is dequantized, the
    routed experts run dequantized rows, and neither is a projection."""
    d, plan = cfg.d_model, tfm.layer_plan(cfg)
    hd = cfg.resolved_head_dim
    min_size = Packer(QuantPolicy(8, 0)).min_size
    shapes = []
    for kind, n in plan:
        if kind in tfm.MLA_KINDS:
            H, qr, kvr = cfg.n_heads, cfg.mla_q_lora_rank, \
                cfg.mla_kv_lora_rank
            nope, rope, vd = (cfg.mla_qk_nope_dim, cfg.mla_qk_rope_dim,
                              cfg.mla_v_dim)
            mix = [(d, qr), (qr, H * (nope + rope)), (d, kvr + rope),
                   (H * vd, d)]
        else:
            mix = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
                   (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d)]
        if kind in tfm.MOE_KINDS:
            ff = cfg.moe_d_ff or cfg.d_ff
            sh = ff * cfg.n_shared_experts
            ffn = [(d, cfg.n_experts)] + (
                [(d, sh), (d, sh), (sh, d)] if sh else [])
        else:
            ff = (cfg.dense_d_ff or cfg.d_ff) if kind == "mla_dense" \
                else cfg.d_ff
            ffn = [(d, ff), (d, ff), (ff, d)]
        shapes += [(k, nn) for k, nn in mix + ffn
                   if n * k * nn >= min_size] * n
    if not cfg.tie_embeddings and d * cfg.vocab_size >= min_size:
        shapes.append((d, cfg.vocab_size))
    return sum(common._qmatmul_tiles(LM_SLOTS, k, n, 8) for k, n in shapes)


def check_routes(routes: dict, tensor_core: tuple, where: str) -> None:
    """Every launch in ``routes`` (``ops.launch_counts(routes=True)``) of
    a kernel in ``tensor_core`` took the tensor-core route, every other
    launch the CUDA-core one."""
    for name, r in routes.items():
        off = "cuda_core" if name in tensor_core else "tensor_core"
        if r[off]:
            raise AssertionError(f"{where}: {name} launched {r[off]} times "
                                 f"on the {off} route: {r}")


def phase_lm_serve(cfg, attn: tuple, bounds: tuple,
                   tensor_core: tuple = ()) -> dict:
    """Serve ``cfg`` at full width, int8 weights drawn and packed on the
    card, then one mixed and one decode tick through the kernels against
    the plain versions. ``attn``: the (C == 1, C > 1) attention kernels
    the path must launch once per layer and tick; ``bounds``: the (bf16,
    fp32) tick bounds; ``tensor_core``: the kernels whose served (bf16)
    launches must all take the tensor-core route (fp32 ones the CUDA-core
    route)."""
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, device="cuda", wbits=8)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    peak_init = torch.cuda.max_memory_allocated()
    engine = api.make_serving_engine(
        params, cfg, device="cuda", n_slots=LM_SLOTS, cache_len=LM_CACHE,
        prefill_chunk=LM_CHUNK, block_len=BLOCK,
        cache_dtype=torch.bfloat16)
    del params
    runner = engine.runner
    t0 = time.perf_counter()
    engine.warmup()
    print(f"[serve-lm] {cfg.name}: {cfg.n_layers} layers "
          f"{[k for k, _ in tfm.layer_plan(cfg)]}, d {cfg.d_model}, "
          f"{cfg.dtype}, int8 weights ({torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB on the card), {runner.attn_backend} attention over a "
          f"{runner.pool.quant_policy.describe()} arena of "
          f"{runner.pool.nbytes() / 2**30:.3f} GiB; drawn + packed in "
          f"{t_init:.1f}s (peak {peak_init / 2**30:.2f} GiB, "
          f"{before / 2**30:.2f} GiB held before), warmup "
          f"{time.perf_counter() - t0:.2f}s")
    reqs = lm_requests(cfg)
    ops.reset_launch_counts()
    runner.plans.calls.clear()
    for r in reqs:
        engine.submit(r)
    engine.run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    by_route = ops.launch_counts(routes=True)
    check_routes(by_route, tensor_core, f"{cfg.name} served")
    calls = dict(runner.plans.calls)
    done = engine.completed
    if len(done) != len(reqs) or any(r.status != "finished" or
                                      len(r.out_tokens) != 32
                                      for r in done.values()):
        raise AssertionError(f"requests not all finished: "
                             f"{[(r.rid, r.status) for r in done.values()]}")
    ticks = sum(calls.values())
    narrow = sum(n for (_, w, _), n in calls.items() if w == 1)
    per_tick = qmatmul_per_tick(cfg)
    want = {"qmatmul": per_tick * ticks,
            attn[0]: cfg.n_layers * narrow,
            attn[1]: cfg.n_layers * (ticks - narrow)}
    for name, n in want.items():
        if counts[name] != n or n == 0:
            raise AssertionError(f"{name} launched {counts[name]} times in "
                                 f"{ticks} ticks ({calls}), want {n}")
    others = {n: c for n, c in counts.items() if n not in want and c}
    if others:
        raise AssertionError(f"kernels off this path launched: {others}")
    # every served bf16 qmatmul launch the plans imply, on tensor cores
    if "qmatmul" in tensor_core and by_route["qmatmul"] != {
            "tensor_core": want["qmatmul"], "cuda_core": 0}:
        raise AssertionError(f"qmatmul routes {by_route['qmatmul']}, want "
                             f"{want['qmatmul']} on tensor_core")
    st = engine.metrics.summary()
    decode_ticks = sum(n for (kind, _, _), n in calls.items()
                       if kind == "decode")
    print(f"[serve-lm] {cfg.name}: {st['requests_done']} requests (8 "
          f"greedy, 2 sampled), {st['generated_tokens']} tokens in "
          f"{st['elapsed_s']:.3f}s: {st['tokens_per_s']:.1f} tok/s, decode "
          f"{st['decode_tokens_per_s']:.1f} tok/s, TTFT p50 "
          f"{st['ttft_p50_s'] * 1e3:.1f} ms, decode interval p50 "
          f"{st['decode_interval_p50_s'] * 1e3:.2f} ms, tick p50 "
          f"{st['tick_latency_p50_s'] * 1e3:.2f} ms")
    print(f"[serve-lm] {cfg.name}: {ticks} ticks ({decode_ticks} "
          f"decode-only, {ticks - decode_ticks} mixed, {narrow} of width "
          f"1): launches qmatmul {counts['qmatmul']} = {per_tick} x "
          f"{ticks}, {attn[0]} {counts[attn[0]]} = {cfg.n_layers} x "
          f"{narrow}, {attn[1]} {counts[attn[1]]} = {cfg.n_layers} x "
          f"{ticks - narrow}; routes "
          f"{ {n: r for n, r in by_route.items() if counts[n]} }")

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
    # the fp32 comparison reads an fp32 copy of the arena, so no bf16
    # rounding of the latent or of the MLA compute dtype is left in it
    wide = {g: {n: a.float() if a.is_floating_point() else a.clone()
                for n, a in tree.items()} for g, tree in snap.items()}
    # an fp16 arena (a served storage mode, ``--cache-dtype fp16``): the
    # bf16 state rounded to fp16, the kernels computing in fp16
    half = {g: {n: a.half() if a.dtype == torch.bfloat16 else a.clone()
                for n, a in tree.items()} for g, tree in snap.items()}

    def restore(caches=None):
        caches = pool.caches if caches is None else caches
        for g, tree in caches.items():
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
    # Expert routing is a discrete choice: a rounding difference between
    # the two paths that lands on a near-tie of two gates moves a token
    # to another expert. The plain path replays the kernel path's routing
    # (dispatch and combine weights), so the comparison measures the
    # kernels; the tokens whose own routing would have differed are
    # counted and printed.
    real_dispatch = moe_mod._top_k_dispatch
    routes, moved = [], [0, 0]

    def record(*args, **kw):
        out = real_dispatch(*args, **kw)
        routes.append(out)
        return out

    def replay(*args, **kw):
        own = real_dispatch(*args, **kw)[0].any(-1)     # (G, S, E)
        rec = routes[moved[1]]
        moved[0] += int((own != rec[0].any(-1)).any(-1).sum())
        moved[1] += 1
        return rec
    for label, c, bound, caches in (
            ("bf16 as served", cfg, bounds[0], pool.caches),
            ("fp16 arena", cfg, bounds[0], half),
            ("fp32 compute and arena", exact, bounds[1], wide)):
        for kind, (tok, t, last) in (("mixed", mixed), ("decode", decode)):
            out, routes[:], moved[:] = [], [], [0, 0]
            for plain, hook in ((False, record), (True, replay)):
                restore(caches)
                ops.reset_launch_counts()
                with mock.patch.object(moe_mod, "_top_k_dispatch", hook):
                    out.append(lm_tick(runner, c, tok, t, last, plain=plain,
                                       caches=caches))
                if not plain:
                    check_routes(ops.launch_counts(routes=True),
                                 tensor_core if c is cfg else (),
                                 f"{cfg.name} {kind} tick, {label}")
            lk, lp = (o[live[kind]] for o in out)
            if not bool(torch.isfinite(lk).all()):
                raise AssertionError("LM tick: non-finite logits")
            d = float((lk - lp).abs().max())
            a = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
            agree[f"{kind}, {label}"] = (d, a)
            routed = ""
            if routes:
                total = sum(int(r[0].any(-1).any(-1).sum()) for r in routes)
                routed = (f"; routing replayed: {moved[0]} of {total} routed "
                          f"tokens would have picked other experts")
            print(f"[serve-lm] {cfg.name}: one {kind} tick kernel vs plain, "
                  f"{label}: max|d logit| {d:.4g} (logit std "
                  f"{float(lk.std()):.3g}), argmax agree {a:.3f} over "
                  f"{len(live[kind])} live rows{routed}")
            if d > bound[0] or a < bound[1]:
                raise AssertionError(f"served {kind} tick ({label}): kernel "
                                     f"path disagrees with the plain path")
    del wide, half
    restore()
    print(f"[serve-lm] {cfg.name}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"launches": counts, "routes": by_route, "runner": runner,
            "cfg": cfg,
            "mixed": mixed, "decode": decode, "restore": restore,
            "per_tick": per_tick}


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
        out[kind] = trace(f"one {kind} tick ({served['cfg'].name}, B={B}, "
                          f"C={t.shape[1]})", enqueue)
    return out


# ---------------------------------------------------------------------------
# MLA slice: full-width deepseek-v3-671b, cut to 4 layers

DS_ARCH = "deepseek-v3-671b"
# 3 mla_dense + 1 mla_moe layer: the least depth that keeps every kind
# of layer (the published 61 layers are 3 + 58); widths, the 256 routed
# experts, top-8 and the shared expert as published
DS_LAYERS = 4
KVR, ROPE, NOPE, DS_H = 512, 64, 128, 128
MLA_SCALE = (NOPE + ROPE) ** -0.5
MLA_POSITIONS = (160, 2048)
# one served tick, kernel path vs plain path (bounds stated before the
# first run on the card): the tick is 4 layers deep; bf16 as served
# allows 0.5, fp32 compute (and an fp32 copy of the arena) 0.02: only
# summation order differs. The MoE routing is replayed (phase_lm_serve).
DS_TICK_BF16 = (0.5, 0.5)
DS_TICK_FP32 = (0.02, 0.75)


def latent_inputs(rs, b, c, fills, arena, *, holes=(), t_blocks,
                  q_dtype=torch.bfloat16):
    """MLA inputs on the card as the read sees them mid-tick: the arena
    of :func:`paged_inputs` with one KV head of width 512 + 64, split
    into the latent c (n_blocks, 16, 512) and kr (n_blocks, 16, 64) in
    the storage dtype ``arena``; q_abs (b, c, 128, 512) and q_rope (b,
    c, 128, 64)."""
    x = paged_inputs(rs, b, 1, 1, c, fills, torch.float32, holes=holes,
                     t_blocks=t_blocks, hd=KVR + ROPE)
    lat = x["k"][:, :, 0]
    cl, kr = lat[..., :KVR].contiguous(), lat[..., KVR:].contiguous()
    if arena == torch.int8:
        (cl, cs), (kr, krs) = pa.quantize_kv(cl), pa.quantize_kv(kr)
    else:
        cl, kr, cs, krs = cl.to(arena), kr.to(arena), None, None
    qa = torch.from_numpy(rs.randn(b, c, DS_H, KVR).astype(np.float32))
    qr = torch.from_numpy(rs.randn(b, c, DS_H, ROPE).astype(np.float32))
    return dict(qa=qa.to("cuda", q_dtype), qr=qr.to("cuda", q_dtype),
                c=cl, kr=kr, c_scale=cs, kr_scale=krs, pos=x["pos"],
                t=x["t"], table=x["table"])


def mla_call(x, fn_chunk, fn_single, **kw):
    """(kernel-or-plain) call on ``latent_inputs``: the single-token
    function for C == 1, the chunk function otherwise; returns o_lat
    (B, C, H, kvr)."""
    kw.update(scale=MLA_SCALE, c_scale=x["c_scale"],
              kr_scale=x["kr_scale"])
    if x["qa"].shape[1] == 1:
        return fn_single(x["qa"][:, 0], x["qr"][:, 0], x["c"], x["kr"],
                         x["pos"], x["t"][:, 0].contiguous(), x["table"],
                         **kw)[:, None]
    return fn_chunk(x["qa"], x["qr"], x["c"], x["kr"], x["pos"], x["t"],
                    x["table"], **kw)


def mla_kernel(x, path=None):
    """The kernel call; ``path`` names a route (timing only)."""
    return mla_call(x, pa.mla_paged_chunk_cuda, pa.mla_paged_cuda,
                    path=path)


def mla_plain(x):
    return mla_call(x, ref.mla_paged_chunk_ref, ref.mla_paged_ref)


def mla_library(x):
    """Gather + F.scaled_dot_product_attention with the validity mask,
    the latent as one shared KV head (keys [c | kr], values c): the
    same function from library calls, timed only, never used by the
    port."""
    qa, qr, c, kr, pos, t, table = (x[n] for n in ("qa", "qr", "c", "kr",
                                                   "pos", "t", "table"))
    B, Cq = qa.shape[:2]
    L = table.shape[1] * BLOCK

    def fn():
        idx = table.long().clamp(min=0)
        cr = c[idx].reshape(B, 1, L, KVR).to(qa.dtype)
        krr = kr[idx].reshape(B, 1, L, ROPE).to(qa.dtype)
        q = torch.cat([qa, qr], -1).transpose(1, 2)     # (B, H, C, 576)
        mask = (pos[:, None, :] >= 0) & (pos[:, None, :] <= t[:, :, None])
        return F.scaled_dot_product_attention(
            q, torch.cat([cr, krr], -1), cr, attn_mask=mask[:, None],
            scale=MLA_SCALE, enable_gqa=True)
    return fn


def mla_bound(x) -> tuple:
    """Least time for one call on this run's data: each assigned block's
    latent and rope rows (and scales, positions) read once, q_abs,
    q_rope, t and the table read, the fp32 o_lat written; 2 (kvr + rope)
    flops per query row and cached position for the scores and 2 kvr
    for PV."""
    qa, c = x["qa"], x["c"]
    B, Cq, H, kvr = qa.shape
    bl = c.shape[1]
    blocks = int((x["table"] >= 0).sum())
    lat = blocks * bl * (KVR + ROPE) * c.element_size()
    if x["c_scale"] is not None:
        lat += blocks * bl * 4 * 2
    nbytes = (lat + blocks * bl * 4
              + (qa.numel() + x["qr"].numel()) * qa.element_size()
              + B * Cq * H * kvr * 4 + x["t"].numel() * 4
              + x["table"].numel() * 4)
    flops = 2 * blocks * bl * Cq * H * (2 * KVR + ROPE)
    return bound_ms(nbytes, flops, torch.bfloat16)


def phase_mla_kernel() -> dict:
    """mla_paged / mla_paged_chunk vs their plain versions at
    deepseek-v3's widths on every arena dtype, then timed."""
    rs = np.random.RandomState(2)
    err = {"mla_paged": 0.0, "mla_paged_chunk": 0.0}
    for npos in MLA_POSITIONS:
        T = npos // BLOCK
        for arena in ATTN_TOL:
            for c in (1, 16):
                x = latent_inputs(
                    rs, 4, c, [T * BLOCK - c, BLOCK - 1, 0, npos // 2],
                    arena, holes=[(0, 5)], t_blocks=T,
                    q_dtype=(torch.float32 if arena == torch.float32
                             else torch.bfloat16))
                x["t"][3, 1:] = -1         # a decode row padded to C
                if c == 1:
                    x["t"][2] = -1         # a free slot
                name = "mla_paged" if c == 1 else "mla_paged_chunk"
                fn = getattr(pa, f"{name}_cuda")
                route = ("cuda_core" if arena == torch.float32
                         else "tensor_core")
                picked = pa.mla_route(arena, KVR, ROPE, BLOCK, npos)
                if picked != route:
                    raise AssertionError(f"{name} {arena}: route {picked}, "
                                         f"want {route}")
                before = dict(fn.routes)
                got = mla_kernel(x)
                if fn.routes != {**before, route: before[route] + 1}:
                    raise AssertionError(f"{name} C={c} {arena}: routes "
                                         f"{before} -> {fn.routes}, want "
                                         f"{route}")
                want = mla_plain(x)
                torch.cuda.synchronize()
                live = x["t"] >= 0
                if got.shape != (4, c, DS_H, KVR) or \
                        not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"mla_paged: {tuple(got.shape)} "
                                         f"or non-finite output")
                tol = ATTN_TOL[arena]
                torch.testing.assert_close(got[live], want[live], rtol=tol,
                                           atol=tol)
                e = float((got - want)[live].abs().max())
                if arena == torch.bfloat16 and npos == MLA_POSITIONS[0]:
                    err[name] = max(err[name], e)
                print(f"[kernel] {name} H={DS_H} kvr={KVR} rope={ROPE} "
                      f"C={c} {str(arena)[6:]} positions {npos} ({route}): "
                      f"max|err| {e:.3g} ok")
    # both routes (path=, timing only) of the decode at the served fill,
    # the whole table and 2048 positions, and of the chunk at 160 and
    # 2048; bf16 arena, the route the wrapper picks is the "ms"
    timing = {}
    for c, npos in ((1, MLA_POSITIONS[0]), (1, FULL_POSITIONS),
                    (1, MLA_POSITIONS[1]), (16, MLA_POSITIONS[0]),
                    (16, MLA_POSITIONS[1])):
        x = latent_inputs(rs, LM_SLOTS, c, [npos - c] * LM_SLOTS,
                          torch.bfloat16, t_blocks=npos // BLOCK)
        bms, by = mla_bound(x)
        arena = x["c"].numel() * x["c"].element_size()
        xs = [dict(x, c=x["c"].clone(), kr=x["kr"].clone())
              for _ in range(max(1, -(-(128 << 20) // arena)))]
        row = {path: device_ms([functools.partial(mla_kernel, xi, path)
                                for xi in xs]) for path in pa.ROUTES}
        row.update({
            "ms": row[pa.mla_route(torch.bfloat16, KVR, ROPE, BLOCK, npos)],
            "plain_ms": device_ms([functools.partial(mla_plain, xi)
                                   for xi in xs], reps=3),
            "library_ms": device_ms([mla_library(xi) for xi in xs]),
            "bound_ms": bms, "bound_by": by})
        name = "mla_paged" if c == 1 else "mla_paged_chunk"
        timing[(name, npos)] = row
        print(f"[kernel] {name} bf16 B={LM_SLOTS} C={c} H={DS_H} "
              f"kvr={KVR} rope={ROPE} positions 0..{npos - 1}: tensor_core "
              f"{row['tensor_core']:.4f} ms | cuda_core "
              f"{row['cuda_core']:.4f} ms | plain {row['plain_ms']:.4f} ms "
              f"| library {row['library_ms']:.4f} ms | bound "
              f"{bms * 1e3:.2f} us ({by})")
        del xs
    return {"err": err, "timing": timing}


# ---------------------------------------------------------------------------
# Prefill slice: the static path of full-width mamba2-130m and qwen1.5-4b

SSM_ARCH = "mamba2-130m"
STATIC_SLOTS = 4
SSM_PROMPT = 2048             # mamba2 prompt tokens per row
QWEN_PROMPT = 512             # qwen1.5-4b prompt tokens per row
STATIC_NEW = 32               # greedy new tokens per row
FLASH_TOL = {torch.float32: (1e-4, 1e-4),   # tests/test_kernels.py:44
             torch.bfloat16: (2 ** -7, 1e-5)}
# SSD: fp32 at tests/test_kernels.py:101's 5e-3; bf16 y at one bf16 ulp
# (2^-7 relative) with atol 1e-3 for fp32 order noise on |y| up to ~50;
# the fp32 state at 5e-3 in both
SSD_TOL = {torch.float32: (5e-3, 5e-3), torch.bfloat16: (2 ** -7, 1e-3)}
# One whole-prompt prefill through the kernel vs through its plain
# version (bounds stated before the first run on the card): (max |d
# logit| of the last position, max |d| / max |ref| of every layer's
# handed-off state). fp32: only fp32 summation order differs. bf16 as
# served: a one-ulp difference of a layer's bf16 output can start
# anywhere and carry through 24 (mamba2) or 40 (qwen) residual layers.
SSM_PREFILL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (0.25, 0.05)}
QWEN_PREFILL = {torch.float32: (0.02, 1e-3), torch.bfloat16: (0.25, 0.05)}


def flash_inputs(rs, b, s, h, hkv, dtype, d=HD):
    return tuple(torch.from_numpy(rs.randn(b, s, n, d).astype(np.float32))
                 .to("cuda", dtype) for n in (h, hkv, hkv))


def flash_bound(b, sq, sk, h, hkv, d, esize, causal) -> tuple:
    """q, k, v read once and out written once; 4 d flops per (query,
    key) pair the mask keeps (k <= q when causal)."""
    nbytes = esize * d * (2 * b * sq * h + 2 * b * sk * hkv)
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal
             else sq * sk)
    return bound_ms(nbytes, 4 * d * pairs * b * h, torch.bfloat16)


def ssd_inputs(rs, b, s, dtype, nh=24, hd=64, n=128):
    """mamba2-130m's SSD shapes: dt from softplus of the smallest
    dt_bias band, A across the model's -1..-16."""
    x = torch.from_numpy(rs.randn(b, s, nh, hd).astype(np.float32))
    dt = torch.from_numpy((rs.rand(b, s, nh) * 0.1).astype(np.float32))
    bm = torch.from_numpy(rs.randn(b, s, n).astype(np.float32))
    cm = torch.from_numpy(rs.randn(b, s, n).astype(np.float32))
    D = torch.from_numpy(rs.rand(nh).astype(np.float32) + 0.5)
    A = -torch.linspace(1.0, 16.0, nh)
    return (x.to("cuda", dtype), dt.cuda(), A.cuda(), bm.to("cuda", dtype),
            cm.to("cuda", dtype), D.cuda())


def ssd_bound(b, s, nh, hd, n, esize, chunk=256) -> tuple:
    """x, dt, B, C read once, y and the fp32 state written once; flops of
    the chunked form at the reference's chunk: C.B^T once per batch row
    and chunk (causal half), then per head M.x, C.h and the state
    update."""
    nbytes = (2 * b * s * nh * hd * esize + b * s * nh * 4
              + 2 * b * s * n * esize + b * nh * hd * n * 4 + 2 * nh * 4)
    tri = chunk * (chunk + 1) // 2
    chunks = -(-s // chunk)
    flops = 2 * b * chunks * (tri * n + nh * (tri * hd + 2 * chunk * n * hd))
    return bound_ms(nbytes, flops, torch.bfloat16)


def flash_p_terms(q, k, v) -> tuple:
    """The bf16 tensor-core flash kernel's arithmetic in plain PyTorch on
    the card (64-key tiles, online softmax, bf16 operands), causal, with
    P . V taking p as one bf16 term and as the kernel's two (p_hi +
    p_lo); returns the max |error| of each fp32 output against the
    reference's fp32 p (``ref.flash_attention_gqa_ref``)."""
    B, S, H, d = q.shape
    qf, kf, vf = (a.float().transpose(1, 2) for a in (q, k, v))
    want = ref.flash_attention_gqa_ref(*(a.float() for a in (q, k, v)),
                                       causal=True).transpose(1, 2)
    rows = torch.arange(S, device=q.device)[:, None]
    errs = []
    for terms in (1, 2):
        m = torch.full((B, H, S, 1), -1e30, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf)
        for k0 in range(0, S, 64):
            kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
            sc = (qf @ kt.transpose(-1, -2)) * d ** -0.5
            keys = torch.arange(k0, k0 + kt.shape[2], device=q.device)
            sc = torch.where(keys[None] <= rows, sc,
                             torch.full_like(sc, -1e30))
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            pr = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(-1, keepdim=True)
            hi = pr.to(torch.bfloat16).float()
            pv = hi @ vt
            if terms == 2:
                pv = pv + (pr - hi).to(torch.bfloat16).float() @ vt
            acc = acc * corr + pv
            m = m_new
        errs.append(float((acc / l - want).abs().max()))
    return tuple(errs)


def phase_prefill_kernel() -> dict:
    """flash_attention and ssd_scan vs their plain versions at the
    served shapes and ragged ones, then timed at the served shapes."""
    rs = np.random.RandomState(3)
    err = {"flash_attention": 0.0, "ssd_scan": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, sk, h, hkv, causal in (
                (STATIC_SLOTS, QWEN_PROMPT, QWEN_PROMPT, 20, 20, True),
                (STATIC_SLOTS, QWEN_PROMPT, QWEN_PROMPT, 20, 20, False),
                (2, 333, 333, 20, 20, True),
                (2, QWEN_PROMPT, QWEN_PROMPT, 16, 2, True),
                (2, 333, 333, 16, 2, True), (2, 200, 77, 16, 2, False),
                (1, 2048, 2048, 20, 20, True), (2, 129, 129, 20, 20, True)):
            q, k, v = flash_inputs(rs, b, s, h, hkv, dtype)
            k, v = (a[:, :sk].contiguous() for a in (k, v))
            route = fa.route(dtype)
            before = dict(fa.flash_attention_cuda.routes)
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            if fa.flash_attention_cuda.routes != {
                    **before, route: before[route] + 1}:
                raise AssertionError(f"flash_attention {dtype}: routes "
                                     f"{before} -> "
                                     f"{fa.flash_attention_cuda.routes}")
            want = ref.flash_attention_gqa_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if got.shape != q.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flash_attention {tuple(got.shape)} "
                                     f"or non-finite")
            rtol, atol = FLASH_TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=atol)
            e = float((got.float() - want.float()).abs().max())
            if dtype == torch.bfloat16 and (s, h, causal) == (
                    QWEN_PROMPT, 20, True):
                err["flash_attention"] = e
            print(f"[kernel] flash_attention {str(dtype)[6:]} B={b} Sq={s} "
                  f"Sk={sk} H={h} Hkv={hkv} d={HD} causal={int(causal)} "
                  f"({route}): max|err| {e:.3g} ok")
        # bf16 on both routes (the tensor-core route is the one routed),
        # fp32 on the CUDA-core route
        paths = (("tensor_core", "cuda_core") if dtype == torch.bfloat16
                 else ("cuda_core",))
        for s, path in ((s, p) for s in (SSM_PROMPT, 2000) for p in paths):
            args = ssd_inputs(rs, STATIC_SLOTS, s, dtype)
            fn = ssd.ssd_scan_cuda
            before = dict(fn.routes)
            routed = ssd.route(dtype, 64, 128) == path
            y, h = fn(*args, chunk=256, path=None if routed else path)
            if fn.routes != {**before, path: before[path] + 1}:
                raise AssertionError(f"ssd_scan {dtype}: routes {before} -> "
                                     f"{fn.routes}, want {path}")
            wy, wh = ref.ssd_chunked(*args, 256)
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(y).all())
                    and bool(torch.isfinite(h).all())):
                raise AssertionError("ssd_scan: non-finite output")
            rtol, atol = SSD_TOL[dtype]
            torch.testing.assert_close(y.float(), wy.float(), rtol=rtol,
                                       atol=atol)
            torch.testing.assert_close(h, wh, rtol=5e-3, atol=5e-3)
            ey = float((y.float() - wy.float()).abs().max())
            eh = float((h - wh).abs().max())
            if dtype == torch.bfloat16 and s == SSM_PROMPT and routed:
                err["ssd_scan"] = ey
            print(f"[kernel] ssd_scan {str(dtype)[6:]} B={STATIC_SLOTS} "
                  f"S={s} nh=24 hd=64 N=128 chunk=256 ({path}"
                  f"{'' if routed else ', named'}): max|err| y {ey:.3g} "
                  f"(max|y| {float(wy.float().abs().max()):.3g}), state "
                  f"{eh:.3g} ok")
    # P . V with the reference's fp32 p: one bf16 term against two, at
    # the served shape (bf16-representable inputs, fp32 outputs)
    q, k, v = flash_inputs(rs, STATIC_SLOTS, QWEN_PROMPT, 20, 20,
                           torch.bfloat16)
    one, two = flash_p_terms(q, k, v)
    err["flash_p_terms"] = {"one": one, "two": two}
    print(f"[kernel] flash_attention P . V, B={STATIC_SLOTS} S={QWEN_PROMPT}"
          f" H=20 causal, fp32 output vs the reference's fp32 p: max|err| "
          f"{one:.3g} with p as one bf16 term, {two:.3g} as p_hi + p_lo")
    del q, k, v
    # device times at the served shapes (bf16), each call on its own copy
    # of the inputs (>= 128 MB in all, from HBM)
    timing = {}
    b, s, h = STATIC_SLOTS, QWEN_PROMPT, 20
    per = 4 * b * s * h * HD * 2
    xs = [flash_inputs(rs, b, s, h, h, torch.bfloat16)
          for _ in range(max(2, -(-(128 << 20) // per)))]
    bms, by = flash_bound(b, s, s, h, h, HD, 2, True)
    timing["flash_attention"] = {
        "ms": device_ms([functools.partial(fa.flash_attention_cuda, *x,
                                           causal=True) for x in xs]),
        "plain_ms": device_ms([functools.partial(
            ref.flash_attention_gqa_ref, *x, causal=True) for x in xs]),
        "library_ms": device_ms([functools.partial(
            F.scaled_dot_product_attention, *(a.transpose(1, 2) for a in x),
            is_causal=True, enable_gqa=True) for x in xs]),
        "bound_ms": bms, "bound_by": by,
        "shape": f"bf16 B={b} S={s} H={h} Hkv={h} d={HD} causal"}
    del xs
    per = 2 * STATIC_SLOTS * SSM_PROMPT * 24 * 64 * 2
    xs = [ssd_inputs(rs, STATIC_SLOTS, SSM_PROMPT, torch.bfloat16)
          for _ in range(max(2, -(-(128 << 20) // per)))]
    bms, by = ssd_bound(STATIC_SLOTS, SSM_PROMPT, 24, 64, 128, 2)
    timing["ssd_scan"] = {
        "ms": device_ms([functools.partial(ssd.ssd_scan_cuda, *x, chunk=256)
                         for x in xs]),
        "cuda_core_ms": device_ms([functools.partial(
            ssd.ssd_scan_cuda, *x, chunk=256, path="cuda_core")
            for x in xs]),
        "plain_ms": device_ms([functools.partial(ref.ssd_chunked, *x, 256)
                               for x in xs], reps=3),
        "library_ms": None,
        "bound_ms": bms, "bound_by": by,
        "shape": f"bf16 B={STATIC_SLOTS} S={SSM_PROMPT} nh=24 hd=64 N=128 "
                 f"chunk=256"}
    del xs
    for name, row in timing.items():
        lib = ("no single PyTorch call" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        other = (f" | cuda_core route {row['cuda_core_ms']:.4f} ms"
                 if "cuda_core_ms" in row else "")
        print(f"[kernel] {name} {row['shape']}: kernel {row['ms']:.4f} ms"
              f"{other} | plain {row['plain_ms']:.4f} ms | library {lib} | "
              f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})")
    return {"err": err, "timing": timing}


def prefill_both_paths(params, cfg, tokens, swap, dtype, tensor_core=()):
    """One whole-prompt prefill through the kernel and through its plain
    version (``swap``: (module, wrapper name, plain function)) on the
    same tokens, in ``dtype``; returns the max |d logit| of the last
    position and the worst max |d| / max |ref| over the handed-off
    cache leaves (every layer). The kernel pass's launches of a kernel in
    ``tensor_core`` take the tensor-core route in bf16, and every other
    launch the CUDA-core route."""
    cfg = replace(cfg, dtype=str(dtype)[6:])
    p = tree_map(lambda t: t.to(dtype), params)
    out = []
    for plain in (False, True):
        ctx = (mock.patch.object(*swap) if plain
               else contextlib.nullcontext())
        ops.reset_launch_counts()
        with ctx, torch.no_grad():
            out.append(tfm.prefill(p, tokens, cfg, cache_len=tokens.shape[1],
                                   cache_dtype=dtype))
        if not plain:
            check_routes(ops.launch_counts(routes=True),
                         tensor_core if dtype == torch.bfloat16 else (),
                         f"{cfg.name} prefill, {dtype}")
    (lk, ck), (lp, cp) = out
    if not bool(torch.isfinite(lk).all()):
        raise AssertionError("prefill: non-finite logits")
    d_logit = float((lk.float() - lp.float()).abs().max())
    d_state = 0.0
    for g, tree in cp.items():
        for name, want in tree.items():
            if not want.is_floating_point():
                continue
            got = ck[g][name].float()
            scale = float(want.float().abs().max()) or 1.0
            d_state = max(d_state, float((got - want.float()).abs().max())
                          / scale)
    return d_logit, d_state, float(lk.float().std())


def phase_static(cfg, prompt: int, kernel: str, swap, bounds,
                 wbits: int = 0, tensor_core: tuple = (),
                 share: tuple = ()) -> dict:
    """The static path at full width through ``launch/serve.py``'s
    ``run_static``: seeded weights drawn on the card (``wbits``: packed
    as drawn and dequantized once up front, as ``--static --wbits``
    does), 4 prompts of ``prompt`` tokens, 32 greedy new tokens. Checks
    ``kernel`` launched once per layer in the prefill and never in the
    decode, and no other kernel; then the prefill through the kernel vs
    its plain version in fp32 and bf16; then traces one prefill."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(0, cfg, device="cuda", wbits=wbits)
    if wbits:
        params = serve.dequantize_tree(params, getattr(torch, cfg.dtype))
    torch.cuda.synchronize()
    print(f"[static] {cfg.name}: {cfg.n_layers} layers "
          f"{[k for k, _ in tfm.layer_plan(cfg)]}, d {cfg.d_model}, "
          f"{cfg.dtype} weights ({torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB{', int8-packed as drawn, dequantized once' if wbits else ''}"
          f") in {time.perf_counter() - t0:.1f}s")
    args = types.SimpleNamespace(slots=STATIC_SLOTS, prompt_len=prompt,
                                 tokens=STATIC_NEW, seed=0)
    warm = types.SimpleNamespace(**{**vars(args), "tokens": 2, "seed": 1})
    serve.run_static(params, cfg, warm, "cuda")
    ops.reset_launch_counts()
    r = serve.run_static(params, cfg, args, "cuda")
    counts = ops.launch_counts()
    routes = ops.launch_counts(routes=True)
    check_routes(routes, tensor_core, f"{cfg.name} static")
    want = {kernel: cfg.n_layers}
    if r["launches_prefill"] != want or r["launches_decode"] or \
            {k: c for k, c in counts.items() if c} != want:
        raise AssertionError(f"{cfg.name}: launches prefill "
                             f"{r['launches_prefill']}, decode "
                             f"{r['launches_decode']}, want {want} and none")
    toks = r["tokens"]
    if toks.shape != (STATIC_SLOTS, STATIC_NEW) or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: tokens {tuple(toks.shape)}")
    n_dec = STATIC_SLOTS * (STATIC_NEW - 1)
    row = {"prefill_ms": r["prefill_s"] * 1e3,
           "decode_tok_s": n_dec / r["decode_s"],
           "launches": counts[kernel], "routes": routes[kernel]}
    print(f"[static] {cfg.name}: prefill {STATIC_SLOTS}x{prompt} "
          f"{row['prefill_ms']:.2f} ms, decode {n_dec} tokens "
          f"{row['decode_tok_s']:.1f} tok/s; {kernel} launches "
          f"{counts[kernel]} = {cfg.n_layers} x 1 prefill, 0 in "
          f"{STATIC_NEW - 1} decode steps; routes {routes[kernel]}")
    del r
    tokens = api.make_smoke_batch(2, cfg, STATIC_SLOTS, prompt,
                                  device="cuda")["tokens"]
    for dtype in (torch.float32, torch.bfloat16):
        dl, ds, std = prefill_both_paths(params, cfg, tokens, swap, dtype,
                                         tensor_core)
        print(f"[static] {cfg.name}: prefill kernel vs plain, "
              f"{str(dtype)[6:]}: max|d logit| {dl:.4g} (logit std "
              f"{std:.3g}), handed-off state max|d|/max|ref| {ds:.3g}")
        if dl > bounds[dtype][0] or ds > bounds[dtype][1]:
            raise AssertionError(f"{cfg.name} prefill ({dtype}): kernel "
                                 f"path disagrees with the plain path")
    gc.collect()
    torch.cuda.empty_cache()
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"[static] {cfg.name}: peak device memory {row['peak_gib']:.2f} "
          f"GiB")

    def enqueue():
        with torch.no_grad():
            return tfm.prefill(params, tokens, cfg,
                               cache_len=prompt + STATIC_NEW)[0]
    row["trace"] = trace(f"one prefill ({cfg.name}, B={STATIC_SLOTS}, "
                         f"S={prompt})", enqueue, share)
    del params
    return row


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
    laps = {}

    def lap(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        laps[name] = time.perf_counter() - t
        print(f"[chip_smoke] phase {name}: {laps[name]:.1f}s")
        return out
    lap("build", phase_build)
    kern = lap("kernel", phase_kernel)
    served = lap("serve", phase_serve)
    lm_kern = lap("kernel (LM)", phase_lm_kernel)
    mla_kern = lap("kernel (MLA)", phase_mla_kernel)
    qwen = replace(get_config(LM_ARCH), quant=QuantPolicy(8, 0))
    lm = lap("serve (LM)", phase_lm_serve, qwen,
             ("gqa_paged", "gqa_paged_chunk"), (LM_TICK_BF16, LM_TICK_FP32),
             ("gqa_paged", "gqa_paged_chunk", "qmatmul"))
    lap("trace (LM)", phase_lm_trace, lm)
    lm_launches, lm_per_tick = lm["launches"], lm["per_tick"]
    lm_routes = lm["routes"]
    lm.clear()                             # free qwen's engine and weights
    gc.collect()
    torch.cuda.empty_cache()
    ds_cfg = replace(get_config(DS_ARCH), n_layers=DS_LAYERS,
                     quant=QuantPolicy(8, 0))
    ds = lap("serve (MLA)", phase_lm_serve, ds_cfg,
             ("mla_paged", "mla_paged_chunk"), (DS_TICK_BF16, DS_TICK_FP32),
             ("qmatmul", "mla_paged", "mla_paged_chunk"))
    lap("trace (MLA)", phase_lm_trace, ds)
    ds_launches, ds_routes = ds["launches"], ds["routes"]
    ds.clear()                             # free deepseek's engine
    pre = lap("kernel (prefill)", phase_prefill_kernel)
    ssm_run = lap("static (mamba2)", phase_static, get_config(SSM_ARCH),
                  SSM_PROMPT, "ssd_scan", (ssd, "ssd_scan_cuda",
                                           ref.ssd_chunked), SSM_PREFILL,
                  0, ("ssd_scan",), ("ssd_",))
    qwen_run = lap("static (qwen1.5-4b)", phase_static, get_config(LM_ARCH),
                   QWEN_PROMPT, "flash_attention",
                   (fa, "flash_attention_cuda", ref.flash_attention_gqa_ref),
                   QWEN_PREFILL, 8, ("flash_attention",), ("flash_",))
    blocks_k = [get_config("rubicall").kernel_sizes[i] for i in KERNEL_BLOCKS]

    def forward_sum(pk):
        """One forward's 19 launches summed, per timed quantity."""
        out = {key: sum(pk[k][key] for k in blocks_k)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        out["bound_by"] = pk[max(blocks_k)]["bound_by"]
        return out
    routes = {r: {**forward_sum(pk),
                  "per_k": {str(k): v for k, v in pk.items()}}
              for r, pk in kern["per_route"].items()}
    kernels = [{
        "name": "qconv1d_block", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/qconv1d.cu",
        "replaces": "src/repro/kernels/qconv1d.py:38",
        "launches": served["launches"], "max_abs_err": kern["err_main"],
        **forward_sum(kern["per_route"]["tensor_core"]),
        "shape": f"sum over one forward's {len(blocks_k)} launches, bf16 "
                 f"(qconv1d_tc_kernel) B={B} T={T_MAIN} C={C} k={blocks_k}",
        "launches_by_route": served["routes"],
        "routes": {"tensor_core": {"kernel": "qconv1d_tc_kernel", "x": "bf16",
                                   **routes["tensor_core"]},
                   "cuda_core": {"kernel": "qconv1d_block_kernel",
                                 "x": "fp32", **routes["cuda_core"]}},
    }]
    qt = lm_kern["timing"]["qmatmul"]
    plan = qwen_qmatmul_plan()
    if sum(plan.values()) != lm_per_tick:
        raise AssertionError(f"qmatmul timing covers {plan}, the served "
                             f"tick launches {lm_per_tick}")
    decode = qmatmul_tick(qt, LM_SLOTS)
    mixed = qmatmul_tick(qt, LM_SLOTS * LM_CHUNK)
    kernels.append({
        "name": "qmatmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/qmatmul.cu",
        "replaces": "src/repro/kernels/qmatmul.py:57",
        "launches": lm_launches["qmatmul"] + ds_launches["qmatmul"],
        "max_abs_err": lm_kern["err"]["qmatmul"],
        **{key: decode[key] for key in ("ms", "plain_ms", "bound_ms",
                                        "library_ms")},
        "bound_by": "bytes",
        "shape": f"sum over one qwen1.5-4b decode tick's "
                 f"{sum(plan.values())} launches, int8 weights, bf16 x, "
                 f"M={LM_SLOTS} (qmatmul_tc_kernel); launches: both LM "
                 f"phases",
        "mixed_tick": {**mixed, "M": LM_SLOTS * LM_CHUNK},
        "launches_by_phase": {LM_ARCH: lm_launches["qmatmul"],
                              DS_ARCH: ds_launches["qmatmul"]},
        "launches_by_route": {
            r: lm_routes["qmatmul"][r] + ds_routes["qmatmul"][r]
            for r in qmm.ROUTES},
        "routes": {r: {"kernel": kern, "x": "bf16 (timed); served: "
                       + x, "decode_tick_ms": decode[r],
                       "mixed_tick_ms": mixed[r]}
                   for r, kern, x in (
                       ("tensor_core", "qmatmul_tc_kernel", "bf16"),
                       ("cuda_core", "qmatmul_kernel", "fp32"))},
        "per_shape": {f"M={m} K={k} N={n}": row
                      for (m, k, n), row in qt.items()}})
    attn = lm_kern["timing"]["attn"]
    for name, replaces in (("gqa_paged", 260), ("gqa_paged_chunk", 492)):
        row = attn[name]
        extra = {f"per_call_{n}_positions": attn[f"{name}@{n}"]
                 for n in (FULL_POSITIONS, LONG_POSITIONS)
                 if f"{name}@{n}" in attn}
        if f"{name}/cuda_core" in attn:
            extra["routes"] = {
                "tensor_core": {"arena": "bf16", **row},
                "cuda_core": {"arena": "fp32", **attn[f"{name}/cuda_core"]}}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": f"src/repro/kernels/paged_attention.py:{replaces}",
            "launches": lm_launches[name],
            "max_abs_err": lm_kern["err"][name],
            **{key: (row[key] * qwen.n_layers if key.endswith("ms")
                     else row[key]) for key in row},
            "shape": f"sum over one tick's {qwen.n_layers} launches, bf16 "
                     f"arena, B={LM_SLOTS} Hkv=20 hd={HD} block_len={BLOCK}"
                     f", positions 0..159, C="
                     f"{1 if name == 'gqa_paged' else 16}",
            "launches_by_route": lm_routes[name],
            "per_call": row, **extra})
    for name, replaces in (("mla_paged", 372), ("mla_paged_chunk", 608)):
        row = mla_kern["timing"][(name, MLA_POSITIONS[0])]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mla_paged_attention.cu",
            "replaces": f"src/repro/kernels/paged_attention.py:{replaces}",
            "launches": ds_launches[name],
            "max_abs_err": mla_kern["err"][name],
            **{key: (row[key] * DS_LAYERS if key.endswith("ms")
                     else row[key]) for key in row if key not in pa.ROUTES},
            "shape": f"sum over one tick's {DS_LAYERS} launches, bf16 "
                     f"latent arena, B={LM_SLOTS} H={DS_H} kvr={KVR} "
                     f"rope={ROPE} block_len={BLOCK}, positions "
                     f"0..{MLA_POSITIONS[0] - 1}, C="
                     f"{1 if name == 'mla_paged' else 16}",
            "launches_by_route": ds_routes[name],
            "per_call": row,
            **{f"per_call_{n}_positions": mla_kern["timing"][(name, n)]
               for n in (FULL_POSITIONS, MLA_POSITIONS[1])
               if (name, n) in mla_kern["timing"]},
            "routes": {r: {"kernel": k, "arena": "bf16 (timed); served: "
                           + a, "per_call_ms": row[r]}
                       for r, k, a in (
                           ("tensor_core", "mla_tc_kernel",
                            "bf16, fp16, fp8, int8"),
                           ("cuda_core", "mla_paged_kernel", "fp32"))}})
    for name, src, replaces, run, arch in (
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:68", qwen_run, LM_ARCH),
            ("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:62",
             ssm_run, SSM_ARCH)):
        row = pre["timing"][name]
        n = run["launches"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": n,
            "max_abs_err": pre["err"][name],
            **{key: (row[key] * n if key.endswith("ms") and row[key]
                     is not None else row[key]) for key in row
               if key != "shape"},
            "shape": f"sum over one {arch} prefill's {n} launches, "
                     f"{row['shape']}",
            "launches_by_route": run["routes"],
            "per_call": row,
            "static": {k: v for k, v in run.items() if k != "trace"},
            "prefill_trace": run["trace"],
            **({"p_terms_max_abs_err": pre["err"]["flash_p_terms"]}
               if name == "flash_attention" else {})})
    print(f"[chip_smoke] all phases ok in {time.perf_counter() - t0:.1f}s "
          f"({', '.join(f'{k} {v:.0f}s' for k, v in laps.items())})")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
