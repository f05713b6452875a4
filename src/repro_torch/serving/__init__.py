"""Continuous-batching serving on the H100: one engine for the LMs, the
audio family and the basecaller itself.

Layers
======

``engine``   :class:`ServingEngine`, pure host-side scheduling (a copy
             of the reference's): FIFO queue, fixed slot pool,
             admission, the unified mixed tick (prefill chunks and
             decode tokens in one runner step), preemption of the
             youngest with resume by re-prefill, backpressure, metrics.
             It imports no model code.
``runner``   the :class:`ModelRunner` protocol and its registry
             (:func:`make_runner`): ``TokenRunner`` (token-only LMs over
             the paged KV pool), ``EncoderPrefixRunner`` (the audio
             family: the encoder once at admission, cross-attention K/V
             staged per slot) and ``BasecallerRunner`` (squiggle in,
             bases out, halo-padded windows, live streams and
             read-until).
``plan``     the tick buckets' staged plans: each tick's host inputs
             copied into static device buffers; on a card each bucket
             captured once as a CUDA graph at ``warmup()`` and replayed
             every tick (the reference compiles one program a bucket),
             eager on the CPU, with ``graphs=False``, and for a runner
             with a MoE block (its routing is read back to the host).
``cache``    :class:`CachePool`, the paged KV pool: one block arena a
             layer group on the device, host block tables, per-slot
             positions; storage ``bf16``, ``fp8``, ``int8`` (with scale
             arenas written at the same indices), ``fp16`` or ``fp32``,
             each stored as asked.
``sampling`` :class:`SamplingParams`: stopping criteria and per-request
             temperature, top-k, top-p and seed, sampled on the device.
``stream``   :class:`StreamingRequest` and :class:`ReadUntil`: live reads
             and selective sequencing for the basecaller.

The decode reads of the pool go through ``kernels/ops.decode_gqa`` and
``decode_mla``: ``cuda`` launches the hand-written paged-attention
kernels, ``gather`` is the plain reference (the parity oracle), and
``auto`` takes ``cuda`` on a card.

Invariants
==========

``python -m repro_torch.analysis`` enforces the reference's five, with
the same rule ids (``--device cpu`` records the programs on the CPU;
the tier-1 tests run it so, ``chip_smoke.py`` on the card):

``no-materialization``
    The ``cuda`` backend's kernels read the arena block by block and
    never build the ``(B, T*block_len)`` logical view; the ``gather``
    backend keeps it, as the reference's XLA path does (the oracle).
    Checked on the recorded tick programs of every cache family: no
    view-sized gather, flattening reshape or copy of an arena operand
    on ``cuda``, one on ``gather``.
``precision``
    Softmax statistics, scale math and accumulation in the attention
    and ``qmatmul`` programs stay fp32; bf16, fp16, fp8 and int8 are
    storage and matmul-input types only. Checked on the recorded
    programs: no half-precision ``exp``/``amax``/``sum``/softmax, no
    low-precision matmul output, no fp32 -> bf16 downcast reaching
    either on a quantized path.
``compat``
    The version-dependent torch surfaces (the DTensor API, the private
    fake-tensor module) are used only through ``repro_torch/compat.py``.
``host-sync``
    The tick path's deliberate device-to-host reads (the tick's token
    readback, the CTC merge's) carry a ``# sync: <reason>`` comment in
    ``engine.py`` and ``runner.py``, as the reference's do.
``trace-stability``
    A tick plan is captured once, at ``warmup()``; a warmed plan staged
    and captured again is a retrace, as a recompile is in the
    reference. The port's other compile is a kernel library's build and
    load at its first launch. After ``warmup()``, ticking the same
    bucket again loads nothing, captures nothing and launches the same
    kernels on the same routes, and every schedulable tick shape has a
    registered plan.
"""
from repro_torch.serving.cache import CachePool
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.runner import (BasecallerRunner, EncoderPrefixRunner,
                                        ModelRunner, TokenRunner, make_runner,
                                        register_runner)
from repro_torch.serving.sampling import GREEDY, SamplingParams
from repro_torch.serving.stream import ReadUntil, StreamingRequest

__all__ = ["CachePool", "Request", "ServingEngine", "ServingMetrics",
           "SamplingParams", "GREEDY", "ModelRunner", "TokenRunner",
           "EncoderPrefixRunner", "BasecallerRunner", "make_runner",
           "register_runner", "StreamingRequest", "ReadUntil"]
