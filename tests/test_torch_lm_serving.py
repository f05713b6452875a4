"""LM serving parity: the port's dense LM path against the JAX package's.

Weights are ``qwen1.5-4b-smoke`` from the JAX init, packed to int8
(``quantize_tree``, ``min_size=256`` so every projection packs) under
``cfg.quant = QuantPolicy(8, 0)`` so every projection takes the
quantized-matmul route, and bridged through numpy. On the CPU the
port's kernel wrappers run their plain versions, the JAX package its
Pallas kernels in interpret mode (or its XLA reference).

- One ``decode_step_slots`` per tick shape (a mixed C = 4 tick with pad
  rows and freshly recycled rows, then C = 1): logits within 1e-5 in
  fp32 (observed ~2e-7: fp32 summation order only) and 2e-2 in bf16
  (bf16 rounding points differ between XLA and torch; observed ~3e-3).
- The engine: greedy tokens and request statuses identical to the JAX
  engine (``xla`` backend) in fp32, 2 slots, synchronous and async,
  with both attention backends of the port; under an oversubscribed
  arena that forces preemption; with an int8 arena.
- Sampled decode holds the reference's contract: the same tokens
  across runs, slot placement and preemption; greedy rows unchanged by
  sampled neighbours.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QuantPolicy as JQuantPolicy
from repro.config import get_config as jget_config
from repro.core.quant.policy import quantize_tree as jquantize_tree
from repro.models import api as japi
from repro.models.lm import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving.cache import CachePool as JCachePool
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch import bridge
from repro_torch.config import QuantPolicy, get_config
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.models.lm import transformer as tfm
from repro_torch.serving.cache import CachePool
from repro_torch.serving.engine import Request
from repro_torch.serving.sampling import SamplingParams

ARCH = "qwen1.5-4b-smoke"
SPEC = [(6, 10), (10, 7), (3, 5)]          # (prompt length, max new)


@functools.lru_cache(maxsize=None)
def models(dtype="float32", min_size=256):
    """(jax cfg, port cfg, jax params, port params), packed int8 (the
    port's tree is read-only here: the engines copy nothing into it)."""
    q = (8, 0)
    jcfg = dataclasses.replace(jget_config(ARCH), dtype=dtype,
                               quant=JQuantPolicy(*q))
    tcfg = dataclasses.replace(get_config(ARCH), dtype=dtype,
                               quant=QuantPolicy(*q))
    jp = jquantize_tree(japi.init_params(jax.random.key(0), jcfg),
                        JQuantPolicy(*q), min_size=min_size)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def fp32_models():
    return models()


# ------------------------------------------------------- one step per tick


def _ticks(rs):
    """A mixed C = 4 tick (row 0 prefills 4, row 1 3 + a pad, both
    fresh), a mixed tick that recycles row 1 (fresh again over its stale
    positions) beside row 0's decode token padded to 4, then C = 1."""
    return [
        (rs.randint(1, 256, (2, 4)), [[0, 1, 2, 3], [0, 1, 2, -1]],
         [1, 1], [3, 2]),
        (rs.randint(1, 256, (2, 4)), [[4, -1, -1, -1], [0, 1, 2, 3]],
         [0, 1], [0, 3]),
        (rs.randint(1, 256, (2, 1)), [[5], [4]], None, None),
    ]


@pytest.mark.parametrize("dtype,min_size,backend,tol", [
    ("float32", 256, "cuda", 1e-5), ("float32", 8192, "gather", 1e-5),
    ("bfloat16", 256, "cuda", 2e-2)])
def test_decode_step_slots_matches_jax(dtype, min_size, backend, tol,
                                       monkeypatch):
    """Per tick shape, logits of the port's step equal the JAX step's on
    the same pool state. ``min_size=8192`` leaves the smoke wk/wv (two
    stacked 64 x 32 layers, 4096 values) unpacked, so they take the
    fake-quant branch beside the qmatmul route of the rest."""
    jcfg, tcfg, jp, tp = models(dtype, min_size)
    calls = []
    real = ops.qmatmul
    monkeypatch.setattr(ops, "qmatmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jpool = JCachePool(jcfg, 2, 16, jdt, block_len=4, attn_backend="xla")
    pool = CachePool(tcfg, 2, 16, tdt, block_len=4, attn_backend=backend)
    for slot in (0, 1):
        assert jpool.alloc(slot, 8) and pool.alloc(slot, 8)
    np.testing.assert_array_equal(pool.tables["g0_dense"],
                                  jpool.tables["g0_dense"])
    for tok, t, fresh, last in _ticks(np.random.RandomState(0)):
        tok, t = np.asarray(tok, np.int32), np.asarray(t, np.int32)
        jc = jpool.caches
        if fresh is not None:
            fresh = np.asarray(fresh, np.int32)
            jc = JCachePool.mask_fresh_rows(jc, jnp.asarray(fresh),
                                            jpool.reset_spec)
            pool.mask_fresh_rows(pool.caches, torch.from_numpy(fresh))
        jat = None if last is None else jnp.asarray(last, jnp.int32)
        tat = None if last is None else torch.tensor(last, dtype=torch.int32)
        want, jpool.caches = jtfm.decode_step_slots(
            jp, jc, jnp.asarray(tok), jnp.asarray(t), jcfg, logits_at=jat,
            tables=jpool.device_tables(), attn_backend="xla")
        calls.clear()
        got, _ = tfm.decode_step_slots(
            tp, pool.caches, torch.from_numpy(tok), torch.from_numpy(t),
            tcfg, logits_at=tat, tables=pool.host_tables(),
            attn_backend=backend)
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape == (2, 1, 256)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)
        # every projection of both layers plus lm_head takes qmatmul;
        # at min_size 8192 the wk/wv stacks stay unpacked
        assert len(calls) == (2 * 7 + 1 if min_size == 256 else 2 * 5 + 1)


# ------------------------------------------------------------ the engine


def _jax_serve(jcfg, jp, spec=SPEC, seed=0, **kw):
    rs = np.random.RandomState(seed)
    eng = JServingEngine(jp, jcfg, cache_dtype=jnp.float32,
                         attn_backend="xla", **kw)
    for i, (pl, mn) in enumerate(spec):
        eng.submit(JRequest(
            rid=i, prompt=rs.randint(1, jcfg.vocab_size, size=pl).tolist(),
            sampling=JSamplingParams(max_new_tokens=mn)))
    done = eng.run()
    return {i: (r.status, list(map(int, r.out_tokens)))
            for i, r in done.items()}, eng


def _serve(tcfg, tp, spec=SPEC, seed=0, sampled=(), **kw):
    rs = np.random.RandomState(seed)
    kw.setdefault("cache_dtype", torch.float32)
    eng = api.make_serving_engine(tp, tcfg, device="cpu", **kw)
    for i, (pl, mn) in enumerate(spec):
        sp = (SamplingParams(max_new_tokens=mn, temperature=0.8, top_k=50,
                             top_p=0.9, seed=7 + i) if i in sampled
              else SamplingParams(max_new_tokens=mn))
        eng.submit(Request(
            rid=i, prompt=rs.randint(1, tcfg.vocab_size, size=pl).tolist(),
            sampling=sp))
    done = eng.run()
    return {i: (r.status, list(map(int, r.out_tokens)))
            for i, r in done.items()}, eng


ENGINE = dict(n_slots=2, cache_len=32, prefill_chunk=4, block_len=4)


@pytest.fixture(scope="module")
def jax_tokens(fp32_models):
    jcfg, _, jp, _ = fp32_models
    return _jax_serve(jcfg, jp, **ENGINE)[0]


@pytest.mark.parametrize("async_dispatch", [False, True])
@pytest.mark.parametrize("backend", ["cuda", "gather"])
def test_engine_serves_like_the_reference(fp32_models, jax_tokens,
                                          backend, async_dispatch):
    _, tcfg, _, tp = fp32_models
    got, eng = _serve(tcfg, tp, attn_backend=backend,
                      async_dispatch=async_dispatch, **ENGINE)
    assert got == jax_tokens
    assert all(s == "finished" for s, _ in got.values())
    assert eng.runner.attn_backend == backend
    s = eng.metrics.summary()
    assert s["requests_done"] == len(SPEC) and s["retraces"] == 0


def test_engine_preemption_matches_the_reference(fp32_models):
    """An oversubscribed arena (5 blocks of 4 for 2 slots of 16): blocks
    recycle, the youngest request is preempted and re-prefilled, and the
    tokens still equal the reference engine's."""
    jcfg, tcfg, jp, tp = fp32_models
    spec = [(6, 8), (6, 8), (5, 4)]
    kw = dict(n_slots=2, cache_len=16, prefill_chunk=4, block_len=4,
              n_blocks=5)
    want, jeng = _jax_serve(jcfg, jp, spec, **kw)
    got, eng = _serve(tcfg, tp, spec, attn_backend="cuda", **kw)
    assert got == want
    assert eng.metrics.preempts == jeng.metrics.preempts > 0
    assert eng.pool.alloc_count > 5


def test_engine_int8_arena_matches_the_reference(fp32_models):
    jcfg, tcfg, jp, tp = fp32_models
    want, _ = _jax_serve(jcfg, jp, quant_policy="int8", **ENGINE)
    got, eng = _serve(tcfg, tp, attn_backend="cuda", quant_policy="int8",
                      **ENGINE)
    assert got == want
    by = eng.pool.nbytes_by_class()
    assert eng.pool.caches["g0_dense"]["k"].dtype == torch.int8
    assert by["scales"] > 0 and sum(by.values()) == eng.pool.nbytes()


# ------------------------------------------------- the sampled contract


def test_sampled_decode_contract(fp32_models):
    """Sampled rows give the same tokens across runs, slot placement
    (another slot count) and preemption (a tight arena); greedy rows
    are the same with and without sampled neighbours."""
    _, tcfg, _, tp = fp32_models
    spec = [(6, 8), (5, 8), (7, 6), (4, 8)]
    sampled = (1, 3)
    kw = dict(prefill_chunk=4, block_len=4, attn_backend="cuda")
    base, _ = _serve(tcfg, tp, spec, sampled=sampled, n_slots=2,
                     cache_len=16, **kw)
    again, _ = _serve(tcfg, tp, spec, sampled=sampled, n_slots=2,
                      cache_len=16, **kw)
    assert again == base
    placed, _ = _serve(tcfg, tp, spec, sampled=sampled, n_slots=3,
                       cache_len=16, **kw)
    assert placed == base
    tight, eng = _serve(tcfg, tp, spec, sampled=sampled, n_slots=3,
                        cache_len=16, n_blocks=6, **kw)
    assert eng.metrics.preempts > 0
    assert tight == base
    greedy, _ = _serve(tcfg, tp, spec, n_slots=2, cache_len=16, **kw)
    for i in range(len(spec)):
        if i not in sampled:
            assert base[i] == greedy[i]
    assert any(base[i] != greedy[i] for i in sampled)
