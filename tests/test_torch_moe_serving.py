"""Serving parity of the moe family: the port's deepseek (MLA + MoE) and
granite-moe (GQA + MoE) paths against the JAX package's.

Weights are the JAX init of the ``-smoke`` configs (deepseek: one
``mla_dense`` and one ``mla_moe`` layer; granite: two ``moe`` layers),
packed to int8 (``quantize_tree``, ``min_size=256``) under
``cfg.quant = QuantPolicy(8, 0)`` so the projections, the router and the
shared expert take the quantized-matmul route, and bridged through
numpy. On the CPU the port's kernel wrappers run their plain versions,
the JAX package its Pallas kernels in interpret mode or its XLA
reference.

- One ``decode_step_slots`` per tick shape (a mixed C = 4 tick with a
  pad token and freshly recycled rows, then C = 1): logits within 1e-5
  in fp32 (fp32 summation order only) and 2e-2 in bf16, with the
  quantized-matmul launches counted per tick.
- The engine, deepseek: greedy tokens and request statuses identical to
  the JAX engine in fp32, 2 slots, synchronous and async through the
  latent kernels' plain versions, through the gather reference, under
  an oversubscribed arena that forces preemption, and with an int8
  latent arena. Granite: identical greedy tokens.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.config import QuantPolicy as JQuantPolicy
from repro.config import get_config as jget_config
from repro.core.quant.policy import quantize_tree as jquantize_tree
from repro.models import api as japi
from repro.models.lm import transformer as jtfm
from repro.serving.cache import CachePool as JCachePool
from repro_torch import bridge
from repro_torch.config import QuantPolicy, get_config
from repro_torch.kernels import ops
from repro_torch.models.lm import transformer as tfm
from repro_torch.serving.cache import CachePool
from test_torch_lm_serving import ENGINE, _jax_serve, _serve, _ticks

DEEPSEEK = "deepseek-v3-671b-smoke"
GRANITE = "granite-moe-1b-a400m-smoke"


@functools.lru_cache(maxsize=None)
def models(arch, dtype="float32"):
    """(jax cfg, port cfg, jax params, port params), packed int8."""
    q = (8, 0)
    jcfg = dataclasses.replace(jget_config(arch), dtype=dtype,
                               quant=JQuantPolicy(*q))
    tcfg = dataclasses.replace(get_config(arch), dtype=dtype,
                               quant=QuantPolicy(*q))
    jp = jquantize_tree(japi.init_params(jax.random.key(0), jcfg),
                        JQuantPolicy(*q), min_size=256)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


# qmatmul launches of one deepseek-smoke tick: wdq, wuq, wdkv, wo per MLA
# layer; wi, wg, wo of the dense layer's MLP; the router and the shared
# expert's three of the MoE layer; lm_head (wukv is dequantized, the
# routed experts run dequantized rows)
QMM_PER_TICK = 4 + 3 + 4 + 1 + 3 + 1


@pytest.mark.parametrize("dtype,backend,cache,tol", [
    ("float32", "cuda", "fp32", 1e-5), ("float32", "gather", "int8", 1e-5),
    ("bfloat16", "cuda", "bf16", 2e-2)])
def test_decode_step_slots_matches_jax(dtype, backend, cache, tol,
                                       monkeypatch):
    """Per tick shape, deepseek-smoke logits of the port's step equal the
    JAX step's on the same pool state (fp32, int8 or bf16 latents)."""
    jcfg, tcfg, jp, tp = models(DEEPSEEK, dtype)
    calls = []
    real = ops.qmatmul
    monkeypatch.setattr(ops, "qmatmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jpool = JCachePool(jcfg, 2, 16, jnp.dtype(dtype), block_len=4,
                       attn_backend="xla", quant_policy=cache)
    pool = CachePool(tcfg, 2, 16, getattr(torch, dtype), block_len=4,
                     attn_backend=backend, quant_policy=cache, device="cpu")
    for slot in (0, 1):
        assert jpool.alloc(slot, 8) and pool.alloc(slot, 8)
    assert sorted(pool.tables) == ["g0_mla_dense", "g1_mla_moe"]
    for g in pool.tables:
        np.testing.assert_array_equal(pool.tables[g], jpool.tables[g])
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
        assert len(calls) == QMM_PER_TICK
    by = pool.nbytes_by_class()
    assert sum(by.values()) == pool.nbytes() and by["state"] == 0
    assert by["arena"] > 0 and (by["scales"] > 0) == (cache == "int8")


@pytest.fixture(scope="module")
def jax_tokens():
    jcfg, _, jp, _ = models(DEEPSEEK)
    return _jax_serve(jcfg, jp, **ENGINE)[0]


@pytest.mark.parametrize("backend,async_dispatch", [
    ("cuda", False), ("cuda", True), ("gather", False)])
def test_engine_serves_like_the_reference(jax_tokens, backend,
                                          async_dispatch):
    _, tcfg, _, tp = models(DEEPSEEK)
    got, eng = _serve(tcfg, tp, attn_backend=backend,
                      async_dispatch=async_dispatch, **ENGINE)
    assert got == jax_tokens
    assert all(s == "finished" for s, _ in got.values())
    s = eng.metrics.summary()
    assert s["requests_done"] == 3 and s["retraces"] == 0


def test_engine_preemption_matches_the_reference():
    """An oversubscribed latent arena (5 blocks of 4 for 2 slots of 16):
    blocks recycle, the youngest request is preempted and re-prefilled,
    and the tokens still equal the reference engine's."""
    jcfg, tcfg, jp, tp = models(DEEPSEEK)
    spec = [(6, 8), (6, 8), (5, 4)]
    kw = dict(n_slots=2, cache_len=16, prefill_chunk=4, block_len=4,
              n_blocks=5)
    want, jeng = _jax_serve(jcfg, jp, spec, **kw)
    got, eng = _serve(tcfg, tp, spec, attn_backend="cuda", **kw)
    assert got == want
    assert eng.metrics.preempts == jeng.metrics.preempts > 0
    assert eng.pool.alloc_count > 5


def test_engine_int8_latent_arena_matches_the_reference():
    jcfg, tcfg, jp, tp = models(DEEPSEEK)
    want, _ = _jax_serve(jcfg, jp, quant_policy="int8", **ENGINE)
    got, eng = _serve(tcfg, tp, attn_backend="cuda", quant_policy="int8",
                      **ENGINE)
    assert got == want
    leaves = eng.pool.caches["g1_mla_moe"]
    assert leaves["c"].dtype == torch.int8 and "kr_scale" in leaves


def test_granite_engine_serves_like_the_reference():
    jcfg, tcfg, jp, tp = models(GRANITE)
    want, _ = _jax_serve(jcfg, jp, **ENGINE)
    got, _ = _serve(tcfg, tp, attn_backend="cuda", **ENGINE)
    assert got == want
    assert all(s == "finished" for s, _ in got.values())
