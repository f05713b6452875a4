"""The ssm and hybrid families through the port's serving engine and
static path, against the JAX package's.

Configs: ``mamba2-130m-smoke`` (ssm), ``hymba-1.5b-smoke`` (hybrid; at
2 layers every layer is ``hybrid_full``) and two 4-layer cuts of it
whose plan is ``hybrid_full, hybrid_swa, hybrid_full, hybrid_full``:
``SWA`` keeps the smoke window of 32, so a 40-token prompt wraps its
ring; ``RING`` narrows the window to 8, so the engine's short requests
wrap theirs. Weights come from the JAX init, bridged through numpy;
inputs from a numpy seed; the JAX engine runs on the CPU with its
``xla`` attention, as its own tests run it.

Tolerances are the reference tests' own: greedy tokens, schedules,
statuses and integer cache leaves exact; logits and float cache
leaves 1e-5 in fp32 (only the order of fp32 sums differs).

- One ``decode_step_slots`` per tick shape (C = 16 with pad rows and
  fresh rows, then C = 1): logits and every cache leaf (``h``,
  ``conv``, ``pos``, the KV arena and its positions) equal the JAX
  step's; a pad step leaves the SSM state as it was; a recycled row's
  ``h``/``conv`` are zero.
- The engine on the reference's cross-arch requests (block recycling,
  preemption, ring wraps), both attention backends, an int8 and an fp8
  arena (SSM state bf16 there); the sampled-decode contract.
- hymba's static path: prefill logits and caches at S = 40 (the ring of
  32 wraps) and 33, greedy tokens; the training loss and gradients.
- The pool's bytes, by class, against the reference pool's leaves.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.config import get_config as jget_config
from repro.models import api as japi
from repro.models.lm import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving.cache import CachePool as JCachePool
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models.lm import transformer as tfm
from repro_torch.serving.cache import CachePool
from repro_torch.serving.engine import Request
from repro_torch.serving.sampling import SamplingParams
from test_torch_training import _jflat, _tflat

MAMBA, HYMBA = "mamba2-130m-smoke", "hymba-1.5b-smoke"
CUTS = {"SWA": dict(n_layers=4), "RING": dict(n_layers=4, sliding_window=8)}
# the reference's cross-arch requests (tests/test_serving_paged.py)
SPEC = [(5, 6), (11, 3), (16, 8), (7, 1), (9, 5)]
ENGINE = dict(n_slots=2, cache_len=48, prefill_chunk=4, block_len=4,
              n_blocks=8)


def _cfgs(name):
    arch = HYMBA if name in CUTS else name
    jcfg, tcfg = jget_config(arch), get_config(arch)
    cut = CUTS.get(name, {})
    return dataclasses.replace(jcfg, **cut), dataclasses.replace(tcfg, **cut)


@functools.lru_cache(maxsize=None)
def models(name):
    """(jax cfg, port cfg, jax params, port params), fp32."""
    jcfg, tcfg = _cfgs(name)
    jp = japi.init_params(jax.random.key(0), jcfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _same_caches(got, want, tol=1e-5):
    """Every leaf: the same paths, shapes and dtypes; integers exact."""
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype)[6:] == str(w.dtype), path
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
        else:
            _close(g.float(), w.astype(np.float32), tol)


def test_layer_plans_configs_and_bridged_trees():
    """The hybrid layer plan, hymba's config field for field, the cuts'
    plans, and the bridged parameter trees: the port's init holds the
    reference's leaves and shapes, which ``from_numpy_tree`` carries
    across unchanged."""
    for arch in ("hymba-1.5b", HYMBA, "mamba2-130m"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))
        assert tfm.layer_plan(get_config(arch)) == \
            jtfm.layer_plan(jget_config(arch))
    assert tfm.layer_plan(get_config("hymba-1.5b")) == [
        ("hybrid_full", 1), ("hybrid_swa", 15), ("hybrid_full", 1),
        ("hybrid_swa", 14), ("hybrid_full", 1)]
    for name in ("SWA", "RING", HYMBA):
        jcfg, tcfg, jp, tp = models(name)
        assert tfm.layer_plan(tcfg) == jtfm.layer_plan(jcfg)
        want = {k: v.shape for k, v in _jflat(jp).items()}
        assert {k: tuple(v.shape) for k, v in _tflat(tp).items()} == want
        drawn = api.init_params(torch.Generator().manual_seed(0), tcfg,
                                device="cpu", dtype=torch.float32)
        assert {k: tuple(v.shape) for k, v in _tflat(drawn).items()} == want
    assert tfm.supports_slot_serving(get_config(MAMBA))
    for family in ("vlm", "audio"):
        assert tfm.layer_plan(dataclasses.replace(
            get_config(HYMBA), family=family)) == jtfm.layer_plan(
                dataclasses.replace(jget_config(HYMBA), family=family))
    with pytest.raises(NotImplementedError, match="speech"):
        tfm.layer_plan(dataclasses.replace(get_config(HYMBA),
                                           family="speech"))


# ------------------------------------------------------- one slot step


def _ticks(rs, vocab):
    """A C = 16 tick (row 0 prefills 16 positions, row 1 ten and six
    pads, both fresh), a C = 16 tick that recycles row 1 (fresh again)
    beside row 0's decode token padded to 16, then C = 1."""
    t0 = [list(range(16)), list(range(10)) + [-1] * 6]
    t1 = [[16] + [-1] * 15, list(range(16))]
    return [(rs.randint(1, vocab, (2, 16)), t0, [1, 1], [15, 9]),
            (rs.randint(1, vocab, (2, 16)), t1, [0, 1], [0, 15]),
            (rs.randint(1, vocab, (2, 1)), [[17], [16]], None, None)]


def _ssm_state(caches):
    return {path: leaf.clone() for path, leaf in _leaves(caches)
            if path[-1] in ("h", "conv")}


@functools.lru_cache(maxsize=None)
def jax_steps(name):
    """The JAX pool (cache_len 32, blocks of 4, rows backed to 18
    positions) through :func:`_ticks`: per tick (inputs, the caches
    after the masking of fresh rows, logits, the caches after the
    step), and the block tables."""
    jcfg, _, jp, _ = models(name)
    jpool = JCachePool(jcfg, 2, 32, jnp.float32, block_len=4,
                       attn_backend="xla")
    for slot in (0, 1):
        assert jpool.alloc(slot, 18)
    out = []
    for tok, t, fresh, last in _ticks(np.random.RandomState(0),
                                      jcfg.vocab_size):
        tok, t = np.asarray(tok, np.int32), np.asarray(t, np.int32)
        jc = jpool.caches
        if fresh is not None:
            fresh = np.asarray(fresh, np.int32)
            jc = JCachePool.mask_fresh_rows(jc, jnp.asarray(fresh),
                                            jpool.reset_spec)
        logits, jpool.caches = jtfm.decode_step_slots(
            jp, jc, jnp.asarray(tok), jnp.asarray(t), jcfg,
            logits_at=None if last is None else jnp.asarray(last, jnp.int32),
            tables=jpool.device_tables(), attn_backend="xla")
        out.append(((tok, t, fresh, last), jc, logits, jpool.caches))
    return out, jpool.tables, jpool.layout


@pytest.mark.parametrize("backend", ["cuda", "gather"])
@pytest.mark.parametrize("name", [MAMBA, "RING"])
def test_slot_step_matches_the_reference(name, backend):
    """Per tick shape, the port's step and the JAX step on the same pool
    state: logits and every cache leaf within 1e-5 (integers exact).
    After the masking of fresh rows, a recycled row's SSM state is zero
    and every other row's is unchanged; a tick whose steps are all pads
    changes nothing."""
    _, tcfg, _, tp = models(name)
    steps, tables, layout = jax_steps(name)
    pool = CachePool(tcfg, 2, 32, torch.float32, block_len=4,
                     attn_backend=backend, device="cpu")
    assert pool.layout == layout
    for slot in (0, 1):
        assert pool.alloc(slot, 18)
    for g in pool.tables:
        np.testing.assert_array_equal(pool.tables[g], tables[g])
    for i, ((tok, t, fresh, last), masked, want, after) in enumerate(steps):
        if fresh is not None:
            before = _ssm_state(pool.caches)
            pool.mask_fresh_rows(pool.caches, torch.from_numpy(fresh))
            for path, leaf in _ssm_state(pool.caches).items():
                for row in (0, 1):
                    keep = (torch.zeros_like(leaf[:, row]) if fresh[row]
                            else before[path][:, row])
                    assert torch.equal(leaf[:, row], keep), (path, row)
            _same_caches(pool.caches, masked)
        got, _ = tfm.decode_step_slots(
            tp, pool.caches, torch.from_numpy(tok), torch.from_numpy(t),
            tcfg, logits_at=None if last is None
            else torch.tensor(last, dtype=torch.int32),
            tables=pool.host_tables(), attn_backend=backend)
        assert got.shape == want.shape == (2, 1, tcfg.vocab_size)
        _close(got, want)
        _same_caches(pool.caches, after)
        if i == 0:
            # an all-pad tick: nothing moves (the warmup's promise)
            state = {p: a.clone() for p, a in _leaves(pool.caches)}
            tfm.decode_step_slots(
                tp, pool.caches, torch.zeros((2, 16), dtype=torch.int32),
                torch.full((2, 16), -1, dtype=torch.int32), tcfg,
                tables=pool.host_tables(), attn_backend=backend)
            for p, a in _leaves(pool.caches):
                assert torch.equal(a, state[p]), p


# ------------------------------------------------------------ the engine


def _jax_serve(jcfg, jp, spec=SPEC, **kw):
    rs = np.random.RandomState(0)
    eng = JServingEngine(jp, jcfg, cache_dtype=jnp.float32,
                         attn_backend="xla", **kw)
    for i, (pl, mn) in enumerate(spec):
        eng.submit(JRequest(
            rid=i, prompt=rs.randint(1, jcfg.vocab_size, size=pl).tolist(),
            sampling=JSamplingParams(max_new_tokens=mn)))
    done = eng.run()
    return {i: (r.status, list(map(int, r.out_tokens)))
            for i, r in done.items()}, eng


def _serve(tcfg, tp, spec=SPEC, sampled=(), **kw):
    rs = np.random.RandomState(0)
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


@functools.lru_cache(maxsize=None)
def jax_tokens(name, quant_policy=None):
    jcfg, _, jp, _ = models(name)
    want, eng = _jax_serve(jcfg, jp, quant_policy=quant_policy, **ENGINE)
    return want, eng.metrics.preempts


@pytest.mark.parametrize("backend", ["cuda", "gather"])
@pytest.mark.parametrize("name", [MAMBA, HYMBA, "RING"])
def test_engine_serves_like_the_reference(name, backend):
    """The reference's cross-arch requests through 2 slots, blocks of 4
    and an 8-block arena: greedy tokens, statuses and preemptions equal
    the JAX engine's (RING: the window-8 layer's ring wraps in every
    request past 8 positions)."""
    _, tcfg, _, tp = models(name)
    want, preempts = jax_tokens(name)
    got, eng = _serve(tcfg, tp, attn_backend=backend, **ENGINE)
    assert got == want
    assert all(s == "finished" for s, _ in got.values())
    assert eng.metrics.preempts == preempts
    s = eng.metrics.summary()
    assert s["requests_done"] == len(SPEC) and s["retraces"] == 0
    if name == MAMBA:
        assert eng.pool.layout == {} and eng.pool.tables == {}
    else:
        assert eng.pool.alloc_count > 0


@pytest.mark.parametrize("mode,state", [("int8", torch.bfloat16),
                                        ("fp8", torch.bfloat16)])
def test_engine_quantized_arena_matches_the_reference(mode, state):
    """int8 and fp8 arenas: tokens equal the JAX engine's; the SSM conv
    state stays bf16 (a 1-byte policy never stores recurrent state) and
    ``h`` fp32."""
    _, tcfg, _, tp = models("RING")
    want, _ = jax_tokens("RING", mode)
    got, eng = _serve(tcfg, tp, attn_backend="cuda", quant_policy=mode,
                      **ENGINE)
    assert got == want
    for g, tree in eng.pool.caches.items():
        assert tree["ssm"]["conv"].dtype == state
        assert tree["ssm"]["h"].dtype == torch.float32
        assert tree["kv"]["k"].dtype == (torch.int8 if mode == "int8"
                                         else torch.float8_e4m3fn)


@pytest.mark.parametrize("name", [MAMBA, "RING"])
def test_sampled_decode_contract(name):
    """Sampled rows give the same tokens across runs, slot placement and
    preemption; greedy rows are the same with and without sampled
    neighbours."""
    _, tcfg, _, tp = models(name)
    spec = [(6, 8), (5, 8), (7, 6), (4, 8)]
    sampled = (1, 3)
    kw = dict(prefill_chunk=4, block_len=4, attn_backend="cuda",
              cache_len=16)
    base, _ = _serve(tcfg, tp, spec, sampled=sampled, n_slots=2, **kw)
    again, _ = _serve(tcfg, tp, spec, sampled=sampled, n_slots=2, **kw)
    assert again == base
    placed, _ = _serve(tcfg, tp, spec, sampled=sampled, n_slots=3, **kw)
    assert placed == base
    if name != MAMBA:               # an SSM pool has no blocks to run dry
        tight, eng = _serve(tcfg, tp, spec, sampled=sampled, n_slots=3,
                            n_blocks=6, **kw)
        assert eng.metrics.preempts > 0
        assert tight == base
    greedy, _ = _serve(tcfg, tp, spec, n_slots=2, **kw)
    for i in range(len(spec)):
        if i not in sampled:
            assert base[i] == greedy[i]
    assert any(base[i] != greedy[i] for i in sampled)


def test_pool_bytes_match_the_reference():
    """A hybrid pool under an int8 policy: ``nbytes`` and each class of
    ``nbytes_by_class`` equal the sums over the reference pool's leaves
    (SSM ``h``/``conv`` count as state, ``kv`` leaves as arena)."""
    jcfg, tcfg, _, _ = models("SWA")
    kw = dict(block_len=4, n_blocks=5, quant_policy="int8")
    jpool = JCachePool(jcfg, 3, 40, **kw)
    pool = CachePool(tcfg, 3, 40, device="cpu", **kw)
    assert pool.layout == jpool.layout
    assert pool.n_blocks == jpool.n_blocks
    assert pool.nbytes() == jpool.nbytes()
    by = pool.nbytes_by_class()
    assert by == jpool.nbytes_by_class()
    assert min(by.values()) > 0 and sum(by.values()) == pool.nbytes()


# ----------------------------------------------------- the static path


@pytest.mark.parametrize("S", [40, 33])
def test_hymba_prefill_logits_and_caches_match_jax(S):
    """S = 40 wraps the window-32 layer's ring (its cache keeps the last
    32 positions at position % 32); S = 33 divides neither the chunk
    of 32 nor the query chunk."""
    jcfg, tcfg, jp, tp = models("SWA")
    tok = np.random.RandomState(S).randint(1, 256, (2, S)).astype(np.int32)
    jl, jc = jtfm.prefill(jp, jnp.asarray(tok), jcfg, cache_len=48,
                          cache_dtype=jnp.float32)
    tl, tc = tfm.prefill(tp, torch.from_numpy(tok), tcfg, cache_len=48,
                         cache_dtype=torch.float32)
    assert tuple(tl.shape) == jl.shape == (2, 1, tcfg.vocab_size)
    _close(tl, jl)
    _same_caches(tc, jc)
    swa = tc["g1_hybrid_swa"]["kv"]
    assert swa["k"].shape[2] == 32 and int(swa["window"][0]) == 32
    assert int(swa["pos"].max()) == S - 1
    jh, _ = jtfm.forward(jp, jnp.asarray(tok), jcfg)
    th, _ = tfm.forward(tp, torch.from_numpy(tok), tcfg)
    _close(th, jh)


def test_hymba_static_greedy_tokens_match_jax():
    """The reference launcher's static loop (bf16 KV cache of prompt +
    tokens positions) and ``serve.static_generate``: identical greedy
    tokens, the window-32 ring wrapping during the decode; no kernel
    launches on the CPU."""
    jcfg, tcfg, jp, tp = models("SWA")
    P, n_new = 28, 12
    tok = np.random.RandomState(1).randint(1, 256, (2, P)).astype(np.int32)
    logits, caches = jtfm.prefill(jp, jnp.asarray(tok), jcfg,
                                  cache_len=P + n_new)
    step = jax.jit(lambda p, c, t, i: jtfm.decode_step(p, c, t, i, jcfg))
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [cur]
    for i in range(n_new - 1):
        logits, caches = step(jp, caches, cur, jnp.asarray(P + i, jnp.int32))
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(cur)
    want = np.concatenate([np.asarray(w) for w in want], axis=1)
    ops.reset_launch_counts()
    r = serve.static_generate(tp, tcfg, torch.from_numpy(tok), n_new)
    np.testing.assert_array_equal(r["tokens"].numpy(), want)
    assert r["launches_prefill"] == {} and r["launches_decode"] == {}
    _same_caches(r["caches"], caches, tol=2e-2)


def test_hymba_training_loss_and_grads_match_jax():
    """The hybrid training forward (windowed ``blockwise_attn`` beside
    the chunked SSD, their mean): the loss within 1e-5 relative and
    every gradient leaf within 1e-5 of the tree's largest, as
    ``tests/test_torch_lm_training.py`` holds the other families."""
    jcfg, tcfg, jp, tp = models("SWA")
    rs = np.random.RandomState(1)
    b = {k: rs.randint(0, tcfg.vocab_size, (2, 48)).astype(np.int32)
         for k in ("tokens", "labels")}
    (wl, _), wg = jax.jit(jax.value_and_grad(
        japi.make_loss_fn(jcfg), has_aux=True))(
            jp, {}, {k: jnp.asarray(v) for k, v in b.items()})
    (tl, (tm, _)), tg = api.value_and_grad(
        api.make_loss_fn(tcfg), tp, {},
        {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(tl) == pytest.approx(float(wl), rel=1e-5)
    assert set(tm) == {"ce"}
    got, want = _tflat(tg), _jflat(wg)
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    mixers = [k for k in want if "/attn/" in k or "/ssm/" in k]
    assert mixers and all(np.abs(got[k]).max() > 0 for k in mixers)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m"])
def test_serve_cli_serves_through_the_engine_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                "3", "--prompt-len", "10", "--tokens", "5",
                "--prefill-chunk", "4", "--block-len", "4", "--wbits", "8"])
    out = capsys.readouterr().out
    assert "TokenRunner" in out and "done: 3 requests" in out


def test_reference_ring_chunk_loses_the_window_edge():
    """Recorded, shared by both packages: a prefill chunk of C > 1
    tokens on a sliding-window group writes all C tokens into the ring
    before it attends, so token c + j (j >= 1) overwrites a key that the
    chunk's query c still needs (the window's oldest position). At C = 1
    the chunked prompt equals the whole-prompt prefill; at C = 4 the
    reference departs from it, and the port departs identically."""
    jcfg, tcfg, jp, tp = models("RING")
    P = 12
    prompt = np.random.RandomState(3).randint(1, 256, (1, P)).astype(
        np.int32)
    whole, _ = jtfm.prefill(jp, jnp.asarray(prompt), jcfg, cache_len=32,
                            cache_dtype=jnp.float32)
    whole = np.asarray(whole[0, 0])
    step = jax.jit(lambda p, c, tok, t, at, tb: jtfm.decode_step_slots(
        p, c, tok, t, jcfg, logits_at=at, tables=tb, attn_backend="xla"))
    for C in (1, 4):
        jpool = JCachePool(jcfg, 1, 32, jnp.float32, block_len=4,
                           attn_backend="xla")
        pool = CachePool(tcfg, 1, 32, torch.float32, block_len=4,
                         device="cpu")
        assert jpool.alloc(0, P) and pool.alloc(0, P)
        for c0 in range(0, P, C):
            tok, t = prompt[:, c0:c0 + C], np.arange(c0, c0 + C,
                                                     dtype=np.int32)[None]
            jl, jpool.caches = step(
                jp, jpool.caches, jnp.asarray(tok), jnp.asarray(t),
                jnp.asarray([C - 1], jnp.int32), jpool.device_tables())
            tl, _ = tfm.decode_step_slots(
                tp, pool.caches, torch.from_numpy(tok), torch.from_numpy(t),
                tcfg, logits_at=torch.tensor([C - 1], dtype=torch.int32),
                tables=pool.host_tables(), attn_backend="cuda")
        _close(tl, jl)
        gap = float(np.abs(np.asarray(jl[0, 0]) - whole).max())
        assert (gap < 1e-5) if C == 1 else (gap > 1e-3), (C, gap)
