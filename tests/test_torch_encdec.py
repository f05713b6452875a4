"""The audio family (whisper-tiny-smoke: 2 xdec layers over 2 encoder
layers, 8 stub frames) in the port against the JAX package: the
encoder, cross-attention on both of its branches, the whole-sequence
forward, prefill + decode, the slot step with the per-slot encoder
buffer, the loss, its gradients and one train step, and Whisper through
the port's serving engine (``EncoderPrefixRunner``). Also the pieces
that came with it: ``common.layernorm``, the ungated GELU MLP and the
contiguous layout of ``ops.decode_gqa``.

The JAX init is bridged through numpy; fp32 throughout. On the CPU the
port's kernel wrappers run their plain versions; the JAX package runs
its XLA paths, or its Pallas kernels in interpret mode where a test
asks for its ``pallas`` backend.

Tolerances: values 1e-5 (both sides fp32; only the order of fp32 sums
differs, as in ``tests/test_torch_lm_serving.py`` and
``tests/test_torch_static.py``); the loss 1e-5 relative and each
gradient leaf within 1e-5 of the tree's largest, as in
``tests/test_torch_lm_training.py``; one train step within the bounds
of ``tests/test_torch_training.py``. Tokens exact.
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
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models.lm import common as jcommon
from repro.models.lm import encdec as jencdec
from repro.models.lm import transformer as jtfm
from repro.serving.cache import CachePool as JCachePool
from repro.training import optimizer as jopt
from repro_torch.config import get_config
from repro_torch.core.quant.policy import (tree_items, tree_leaves,
                                            tree_map, tree_unflatten)
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import api
from repro_torch.models.lm import attention as attn_mod
from repro_torch.models.lm import common, encdec
from repro_torch.models.lm import transformer as tfm
from repro_torch.serving.cache import CachePool
from repro_torch.serving.engine import Request
from repro_torch.serving.runner import make_runner, runner_name_for
from repro_torch.serving.sampling import SamplingParams
from repro_torch.training import optimizer as opt
from test_torch_cuda import ATTN_TOL
from test_torch_training import _close_grads, _j, _jflat, _np, _t, _tflat

ARCH = "whisper-tiny-smoke"
CACHE_LEN = 48


@functools.lru_cache(maxsize=None)
def models():
    """(jax cfg, port cfg, jax params, port params), fp32."""
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    jp = japi.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, _t(_np(jp))


def _frames(cfg, B, seed=0):
    return np.random.RandomState(seed).randn(
        B, cfg.frontend_tokens, cfg.d_model).astype(np.float32)


def _tokens(B, S, seed=1):
    return np.random.RandomState(seed).randint(1, 256, (B, S)).astype(
        np.int32)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# Building blocks


@pytest.mark.parametrize("n,d", [(8, 64), (1500, 384), (7, 10)])
def test_sinusoidal_matches_reference(n, d):
    _close(encdec.sinusoidal(n, d), jencdec.sinusoidal(n, d), 1e-5)


def test_layernorm_and_ungated_gelu_mlp_match_reference():
    """``layernorm`` (not used by any model, ported with the module) and
    the ungated MLP under both activations: GELU is the tanh form that
    ``jax.nn.gelu`` computes by default."""
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 32).astype(np.float32) * 3 + 1
    lp = {"scale": rs.rand(32).astype(np.float32) + 0.5,
          "bias": rs.randn(32).astype(np.float32)}
    _close(common.layernorm(_t(lp), torch.from_numpy(x)),
           jcommon.layernorm(_j(lp), jnp.asarray(x)))
    assert set(common.make_layernorm_params(32)) == {"scale", "bias"}
    _, tcfg, _, _ = models()
    jcfg = jget_config(ARCH)
    mp = _np(jcommon.make_mlp_params(jax.random.key(1), 32, 48,
                                     gated=False))
    assert set(mp) == {"wi", "wo"}
    gen = torch.Generator().manual_seed(0)
    assert set(common.make_mlp_params(gen, 32, 48, gated=False)) == \
        {"wi", "wo"}
    for act in ("gelu", "silu"):
        _close(common.mlp(_t(mp), torch.from_numpy(x), cfg=tcfg, act=act),
               jcommon.mlp(_j(mp), jnp.asarray(x), cfg=jcfg, act=act))


def test_init_tree_matches_reference_layout():
    """The whole tree's key paths and shapes, ``encoder`` included, at
    smoke and at full width (shapes only, without drawing)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    for arch in (ARCH, "whisper-tiny", "internvl2-1b-smoke",
                 "internvl2-1b"):
        shapes = jax.eval_shape(lambda a=arch: japi.init_params(
            jax.random.key(0), jget_config(a)))
        want = {"/".join(str(k.key) for k in path): leaf.shape
                for path, leaf in
                jax.tree_util.tree_flatten_with_path(shapes)[0]}
        with FakeTensorMode():
            got = api.init_params(torch.Generator().manual_seed(0),
                                  get_config(arch), device="cpu")
        assert {k: tuple(v.shape) for k, v in tree_items(got)} == want, arch
    assert "encoder/blocks/ffn/wi/kernel" in dict(tree_items(models()[3]))


def test_encode_matches_reference():
    """The encoder's inference path (flash's plain version, not causal)
    and its training path (``blockwise_attn``) against the reference's
    ``encode``."""
    jcfg, tcfg, jp, tp = models()
    fr = _frames(tcfg, 2)
    want = jencdec.encode(jp["encoder"], jnp.asarray(fr), jcfg)
    for train in (False, True):
        got = encdec.encode(tp["encoder"], torch.from_numpy(fr), tcfg,
                            train=train)
        assert got.shape == want.shape
        _close(got, want)


def test_training_encoder_at_full_frame_count_matches_reference():
    """The training encoder over Whisper's 1500 frames (smoke widths):
    ``blockwise_attn``, not causal, in 3 query chunks of 500 against 2
    KV chunks of 750, against the reference's ``encode`` and the port's
    dense path (flash's plain version); the gradient of every encoder
    leaf against ``jax.grad`` of the reference, within 1e-5 of the
    tree's largest."""
    jcfg, tcfg, jp, tp = models()
    F_ = 1500
    jcfg, tcfg = (dataclasses.replace(c, frontend_tokens=F_)
                  for c in (jcfg, tcfg))
    assert (F_ // attn_mod._chunk(F_, 512), F_ // attn_mod._chunk(F_, 1024)) \
        == (3, 2)
    fr = _frames(tcfg, 1)
    w = np.random.RandomState(2).randn(*fr.shape).astype(np.float32)
    jg = jax.grad(lambda p: (jencdec.encode(p, jnp.asarray(fr), jcfg)
                             * w).sum())(jp["encoder"])
    want = jencdec.encode(jp["encoder"], jnp.asarray(fr), jcfg)
    enc = tree_map(lambda a: a.clone().requires_grad_(True), tp["encoder"])
    got = encdec.encode(enc, torch.from_numpy(fr), tcfg, train=True)
    _close(got.detach(), want)
    with torch.no_grad():
        _close(encdec.encode(tp["encoder"], torch.from_numpy(fr), tcfg),
               want)
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                tree_leaves(enc))
    _close_grads(tree_unflatten(enc, grads), jg, 1e-5)


def test_cross_attention_and_enc_kv_match_reference():
    """``enc_kv_for_layer``; ``_cross_attn`` on its einsum branch (a
    chunk of 3 tokens; and S = 1 without a backend) and on its kernel
    branch (S = 1, ``cuda``: the plain version of ``gqa_paged`` over the
    encoder rows) against the reference's XLA and Pallas (interpret)
    branches."""
    jcfg, tcfg, jp, tp = models()
    enc = np.random.RandomState(2).randn(2, 8, tcfg.d_model).astype(
        np.float32)
    jx = _layer(jp["groups"]["g0_xdec"], 0)["xattn"]
    tx = tfm.layer_views(tp["groups"]["g0_xdec"], 2)[0]["xattn"]
    jkv = jtfm.enc_kv_for_layer(jx, jnp.asarray(enc), jcfg)
    tkv = tfm.enc_kv_for_layer(tx, torch.from_numpy(enc), tcfg)
    for k in ("k", "v"):
        _close(tkv[k], jkv[k])
    rs = np.random.RandomState(3)
    for S in (3, 1):
        x = rs.randn(2, S, tcfg.d_model).astype(np.float32)
        want = jtfm._cross_attn(jx, jnp.asarray(x), jkv, jcfg)
        _close(tfm._cross_attn(tx, torch.from_numpy(x), tkv, tcfg), want)
        _close(tfm._cross_attn(tx, torch.from_numpy(x), tkv, tcfg,
                               attn_backend="gather"), want)
    pallas = jtfm._cross_attn(jx, jnp.asarray(x), jkv, jcfg,
                              attn_backend="pallas")
    got = tfm._cross_attn(tx, torch.from_numpy(x), tkv, tcfg,
                          attn_backend="cuda")
    _close(got, pallas)
    _close(got, want)


@pytest.mark.parametrize("Se,B,hd", [(8, 2, 8), (1500, 1, 64), (13, 3, 8),
                                     (257, 2, 128)])
def test_decode_gqa_contiguous_layout(Se, B, hd, monkeypatch):
    """``table=None``: k/v as (B, L, Hkv, hd) rows. The ``gather``
    backend equals the reference's XLA path on the same rows; ``cuda``
    (the kernels' plain versions here) views the rows as blocks of
    ``contiguous_block_len`` and equals it too, C = 1 and a chunk of 3,
    fp32 and a bf16 buffer, with pad rows and positions past ``t``. A
    block fits the CUDA-core kernel's shared memory at the head dim:
    whisper's 1500 frames at hd 64 in blocks of 375; a prime length at
    hd 128 (fp32) padded with masked positions to blocks of 204. The
    view's table is row-major over whole rows; int8 scales without a
    table raise, as in the reference."""
    rs = np.random.RandomState(Se)
    H, Hkv = 6, 6 if Se == 1500 else 2
    bl = ops.contiguous_block_len(Se, hd)
    assert bl <= pa.cuda_core_max_block(hd)
    assert bl == {8: 8, 1500: 375, 13: 13, 257: 204}[Se]
    n = -(-Se // bl)
    seen = []
    real = ops._paged
    monkeypatch.setattr(ops, "_paged", lambda *a, **kw: seen.append(
        (a[1].shape, a[5])) or real(*a, **kw))
    # bf16 rows go to the tensor-core kernel on the card, whose shared
    # memory does not grow with the block: the hd-128 case is fp32's
    cases = ((1, np.float32), (3, np.float32), (1, "bf16"))
    for C, dt in cases[:2] if hd == 128 else cases:
        q = rs.randn(B, C, H, hd).astype(np.float32)
        k = rs.randn(B, Se, Hkv, hd).astype(np.float32)
        v = rs.randn(B, Se, Hkv, hd).astype(np.float32)
        pos = np.broadcast_to(np.arange(Se, dtype=np.int32), (B, Se)).copy()
        t = np.full((B, C), Se, np.int32)
        t[-1, -1] = Se // 2
        if B > 1:
            t[0, 0] = -1
        want = np.asarray(jops.decode_gqa(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jnp.asarray(pos),
                                          jnp.asarray(t), backend="xla"))
        tt = {n: torch.from_numpy(a) for n, a in
              dict(q=q, k=k, v=v, pos=pos, t=t).items()}
        if dt == "bf16":
            tt["k"], tt["v"] = tt["k"].bfloat16(), tt["v"].bfloat16()
            want = np.asarray(jops.decode_gqa(
                jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                jnp.asarray(v, jnp.bfloat16), jnp.asarray(pos),
                jnp.asarray(t), backend="xla"))
        live = (t >= 0)[..., None]
        for backend in ("gather", "cuda"):
            got = ops.decode_gqa(tt["q"], tt["k"], tt["v"], tt["pos"],
                                 tt["t"], backend=backend).numpy()
            # bf16: the walk rounds p to bf16 a block at a time
            tol = ATTN_TOL["bf16" if dt == "bf16" and backend == "cuda"
                           else "fp32"]
            np.testing.assert_allclose(np.where(live, got, 0),
                                       np.where(live, want, 0),
                                       rtol=tol, atol=tol)
    shape, table = seen[0]
    assert tuple(shape) == (B * n, bl, Hkv, hd)
    np.testing.assert_array_equal(table.numpy(),
                                  np.arange(B * n).reshape(B, n))
    with pytest.raises(ValueError, match="paged layout"):
        ops.decode_gqa(tt["q"], tt["k"], tt["v"], tt["pos"], tt["t"],
                       k_scale=torch.ones(B, Se, Hkv))


# ---------------------------------------------------------------------------
# The whole sequence, the static path and the slot step


def test_forward_prefill_and_decode_match_reference():
    """``forward`` with ``enc_out`` (and without it: no cross-attention,
    as the reference), ``prefill`` (logits, the self-attention caches
    and the ``/enc_kv`` entries in the cache dtype) and three
    ``decode_step``s over them, against the reference's."""
    jcfg, tcfg, jp, tp = models()
    fr, tok = _frames(tcfg, 2), _tokens(2, 10)
    jenc = jencdec.encode(jp["encoder"], jnp.asarray(fr), jcfg)
    tenc = encdec.encode(tp["encoder"], torch.from_numpy(fr), tcfg)
    for kw in ({}, {"enc_out": True}):
        jh, _ = jtfm.forward(jp, jnp.asarray(tok), jcfg,
                             **({"enc_out": jenc} if kw else {}))
        th, _ = tfm.forward(tp, torch.from_numpy(tok), tcfg,
                            **({"enc_out": tenc} if kw else {}))
        _close(th, jh)
    jl, jc = jtfm.prefill(jp, jnp.asarray(tok[:, :7]), jcfg, cache_len=16,
                          enc_out=jenc, cache_dtype=jnp.float32)
    tl, tc = tfm.prefill(tp, torch.from_numpy(tok[:, :7]), tcfg,
                         cache_len=16, enc_out=tenc,
                         cache_dtype=torch.float32)
    _close(tl, jl)
    prefill_logits = jl
    assert set(tc) == set(jc) == {"g0_xdec", "g0_xdec/enc_kv"}
    for g in jc:
        for name, want in jc[g].items():
            assert tuple(tc[g][name].shape) == want.shape, (g, name)
            _close(tc[g][name], want)
    for i in range(7, 10):
        jl, jc = jtfm.decode_step(jp, jc, jnp.asarray(tok[:, i:i + 1]),
                                  jnp.asarray(i, jnp.int32), jcfg)
        tl, tc = tfm.decode_step(tp, tc, torch.from_numpy(tok[:, i:i + 1]),
                                 i, tcfg)
        _close(tl, jl)
    # the API's prefill step encodes the batch's frames itself
    sl, _ = api.make_prefill_step(tcfg)(tp, {
        "tokens": torch.from_numpy(tok[:, :7]),
        "frames": torch.from_numpy(fr)})
    _close(sl, prefill_logits)
    # empty caches: the reference's layout (enc_kv of frontend_tokens
    # positions) at full width; the reference sizes the encoder K/V by
    # n_heads where prefill stores n_kv_heads, equal in whisper-tiny
    full_j, full_t = jget_config("whisper-tiny"), get_config("whisper-tiny")
    je, te = jtfm.init_caches(full_j, 2, 20), tfm.init_caches(full_t, 2, 20)
    assert {g: {n: tuple(a.shape) for n, a in c.items()}
            for g, c in te.items()} == \
        {g: {n: a.shape for n, a in c.items()} for g, c in je.items()}
    assert te["g0_xdec/enc_kv"]["k"].shape[-2] == full_t.n_kv_heads


@pytest.mark.parametrize("backend,jbackend", [("gather", "xla"),
                                              ("cuda", "pallas")])
def test_decode_step_slots_with_enc_kv_matches_reference(backend, jbackend):
    """One mixed C = 4 tick (a pad row beside a fresh prefill) and two
    C = 1 ticks over the paged pool and per-slot encoder buffers (a
    different encoding per slot): logits of the port's step equal the
    reference's on the same pool state, ``cuda`` against the
    reference's Pallas kernels in interpret mode."""
    jcfg, tcfg, jp, tp = models()
    fr = _frames(tcfg, 2, seed=4)
    jenc = jencdec.encode(jp["encoder"], jnp.asarray(fr), jcfg)
    jenc_kv = {"g0_xdec": jax.vmap(lambda p1: jtfm.enc_kv_for_layer(
        p1["xattn"], jenc, jcfg))(jp["groups"]["g0_xdec"])}
    tenc = encdec.encode(tp["encoder"], torch.from_numpy(fr), tcfg)
    tenc_kv = {"g0_xdec": {n: torch.stack([
        tfm.enc_kv_for_layer(p["xattn"], tenc, tcfg)[n]
        for p in tfm.layer_views(tp["groups"]["g0_xdec"], 2)])
        for n in ("k", "v")}}
    jpool = JCachePool(jcfg, 2, 16, jnp.float32, block_len=4,
                       attn_backend=jbackend)
    pool = CachePool(tcfg, 2, 16, torch.float32, block_len=4,
                     attn_backend=backend, device="cpu")
    for slot in (0, 1):
        assert jpool.alloc(slot, 8) and pool.alloc(slot, 8)
    rs = np.random.RandomState(5)
    ticks = [(rs.randint(1, 256, (2, 4)), [[0, 1, 2, 3], [-1] * 4],
              [1, 0], [3, 0]),
             (rs.randint(1, 256, (2, 1)), [[4], [-1]], None, None),
             (rs.randint(1, 256, (2, 1)), [[5], [-1]], None, None)]
    for tok, t, fresh, last in ticks:
        tok, t = np.asarray(tok, np.int32), np.asarray(t, np.int32)
        jc = jpool.caches
        if fresh is not None:
            fresh = np.asarray(fresh, np.int32)
            jc = JCachePool.mask_fresh_rows(jc, jnp.asarray(fresh),
                                            jpool.reset_spec)
            pool.mask_fresh_rows(pool.caches, torch.from_numpy(fresh))
        jl, jpool.caches = jtfm.decode_step_slots(
            jp, jc, jnp.asarray(tok), jnp.asarray(t), jcfg,
            logits_at=None if last is None else jnp.asarray(last, jnp.int32),
            tables=jpool.device_tables(), enc_kv=jenc_kv,
            attn_backend=jbackend)
        tl, _ = tfm.decode_step_slots(
            tp, pool.caches, torch.from_numpy(tok), torch.from_numpy(t),
            tcfg, logits_at=None if last is None else torch.tensor(
                last, dtype=torch.int32),
            tables=pool.host_tables(), enc_kv=tenc_kv, attn_backend=backend)
        _close(tl[0], np.asarray(jl)[0])     # row 0 is live every tick


# ---------------------------------------------------------------------------
# Training


def _batch(cfg, B=2, S=12, seed=6):
    rs = np.random.RandomState(seed)
    b = {k: rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
         for k in ("tokens", "labels")}
    b["frames"] = _frames(cfg, B, seed)
    return b


def test_loss_grads_and_train_step_match_reference():
    """The loss (the training encoder's ``blockwise_attn``, the dense
    cross-attention) and every gradient leaf, encoder included; then one
    ``make_train_step`` step: loss 1e-5 relative, grad norm 1e-4, and
    each updated param within 1e-3 of the learning rate (2 lr where the
    gradient is noise), the bounds of ``tests/test_torch_training.py``."""
    jcfg, tcfg, jp, tp = models()
    b = _batch(tcfg)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    (wl, _), wg = jax.jit(jax.value_and_grad(japi.make_loss_fn(jcfg),
                                             has_aux=True))(jp, {}, _j(b))
    (gl, (metrics, _)), gg = api.value_and_grad(api.make_loss_fn(tcfg), tp,
                                                {}, tb)
    assert float(gl) == pytest.approx(float(wl), rel=1e-5)
    assert set(metrics) == {"ce"}
    _close_grads(gg, wg, 1e-5)
    assert np.abs(_tflat(gg)["encoder/blocks/attn/wq/kernel"]).max() > 0
    ocfg = dict(lr=5e-3, total_steps=20, warmup_steps=0)
    jc, tc = jopt.AdamWConfig(**ocfg), opt.AdamWConfig(**ocfg)
    jcarry, jm = jax.jit(japi.make_train_step(jcfg, jc))(
        japi.TrainCarry(jp, jopt.init_opt_state(jp, jc), {}), _j(b))
    tcarry, tm = api.make_train_step(tcfg, tc)(
        api.TrainCarry(tp, opt.init_opt_state(tp, tc), {}), tb)
    for k, rel in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6)):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rel)
    m = _jflat(jcarry.opt_state.m)
    scale = max(float(np.abs(v).max()) for v in m.values())
    got = _tflat(tcarry.params)
    for k, want in _jflat(jcarry.params).items():
        atol = np.where(np.abs(m[k]) < 1e-4 * scale, 2, 1e-3) * ocfg["lr"]
        assert (np.abs(got[k] - want) <= atol).all(), k


# ---------------------------------------------------------------------------
# Serving


_jdecode = jax.jit(lambda p, c, t, i: jtfm.decode_step(p, c, t, i,
                                                       jget_config(ARCH)))


def oneshot(prompt, frames, max_new):
    """The reference's offline path: encode + prefill(enc_out) +
    decode_step, greedy (``tests/test_serving_runners.py``); each
    request's tokens computed once per process."""
    return _oneshot(tuple(prompt), frames.tobytes(), max_new)


@functools.lru_cache(maxsize=None)
def _oneshot(prompt, frames_bytes, max_new):
    jcfg, _, jp, _ = models()
    frames = np.frombuffer(frames_bytes, np.float32).reshape(
        jcfg.frontend_tokens, jcfg.d_model)
    enc = jencdec.encode(jp["encoder"], jnp.asarray(frames[None]), jcfg)
    logits, caches = jtfm.prefill(jp, jnp.asarray([prompt], jnp.int32),
                                  jcfg, cache_len=CACHE_LEN, enc_out=enc,
                                  cache_dtype=jnp.float32)
    tok = int(jnp.argmax(logits[0, -1]))
    out = [tok]
    for i in range(max_new - 1):
        lg, caches = _jdecode(jp, caches, jnp.asarray([[tok]], jnp.int32),
                              jnp.asarray(len(prompt) + i, jnp.int32))
        tok = int(jnp.argmax(lg[0, 0]))
        out.append(tok)
    return out


def _engine(tp, tcfg, backend, n_slots=2):
    return api.make_serving_engine(tp, tcfg, device="cpu", n_slots=n_slots,
                                   cache_len=CACHE_LEN, prefill_chunk=4,
                                   cache_dtype=torch.float32,
                                   attn_backend=backend)


@pytest.mark.parametrize("backend", ["gather", "cuda"])
def test_whisper_serves_end_to_end_with_parity(backend):
    """3 requests on 2 slots (a slot is recycled and its encoder row
    restaged), each with its own frames: greedy tokens equal the
    reference's one-shot tokens, on both attention backends (``cuda``:
    the paged kernels' plain versions, the cross-attention's over the
    encoder rows on decode ticks); warmup leaves them unchanged."""
    jcfg, tcfg, jp, tp = models()
    rs = np.random.RandomState(0)
    eng = _engine(tp, tcfg, backend)
    assert type(eng.runner).__name__ == "EncoderPrefixRunner"
    assert eng.warmup() == 2 * (1 + len(eng.runner.buckets)) + 1
    specs = []
    for i, (pl, mn) in enumerate([(5, 6), (9, 4), (3, 7)]):
        prompt = rs.randint(1, tcfg.vocab_size, size=pl).tolist()
        frames = rs.randn(tcfg.frontend_tokens,
                          tcfg.d_model).astype(np.float32)
        specs.append((prompt, frames, mn))
        eng.submit(Request(rid=i, prompt=prompt,
                           sampling=SamplingParams(max_new_tokens=mn),
                           frames=frames))
    done = eng.run()
    assert sum(len(h) for h in eng.slot_history) == 3
    for i, (prompt, frames, mn) in enumerate(specs):
        assert done[i].out_tokens == oneshot(prompt, frames, mn), i


def test_whisper_staggered_admission_keeps_enc_kv_isolated():
    """A request admitted mid-decode stages its encoder K/V into another
    row of the shared buffer: both match their solo one-shot runs, and
    the first request's row is untouched by the second's staging."""
    jcfg, tcfg, jp, tp = models()
    rs = np.random.RandomState(1)
    eng = _engine(tp, tcfg, "cuda")
    reqs = []
    for i, (pl, mn) in enumerate([(9, 8), (5, 6)]):
        reqs.append(Request(
            rid=i, prompt=rs.randint(1, tcfg.vocab_size, size=pl).tolist(),
            sampling=SamplingParams(max_new_tokens=mn),
            frames=rs.randn(tcfg.frontend_tokens,
                            tcfg.d_model).astype(np.float32)))
    eng.submit(reqs[0])
    while len(reqs[0].out_tokens) < 3:
        eng.step()
    row0 = eng.runner.enc_kv["g0_xdec"]["k"][:, 0].clone()
    eng.submit(reqs[1])
    done = eng.run()
    assert torch.equal(eng.runner.enc_kv["g0_xdec"]["k"][:, 0], row0)
    for r in reqs:
        assert done[r.rid].out_tokens == oneshot(
            r.prompt, r.frames, r.sampling.max_new_tokens)


def test_whisper_validates_frames_and_the_registry():
    """Frames missing or misshapen raise with the reference's messages;
    the registry serves audio through ``encoder_prefix`` and vlm
    through nothing (``make_runner`` raises before touching params)."""
    _, tcfg, _, tp = models()
    eng = _engine(tp, tcfg, "gather", n_slots=1)
    with pytest.raises(ValueError, match="frames"):
        eng.submit(Request(rid=0, prompt=[1, 2],
                           sampling=SamplingParams(max_new_tokens=2)))
    with pytest.raises(ValueError, match="shape"):
        eng.submit(Request(rid=1, prompt=[1, 2],
                           sampling=SamplingParams(max_new_tokens=2),
                           frames=np.zeros((3, 3), np.float32)))
    assert runner_name_for(tcfg) == "encoder_prefix"
    assert runner_name_for(get_config("qwen1.5-4b-smoke")) == "token"
    assert runner_name_for(get_config("chatglm3-6b-smoke")) == "token"
    vlm = get_config("internvl2-1b-smoke")
    assert runner_name_for(vlm) is None
    assert not tfm.supports_slot_serving(vlm)
    assert not tfm.supports_slot_serving(tcfg)
    with pytest.raises(NotImplementedError, match="registered"):
        make_runner(None, vlm, n_slots=1, cache_len=8, prefill_chunk=4,
                    cache_dtype=torch.float32)
