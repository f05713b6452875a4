"""The moe family on the port's static path (whole-prompt prefill + lockstep
greedy decode, ``launch/serve.py --static``) against the JAX package's.

``granite-moe-1b-a400m-smoke`` (``moe`` blocks: GQA attention, the MoE
FFN) and ``deepseek-v3-671b-smoke`` (one ``mla_dense`` and one
``mla_moe`` block: MLA over contiguous latent rows) with the JAX init
bridged through numpy, fp32 weights and caches. On the CPU the port's
kernel wrappers run their plain versions.

- ``prefill`` then 8 ``decode_step``s, each side on its own greedy
  tokens: logits within 1e-4 at every step, every cache leaf after the
  prefill within 1e-5 (positions exact), the tokens identical.
- ``mla_decode`` over a contiguous cache with holes, and
  ``ops.decode_mla(table=None)`` on both backends against JAX's
  ``decode_mla(table=None)`` on its ``xla`` route and its ``pallas`` route
  in interpret mode, within 1e-5.
- int8 latent scales without a table raise, as the reference's.
"""
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
from repro.models.lm import mla as jmla
from repro.models.lm import transformer as jtfm
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import serve
from repro_torch.models.lm import mla
from repro_torch.models.lm import transformer as tfm

ARCHS = ["granite-moe-1b-a400m-smoke", "deepseek-v3-671b-smoke"]


@functools.lru_cache(maxsize=None)
def models(arch):
    """(jax cfg, port cfg, jax params, port params), fp32."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jp = japi.init_params(jax.random.key(0), jcfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, jp, tp = models(arch)
    P, n_steps = 21, 8
    tok = np.random.RandomState(3).randint(1, 256, (3, P)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jtfm.prefill(
        p, t, jcfg, cache_len=P + n_steps, cache_dtype=jnp.float32))(
            jp, jnp.asarray(tok))
    tl, tc = tfm.prefill(tp, torch.from_numpy(tok), tcfg,
                         cache_len=P + n_steps, cache_dtype=torch.float32)
    _close(tl, jl, 1e-4)
    assert set(tc) == set(jc)
    for g in jc:
        assert set(tc[g]) == set(jc[g]), g
        for name, want in jc[g].items():
            got = tc[g][name]
            assert tuple(got.shape) == want.shape, (g, name)
            if got.dtype == torch.int32:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                _close(got, want, 1e-5)
    step = jax.jit(lambda p, c, t, i: jtfm.decode_step(p, c, t, i, jcfg))
    jcur = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    tcur = tl[:, -1:].argmax(-1).to(torch.int32)
    for i in range(n_steps):
        np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))
        jl, jc = step(jp, jc, jcur, jnp.asarray(P + i, jnp.int32))
        tl, tc = tfm.decode_step(tp, tc, tcur, P + i, tcfg)
        _close(tl, jl, 1e-4)
        jcur = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        tcur = tl[:, -1:].argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))


@pytest.mark.parametrize("arch", ARCHS)
def test_static_generate_matches_the_reference_loop(arch):
    """The reference launcher's loop (bf16 caches of prompt + tokens
    positions) and ``serve.static_generate``: identical greedy tokens,
    no kernel launched on the CPU."""
    jcfg, tcfg, jp, tp = models(arch)
    P, n_new = 16, 6
    tok = np.random.RandomState(4).randint(1, 256, (2, P)).astype(np.int32)
    logits, caches = jtfm.prefill(jp, jnp.asarray(tok), jcfg,
                                  cache_len=P + n_new)
    step = jax.jit(lambda p, c, t, i: jtfm.decode_step(p, c, t, i, jcfg))
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [cur]
    for i in range(n_new - 1):
        logits, caches = step(jp, caches, cur, jnp.asarray(P + i, jnp.int32))
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(cur)
    r = serve.static_generate(tp, tcfg, torch.from_numpy(tok), n_new)
    np.testing.assert_array_equal(
        r["tokens"].numpy(), np.concatenate([np.asarray(w) for w in want], 1))
    assert r["launches_prefill"] == {} and r["launches_decode"] == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_empty_caches_match_jax_layout(arch):
    jcfg, tcfg, _, _ = models(arch)
    jc = jtfm.init_caches(jcfg, 3, 20)
    tc = tfm.init_caches(tcfg, 3, 20, device="cpu")
    assert set(tc) == set(jc)
    for g in jc:
        assert set(tc[g]) == set(jc[g])
        for name, want in jc[g].items():
            got = tc[g][name]
            assert tuple(got.shape) == want.shape, (g, name)
            assert str(got.dtype)[6:] == str(want.dtype), (g, name)
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))


def _contiguous_latent(rs, B, L, kvr, rd, fills, holes):
    """Stale (random) latent rows; row b holds positions 0..fills[b]-1
    except ``holes`` (b, l), which stay empty."""
    c = rs.randn(B, L, kvr).astype(np.float32)
    kr = rs.randn(B, L, rd).astype(np.float32)
    pos = np.full((B, L), pa.EMPTY_POS, np.int32)
    for b, f in enumerate(fills):
        pos[b, :f] = np.arange(f)
    for b, l in holes:
        pos[b, l] = pa.EMPTY_POS
    return c, kr, pos


@pytest.mark.parametrize("t_form", ["scalar", "rows", "column"])
def test_mla_decode_matches_reference_on_a_cache_with_holes(t_form):
    """One ``mla_decode`` of deepseek-smoke's first layer over a
    contiguous fp32 latent cache with stale rows and holes: output and
    every cache leaf within 1e-5 of the reference's; ``t`` as one
    position or per row (the slot at ``t % L`` written)."""
    jcfg, tcfg, jp, tp = models("deepseek-v3-671b-smoke")
    B, L = 3, 13
    rs = np.random.RandomState(5)
    kvr, rd = tcfg.mla_kv_lora_rank, tcfg.mla_qk_rope_dim
    c, kr, pos = _contiguous_latent(rs, B, L, kvr, rd, (9, 9, 9),
                                    ((0, 3), (2, 0)))
    x = rs.randn(B, 1, tcfg.d_model).astype(np.float32)
    t = {"scalar": 9, "rows": np.array([9, 15, 4], np.int32),
         "column": np.array([[9], [15], [4]], np.int32)}[t_form]
    jpl = jax.tree.map(lambda a: a[0], jp["groups"]["g0_mla_dense"]["attn"])
    tpl = tfm.layer_views(tp["groups"]["g0_mla_dense"], 1)[0]["attn"]
    jcache = {"c": jnp.asarray(c), "k_rope": jnp.asarray(kr),
              "pos": jnp.asarray(pos)}
    tcache = {"c": torch.from_numpy(c.copy()),
              "k_rope": torch.from_numpy(kr.copy()),
              "pos": torch.from_numpy(pos.copy())}
    want, wc = jmla.mla_decode(jpl, jnp.asarray(x), jcache,
                               jnp.asarray(t), jcfg)
    got, gc = mla.mla_decode(tpl, torch.from_numpy(x), tcache,
                             t if t_form == "scalar" else
                             torch.from_numpy(t), tcfg)
    _close(got, want, 1e-5)
    for name in ("c", "k_rope"):
        _close(gc[name], wc[name], 1e-5)
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))
    assert gc["c"] is tcache["c"]            # in place


@pytest.mark.parametrize("fill", ["live", "pads", "all pads"])
def test_mla_contiguous_writes_keep_a_fixed_count(fill):
    """``mla_decode_slots(table=None)`` writes ``c``, ``k_rope`` and
    ``pos`` through ``ops.scatter_rows`` at the fixed ``B * C`` count,
    whatever ``t`` holds: row b's column ``t % L``, or L (dropped on the
    device) for a pad token, as the reference's ``mode="drop"`` scatter.
    The rows that land are the reference's; the rest stay as they
    were."""
    from unittest import mock
    jcfg, tcfg, jp, tp = models("deepseek-v3-671b-smoke")
    B, C, L = 3, 4, 13
    rs = np.random.RandomState(7)
    kvr, rd = tcfg.mla_kv_lora_rank, tcfg.mla_qk_rope_dim
    c, kr, pos = _contiguous_latent(rs, B, L, kvr, rd, (5, 9, 2), ())
    t = np.stack([np.arange(f, f + C) for f in (5, 9, 11)]).astype(np.int32)
    if fill == "pads":
        t[1, 2:] = -1
        t[2] = -1
    elif fill == "all pads":
        t[:] = -1
    x = rs.randn(B, C, tcfg.d_model).astype(np.float32)
    tpl = tfm.layer_views(tp["groups"]["g0_mla_dense"], 1)[0]["attn"]
    jpl = jax.tree.map(lambda a: a[0], jp["groups"]["g0_mla_dense"]["attn"])
    tcache = {"c": torch.from_numpy(c.copy()),
              "k_rope": torch.from_numpy(kr.copy()),
              "pos": torch.from_numpy(pos.copy())}
    seen = []

    def counted(dst, i0, i1, src):
        seen.append((i0.numel(), i1.numel(), src.shape[0]))
        return ops.scatter_rows(dst, i0, i1, src)
    with mock.patch.object(mla, "scatter_rows", counted):
        mla.mla_decode_slots(tpl, torch.from_numpy(x), tcache,
                             torch.from_numpy(t), tcfg)
    assert seen == [(B * C,) * 3] * 3
    _, wc = jmla.mla_decode_slots(
        jpl, jnp.asarray(x), {"c": jnp.asarray(c), "k_rope": jnp.asarray(kr),
                              "pos": jnp.asarray(pos)}, jnp.asarray(t), jcfg)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(wc["pos"]))
    for name in ("c", "k_rope"):
        _close(tcache[name], wc[name], 1e-5)


@pytest.mark.parametrize("L,C", [(13, 1), (13, 3), (24, 1), (24, 4)])
def test_decode_mla_contiguous_matches_jax_routes(L, C):
    """``ops.decode_mla(table=None)``: the gather route against JAX's
    ``xla`` route, and the ``cuda`` route (the rows viewed as an arena of
    ``mla_contiguous_block_len`` blocks; the kernels' plain versions on
    the CPU) against JAX's ``pallas`` route in interpret mode, within
    1e-5 on live rows; pad rows (t < 0) and a hole included."""
    rs = np.random.RandomState(L * 10 + C)
    B, H, kvr, rd = 4, 4, 16, 8
    c, kr, pos = _contiguous_latent(rs, B, L, kvr, rd,
                                    (L, L - C, 5, L), ((1, 2),))
    t = np.stack([np.arange(f, f + C) for f in (L - C, L - C, 5, 0)]
                 ).astype(np.int32)
    t[3] = -1
    t[2, 1:] = -1
    qa = rs.randn(B, C, H, kvr).astype(np.float32)
    qr = rs.randn(B, C, H, rd).astype(np.float32)
    scale = (kvr + rd) ** -0.5
    live = t >= 0
    for jb, tb in (("xla", "gather"), ("pallas", "cuda")):
        want = jops.decode_mla(jnp.asarray(qa), jnp.asarray(qr),
                               jnp.asarray(c), jnp.asarray(kr),
                               jnp.asarray(pos), jnp.asarray(t),
                               scale=scale, table=None, backend=jb)
        got = ops.decode_mla(torch.from_numpy(qa), torch.from_numpy(qr),
                             torch.from_numpy(c), torch.from_numpy(kr),
                             torch.from_numpy(pos), torch.from_numpy(t),
                             scale=scale, table=None, backend=tb)
        assert got.shape == (B, C, H, kvr) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want, np.float32)[live],
                                   rtol=1e-5, atol=1e-5, err_msg=tb)
    assert ops.launch_counts()["mla_paged"] == 0


def test_mla_contiguous_block_len():
    """Blocks that either MLA kernel stages: a divisor of L where one of
    at least half the cap exists, else the cap with masked padding."""
    assert ops.mla_contiguous_block_len(544) == 34
    assert ops.mla_contiguous_block_len(541) == pa.MLA_CORE_MAX_BLOCK
    assert ops.mla_contiguous_block_len(2048) == 64
    assert ops.mla_contiguous_block_len(13) == 13
    for L in (37, 541, 544, 1000):
        bl = ops.mla_contiguous_block_len(L)
        assert bl <= pa.MLA_CORE_MAX_BLOCK
        assert L % bl == 0 or bl == pa.MLA_CORE_MAX_BLOCK


def test_int8_latent_scales_without_a_table_raise():
    """Contiguous rows store the latent directly: int8 scales with
    ``table=None`` raise in both packages, in ``decode_mla`` and in the
    decode step."""
    rs = np.random.RandomState(0)
    B, L, H, kvr, rd = 2, 8, 2, 16, 8
    q = rs.randn(B, 1, H, kvr).astype(np.float32)
    qr = rs.randn(B, 1, H, rd).astype(np.float32)
    c = np.zeros((B, L, kvr), np.int8)
    kr = np.zeros((B, L, rd), np.int8)
    s = np.ones((B, L), np.float32)
    pos = np.zeros((B, L), np.int32)
    t = np.full((B, 1), 3, np.int32)
    with pytest.raises(ValueError, match="paged layout"):
        jops.decode_mla(jnp.asarray(q), jnp.asarray(qr), jnp.asarray(c),
                        jnp.asarray(kr), jnp.asarray(pos), jnp.asarray(t),
                        scale=1.0, c_scale=jnp.asarray(s),
                        kr_scale=jnp.asarray(s))
    for backend in ("gather", "cuda"):
        with pytest.raises(ValueError, match="paged layout"):
            ops.decode_mla(*(torch.from_numpy(a) for a in (q, qr, c, kr,
                                                            pos, t)),
                           scale=1.0, backend=backend,
                           c_scale=torch.from_numpy(s),
                           kr_scale=torch.from_numpy(s))
    _, tcfg, _, tp = models("deepseek-v3-671b-smoke")
    cache = mla.init_mla_cache(tcfg, B, L, torch.int8)
    cache["c_scale"] = torch.ones(B, L)
    cache["kr_scale"] = torch.ones(B, L)
    tpl = tfm.layer_views(tp["groups"]["g0_mla_dense"], 1)[0]["attn"]
    with pytest.raises(ValueError, match="paged layout"):
        mla.mla_decode(tpl, torch.zeros(B, 1, tcfg.d_model), cache, 3, tcfg)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v3-671b"])
def test_static_cli_serves_the_moe_family(arch, capsys):
    """``--static`` (with ``--wbits 8``: packed as drawn, dequantized
    once) runs both smoke archs on the CPU."""
    serve.main(["--arch", arch, "--smoke", "--static", "--device", "cpu",
                "--slots", "2", "--prompt-len", "12", "--tokens", "4",
                "--wbits", "8"])
    out = capsys.readouterr().out
    assert "prefill 2x12" in out and "decoded 6 tokens" in out
    assert "kernel launches none" in out
