"""The port's paged attention against the JAX package's.

Both packages get the same numpy inputs: a poisoned arena (every
unwritten byte is stale KV from an earlier owner), blocks handed out in
random order, table holes, pad rows and ring windows. The JAX side runs
its Pallas kernels (``gqa_paged_p``, ``gqa_paged_chunk_p``) in interpret
mode and its XLA gather reference; the port runs, on CPU tensors, the
plain versions of its CUDA kernels (which walk the block table as the
kernels do) and its gather reference. Tolerances are the reference
tests': fp32 arenas 1e-5, bf16/fp8/int8 arenas (bf16 compute) 2e-2, on
live rows (pad rows are garbage in both packages). The CUDA kernels
themselves are held to the plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from test_torch_cuda import ATTN_TOL, arena_as, mk_arena

_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16,
        "fp8": jnp.float8_e4m3fn}


def _jax_arena(k, v, arena):
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    if arena == "int8":
        (kq, ks), (vq, vs) = jpa.quantize_kv(kj), jpa.quantize_kv(vj)
        return kq, vq, ks, vs
    return kj.astype(_JDT[arena]), vj.astype(_JDT[arena]), None, None


# ------------------------------------------------------------ index math


@pytest.mark.parametrize("block_len,n_blocks,T", [(4, 7, 3), (8, 4, 2),
                                                  (16, 2, 1), (2, 9, 5)])
def test_paged_indices_equal_the_reference(block_len, n_blocks, T):
    """Same (wblk, off, lw, gidx, Leff) arrays as the reference, over pad
    tokens, block crossings, the exact last position and ring wrap."""
    rs = np.random.RandomState(block_len * 31 + T)
    B, Leff = 4, T * block_len
    table = rs.randint(-1, n_blocks, size=(B, T)).astype(np.int32)
    table[0] = -1
    for t in (np.array([[-1], [0], [block_len], [Leff - 1]], np.int32),
              np.array([[Leff, -1], [Leff + block_len - 1, 0],
                        [3 * Leff + 1, 1], [2 * Leff - 1, Leff]], np.int32)):
        want = jpa.paged_indices(jnp.asarray(table), jnp.asarray(t),
                                 n_blocks, block_len)
        got = pa.paged_indices(torch.from_numpy(table), torch.from_numpy(t),
                               n_blocks, block_len)
        assert got[4] == want[4] == Leff
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_arena_scatter_drops_like_the_reference():
    """The filtered scatter (``paged_writes`` + ``put_rows``) leaves the
    arena and the pos rows exactly as the reference's ``mode="drop"``
    scatter does: pad tokens and tokens in unassigned blocks write
    nothing, in lockstep for KV and positions."""
    rs = np.random.RandomState(5)
    B, T, bl, Nb, Hkv, hd = 3, 3, 4, 7, 2, 8
    table = np.array([[3, -1, 5], [0, 1, -1], [-1, -1, -1]], np.int32)
    t = np.array([[1, 5, 9, -1], [2, 3, 4, 8], [0, 1, -1, -1]], np.int32)
    arena = rs.randn(Nb, bl, Hkv, hd).astype(np.float32)
    pos = np.full((B, T * bl), pa.EMPTY_POS, np.int32)
    new = rs.randn(B, t.shape[1], Hkv, hd).astype(np.float32)
    wblk, off, lw, _, _ = jpa.paged_indices(jnp.asarray(table),
                                            jnp.asarray(t), Nb, bl)
    want_a = jnp.asarray(arena).at[wblk, off].set(jnp.asarray(new),
                                                  mode="drop")
    want_p = jnp.asarray(pos).at[jnp.arange(B)[:, None], lw].set(
        jnp.asarray(t), mode="drop")
    w = pa.paged_writes(torch.from_numpy(table), torch.from_numpy(t), Nb, bl)
    got_a, got_p = torch.from_numpy(arena.copy()), torch.from_numpy(pos.copy())
    pa.put_rows(got_a, (w.blk, w.off), torch.from_numpy(new)[w.b, w.c])
    pa.put_rows(got_p, (w.b, w.lw), torch.from_numpy(t)[w.b, w.c])
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert len(w.b) == 5              # (0,1) (0,9) (1,2) (1,3) (1,4)


@pytest.mark.parametrize("shape", [(5, 3, 16), (2, 7, 4, 8)])
def test_kv_quantization_is_bitwise_the_reference(shape):
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    x[0] = 0.0                        # an all-zero vector stays exactly 0
    jq, js = jpa.quantize_kv(jnp.asarray(x))
    q, s = pa.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    jd = jpa.dequantize_kv(jq, js)
    d = pa.dequantize_kv(q, s)
    np.testing.assert_array_equal(d.float().numpy(),
                                  np.asarray(jd, np.float32))


# ------------------------------------------------------- read-path parity


CASES = [  # (arena, group, C, window, holes, pads)
    ("fp32", 1, 1, 0, ((0, 2),), True),
    ("fp32", 2, 1, 7, (), False),
    ("fp32", 1, 3, 5, ((0, 2),), True),
    ("fp32", 2, 4, 0, (), True),
] + [(arena, 2, C, 0, ((0, 2),), True)
     for arena in ("bf16", "fp8", "int8") for C in (1, 4)]


@pytest.mark.parametrize("arena,group,C,window,holes,pads", CASES)
def test_paged_read_matches_the_reference(arena, group, C, window, holes,
                                          pads):
    """C == 1 decode and C > 1 chunks, group 1 and 2, a table hole, pad
    rows (a decode row padded to C, a free slot), ring windows, every
    arena dtype: the port's kernel walk (``cuda`` backend, plain version
    on the CPU) equals the JAX Pallas kernel, and the port's gather
    reference equals the JAX XLA reference."""
    rs = np.random.RandomState(group * 100 + C * 10 + window + len(arena))
    B, Hkv, hd, bl, T = 4, 2, 16, 4, 6
    fills = [T * bl - C, bl - 1, 0, 9]
    k, v, pos, t, table = mk_arena(rs, B, Hkv, hd, bl, T, C, fills,
                                   holes=holes)
    if pads:
        t[3, 1:] = -1
        t[2] = -1
    q = rs.randn(B, C, Hkv * group, hd).astype(np.float32)
    jk, jv, jks, jvs = _jax_arena(k, v, arena)
    tk, tv, tks, tvs = arena_as(k, v, arena)
    live = t >= 0
    tol = ATTN_TOL[arena]
    for jb, tb in (("pallas", "cuda"), ("xla", "gather")):
        want = jops.decode_gqa(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                               jnp.asarray(t), window=window,
                               table=jnp.asarray(table), backend=jb,
                               k_scale=jks, v_scale=jvs)
        got = ops.decode_gqa(torch.from_numpy(q), tk, tv,
                             torch.from_numpy(pos), torch.from_numpy(t),
                             window=window, table=torch.from_numpy(table),
                             backend=tb, k_scale=tks, v_scale=tvs)
        assert got.shape == (B, C, Hkv * group * hd)
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want, np.float32)[live],
                                   rtol=tol, atol=tol, err_msg=tb)
    assert ops.launch_counts()["gqa_paged"] == 0     # CPU: plain versions
    assert ops.launch_counts()["gqa_paged_chunk"] == 0


def test_backend_resolution():
    assert ops.resolve_attn_backend(None, "cpu") == "gather"
    assert ops.resolve_attn_backend("auto", "cuda") == "cuda"
    assert ops.resolve_attn_backend("cuda", "cpu") == "cuda"
    with pytest.raises(ValueError):
        ops.resolve_attn_backend("pallas")


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the CUDA wrappers raise on CPU tensors."""
    rs = np.random.RandomState(0)
    k, v, pos, t, table = mk_arena(rs, 2, 2, 16, 4, 2, 1, [3, 1])
    q = torch.from_numpy(rs.randn(2, 2, 1, 16).astype(np.float32))
    args = (torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
            torch.from_numpy(t[:, 0].copy()), torch.from_numpy(table))
    with pytest.raises(ValueError, match="CUDA"):
        pa.gqa_paged_cuda(q, *args)
    with pytest.raises(ValueError, match="CUDA"):
        pa.gqa_paged_chunk_cuda(q.reshape(2, 1, 2, 16), args[0], args[1],
                                args[2], torch.from_numpy(t), args[4])
    assert pa.gqa_paged_cuda.launches == 0
    assert pa.gqa_paged_chunk_cuda.launches == 0
