"""The port's paged attention against the JAX package's.

Both packages get the same numpy inputs: a poisoned arena (every
unwritten byte is stale KV from an earlier owner), blocks handed out in
random order, table holes, pad rows and ring windows. The JAX side runs
its Pallas kernels (``gqa_paged_p``, ``gqa_paged_chunk_p``) in interpret
mode and its XLA gather reference; the port runs, on CPU tensors, the
plain versions of its CUDA kernels (which walk the block table as the
kernels do) and its gather reference. Tolerances are the reference
tests': fp32 arenas 1e-5, bf16/fp8/int8 arenas (bf16 compute) and fp16
arenas (fp16 compute) 2e-2, on live rows (pad rows are garbage in both
packages). The CUDA kernels themselves are held to the plain versions on
a card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from test_torch_cuda import ARENAS, ATTN_TOL, arena_as, mk_arena

_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16,
        "fp8": jnp.float8_e4m3fn, "fp16": jnp.float16}


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
    """The fixed-shape writes (``paged_writes`` + ``ops.scatter_rows``'s
    drop route) leave the arena and the pos rows exactly as the
    reference's ``mode="drop"`` scatter does: pad tokens and tokens in
    unassigned blocks write nothing, in lockstep for KV and positions."""
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
    ops.scatter_rows(got_a, w.blk, w.off, torch.from_numpy(new).flatten(0, 1))
    ops.scatter_rows(got_p, w.b, w.lw, torch.from_numpy(t).reshape(-1))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert len(w.b) == B * t.shape[1]             # one write a token
    # five land: (0,1) (0,9) (1,2) (1,3) (1,4)
    assert int((w.blk < Nb).sum()) == int((w.lw < T * bl).sum()) == 5


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
     for arena in ("bf16", "fp8", "int8", "fp16") for C in (1, 4)]


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


# ----------------------------------------- the tensor-core chunk kernel


def _walk_share(qf, kl, vl, posl, live, tq, steps, window, cdt):
    """One warp's share of the tensor-core kernel: fp32 online softmax
    over its 16-position steps, p rounded to the compute dtype ``cdt``
    into P . V; a step with no assigned block is skipped. Returns (m, l,
    acc) per (B, Hkv, R)."""
    B, Hkv, R, hd = qf.shape
    m = torch.full((B, Hkv, R, 1), pa.NEG_INF)
    l = torch.zeros((B, Hkv, R, 1))
    acc = torch.zeros((B, Hkv, R, hd))
    tqe = tq[:, None, :, None]
    for step in steps:
        sl = slice(step * pa.CHUNK_STEP, (step + 1) * pa.CHUNK_STEP)
        kb = kl[:, sl].permute(0, 2, 1, 3)                  # (B, Hkv, 16, hd)
        vb = vl[:, sl].permute(0, 2, 1, 3)
        s = (qf @ kb.transpose(-1, -2)) * qf.shape[-1] ** -0.5
        p_pos = posl[:, sl][:, None, None, :]
        ok = (p_pos >= 0) & (p_pos <= tqe)
        if window > 0:
            ok &= p_pos > tqe - window
        s = torch.where(ok, s, torch.full_like(s, pa.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        step_live = live[:, sl].any(-1)[:, None, None, None]
        m = torch.where(step_live, m_new, m)
        l = torch.where(step_live, l * corr + p.sum(-1, keepdim=True), l)
        acc = torch.where(step_live,
                          acc * corr + p.to(cdt).float() @ vb,
                          acc)
    return m, l, acc


def _combine(parts):
    """Partials (m, l, acc) weighted by exp(m_i - M), as the kernel's
    in-CTA combine and its cross-CTA combine do."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    return (M, sum(wi * li for wi, (_, li, _) in zip(w, parts)),
            sum(wi * ai for wi, (_, _, ai) in zip(w, parts)))


def _tensor_core_chunk(q, k, v, pos, t, table, window, k_scale, v_scale,
                       plan):
    """Plain model of the tensor-core kernel on the partition of
    ``plan``: q rounded to the compute dtype (bf16, or fp16 for fp16
    arenas), the arena read per logical position (int8 dequantized to
    bf16; unassigned entries masked), every (split, warp) share walked
    on its own, the warps' partials combined per split, then the
    splits'. Returns (B, C, H*hd) fp32."""
    B, C, H, hd = q.shape
    n_blocks, bl, Hkv, _ = k.shape
    cdt = pa.compute_dtype(k.dtype)
    T, group = table.shape[1], H // Hkv
    L = plan.steps * pa.CHUNK_STEP
    lpos = torch.arange(L)
    col = torch.clamp(lpos // bl, max=T - 1)
    blk = torch.where(lpos[None] < T * bl, table[:, col].long(),
                      torch.full((B, L), -1))
    live = blk >= 0
    idx = (blk.clamp(min=0) * bl + (lpos % bl)[None]).reshape(-1)

    def logical(a, sc):
        rows = pa.take_blocks(a.reshape(n_blocks * bl, Hkv, hd), idx)
        rows = (pa.dequantize_kv(rows, sc.reshape(-1, Hkv)[idx])
                if sc is not None else rows.to(cdt))
        rows = rows.float().reshape(B, L, Hkv, hd)
        return torch.where(live[..., None, None], rows, torch.zeros(()))
    kl, vl = logical(k, k_scale), logical(v, v_scale)
    posl = pos.new_full((B, L), -1)            # -1: never a valid position
    posl[:, :T * bl] = torch.where(live[:, :T * bl], pos,
                                   torch.full_like(pos, -1))
    qf = (q.to(cdt).float().reshape(B, C, Hkv, group, hd)
          .permute(0, 2, 1, 3, 4).reshape(B, Hkv, C * group, hd))
    tq = t.repeat_interleave(group, dim=1)
    splits = [_combine([_walk_share(qf, kl, vl, posl, live, tq,
                                    pa.chunk_shares(plan, sp, w), window,
                                    cdt)
                        for w in range(pa.CHUNK_WARPS)])
              for sp in range(plan.splits)]
    _, l, acc = _combine(splits) if len(splits) > 1 else splits[0]
    o = acc / torch.clamp_min(l, 1e-30)
    return (o.reshape(B, Hkv, C, group, hd).permute(0, 2, 1, 3, 4)
            .reshape(B, C, H * hd))


@pytest.mark.parametrize("B,Hkv,R,T,bl", [(4, 20, 16, 16, 16),
                                          (4, 20, 16, 128, 16),
                                          (4, 2, 256, 16, 16),
                                          (2, 2, 8, 16, 4), (1, 1, 4, 3, 5),
                                          (1, 1, 16, 4096, 16),
                                          (4, 20, 1, 16, 16),     # decode
                                          (4, 20, 1, 128, 16),
                                          (4, 2, 16, 128, 16)])
def test_chunk_split_plan_partitions_every_step_once(B, Hkv, R, T, bl):
    """Every 16-position step of the table is walked by exactly one
    (split, warp) share; no CTA stages more than CHUNK_MAX_STEPS; the
    grid fills the card where the table allows and no split is empty."""
    plan = pa.chunk_split_plan(B, Hkv, R, T, bl)
    assert plan.row_tiles == -(-R // 16)
    assert plan.steps == -(-(T * bl) // pa.CHUNK_STEP)
    walked = sorted(s for sp in range(plan.splits)
                    for w in range(pa.CHUNK_WARPS)
                    for s in pa.chunk_shares(plan, sp, w))
    assert walked == list(range(plan.steps))
    assert plan.per <= pa.CHUNK_MAX_STEPS
    assert all(len(pa.chunk_shares(plan, sp, 0)) for sp in range(plan.splits))
    ctas = B * Hkv * plan.row_tiles * plan.splits
    assert 1 <= plan.stages <= pa.CHUNK_MAX_STAGES
    # every warp's steps in flight at once in one CTA a row tile, or
    # about two CTAs per SM (rounding to equal splits may leave a few
    # short) unless the table is too short to give every warp a step
    assert (plan.splits == 1 and plan.stages * pa.CHUNK_WARPS >= plan.steps
            ) or ctas >= 1.9 * pa.SMS or plan.per < 2 * pa.CHUNK_WARPS
    if (B, Hkv, R, T, bl) == (4, 20, 16, 16, 16):     # the served mixed tick
        assert plan == pa.ChunkPlan(1, 16, 1, 16, 4)
    if (B, Hkv, R, T, bl) == (4, 20, 16, 128, 16):    # 2048 positions
        assert plan == pa.ChunkPlan(1, 128, 4, 32, 2)
    # the qwen1.5-4b decode (R = group = 1): at 256 positions one CTA a
    # (row, KV head), every step in flight, no combine; at 2048 the walk
    # splits across CTAs with a 2-stage ring
    if (B, Hkv, R, T, bl) == (4, 20, 1, 16, 16):
        assert plan == pa.ChunkPlan(1, 16, 1, 16, 4)
    if (B, Hkv, R, T, bl) == (4, 20, 1, 128, 16):
        assert plan == pa.ChunkPlan(1, 128, 4, 32, 2)


# (arena, T, bl, window, holes): 2, 3 and 4 shares in one CTA, 24
# across six CTAs; a hole; a ring window that masks every position of
# the first share; a hole that empties a whole share
CHUNK_CASES = [(arena, T, bl, w, holes)
               for arena in ("bf16", "fp8", "int8", "fp16")
               for T, bl, w, holes in ((8, 4, 0, ((0, 2),)),
                                       (12, 4, 0, ()),
                                       (16, 4, 8, ((1, 1),)),
                                       (24, 16, 0, ((0, 2),)),
                                       (16, 4, 0, ((0, 0), (0, 1), (0, 2),
                                                   (0, 3))))]


@pytest.mark.parametrize("arena,T,bl,window,holes", CHUNK_CASES)
def test_tensor_core_chunk_model_matches_jax_pallas_kernel(arena, T, bl,
                                                           window, holes):
    """The tensor-core chunk kernel's split walk and combine on
    ``chunk_split_plan``'s partition (bf16 q, K, V and p; per-share
    online softmax; exp(m_i - M) weights; a share with every position
    masked weighs 0) against the JAX Pallas chunk kernel at ATTN_TOL on
    live rows, with pad rows and a decode row padded to C."""
    rs = np.random.RandomState(T * 10 + bl + window + len(holes))
    B, Hkv, group, C, hd = 4, 2, 2, 4, 16
    fills = [T * bl - C, bl - 1, 0, T * bl // 2]
    k, v, pos, t, table = mk_arena(rs, B, Hkv, hd, bl, T, C, fills,
                                   holes=holes)
    t[3, 1:] = -1
    t[2] = -1
    q = rs.randn(B, C, Hkv * group, hd).astype(np.float32)
    jk, jv, jks, jvs = _jax_arena(k, v, arena)
    tk, tv, tks, tvs = arena_as(k, v, arena)
    plan = pa.chunk_split_plan(B, Hkv, C * group, T, bl)
    shares = sum(1 for sp in range(plan.splits)
                 for w in range(pa.CHUNK_WARPS)
                 if len(pa.chunk_shares(plan, sp, w)))
    assert shares == {(8, 4): 2, (12, 4): 3, (16, 4): 4, (24, 16): 24}[T, bl]
    assert pa.chunk_route(tk.dtype, C, hd) == "tensor_core"
    want = jops.decode_gqa(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                           jnp.asarray(t), window=window,
                           table=jnp.asarray(table), backend="pallas",
                           k_scale=jks, v_scale=jvs)
    got = _tensor_core_chunk(torch.from_numpy(q), tk, tv,
                             torch.from_numpy(pos), torch.from_numpy(t),
                             torch.from_numpy(table), window, tks, tvs, plan)
    live = t >= 0
    assert bool(torch.isfinite(got).all())
    tol = ATTN_TOL[arena]
    np.testing.assert_allclose(got.numpy()[live],
                               np.asarray(want, np.float32)[live],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arena,T,bl,window,holes", [
    (arena, T, bl, w, holes) for arena in ("bf16", "fp8", "int8", "fp16")
    for T, bl, w, holes in ((16, 16, 0, ((0, 5),)),    # 16 steps, 1 CTA
                            (128, 16, 24, ((0, 5),)))])   # split, ring
def test_tensor_core_decode_model_matches_jax_pallas_kernel(arena, T, bl,
                                                            window, holes):
    """The C == 1 decode on the tensor-core kernel: its split walk and
    combine on ``chunk_split_plan``'s partition for R = 1 query row a KV
    head (qwen1.5-4b's MHA, padded to an m16 tile) at 256 and 2048
    positions against the JAX Pallas decode kernel (``gqa_paged_p``) at
    ATTN_TOL on live rows, with a free slot."""
    rs = np.random.RandomState(T + bl + window + len(arena))
    B, Hkv, group, hd = 4, 4, 1, 16
    fills = [T * bl - 1, bl - 1, 0, T * bl // 2]
    k, v, pos, t, table = mk_arena(rs, B, Hkv, hd, bl, T, 1, fills,
                                   holes=holes)
    t[2] = -1
    q = rs.randn(B, 1, Hkv * group, hd).astype(np.float32)
    jk, jv, jks, jvs = _jax_arena(k, v, arena)
    tk, tv, tks, tvs = arena_as(k, v, arena)
    plan = pa.chunk_split_plan(B, Hkv, group, T, bl)
    assert (plan.splits == 1) == (T * bl <= 256)
    assert pa.decode_route(tk.dtype, hd) == "tensor_core"
    want = jops.decode_gqa(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                           jnp.asarray(t), window=window,
                           table=jnp.asarray(table), backend="pallas",
                           k_scale=jks, v_scale=jvs)
    got = _tensor_core_chunk(torch.from_numpy(q), tk, tv,
                             torch.from_numpy(pos), torch.from_numpy(t),
                             torch.from_numpy(table), window, tks, tvs, plan)
    live = t >= 0
    tol = ATTN_TOL[arena]
    np.testing.assert_allclose(got.numpy()[live],
                               np.asarray(want, np.float32)[live],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arena", ["fp32", "bf16", "fp8", "int8", "fp16"])
def test_decode_route_is_by_dtype_and_shape(arena):
    """The C == 1 decode takes the tensor-core kernel over bf16-compute
    arenas (bf16, fp8, int8) and fp16 arenas at head dims 16..256
    (multiples of 16); fp32 arenas and other head dims the CUDA-core one.
    Every arena dtype has a kernel dtype code (no refusal of fp16)."""
    dt = ARENAS[arena]
    assert dt in pa._KV_DTYPES
    want = "cuda_core" if arena == "fp32" else "tensor_core"
    for hd in (16, 64, 128, 256):
        assert pa.decode_route(dt, hd) == want
        assert pa.chunk_route(dt, 4, hd) == want
        assert pa.chunk_route(dt, 1, hd) == "cuda_core"
    for hd in (8, 72, 288):
        assert pa.decode_route(dt, hd) == "cuda_core"


def test_chunk_route_is_by_dtype_and_shape():
    """bf16-compute arenas and fp16 arenas at C > 1 and head dims
    16..256 (multiples of 16) take the tensor-core kernel; fp32 arenas,
    C == 1 and other head dims the CUDA-core one."""
    for dt in (torch.bfloat16, torch.float8_e4m3fn, torch.int8,
               torch.float16):
        assert pa.chunk_route(dt, 16, 128) == "tensor_core"
        assert pa.chunk_route(dt, 2, 256) == "tensor_core"
        assert pa.chunk_route(dt, 1, 128) == "cuda_core"
        assert pa.chunk_route(dt, 16, 72) == "cuda_core"
        assert pa.chunk_route(dt, 16, 288) == "cuda_core"
    assert pa.chunk_route(torch.float32, 16, 128) == "cuda_core"
