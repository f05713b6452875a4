"""The port's MLA (DeepSeek-V3's absorbed latent attention) against the
JAX package's.

Both packages get the same numpy inputs: a poisoned latent arena (every
unwritten byte is stale), blocks handed out in random order, a table
hole and pad rows. The JAX side runs its Pallas kernels (``mla_paged_p``,
``mla_paged_chunk_p``) in interpret mode and its XLA gather reference;
the port runs, on CPU tensors, the plain versions of its CUDA kernels
(which walk the block table as the kernels do) and its gather reference.
Tolerances are the reference tests': fp32 arenas 1e-5, bf16/fp8/int8
arenas 2e-2, on live rows (pad rows are garbage in both packages). The
layer test runs one ``mla_decode_slots`` of ``deepseek-v3-671b-smoke``
in both packages on the same pool state. The CUDA kernel itself is held
to the plain versions on a card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.config import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro.models.lm import mla as jmla
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models.lm import mla
from test_torch_cuda import ARENAS, ATTN_TOL, mk_latent

_JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16,
        "fp8": jnp.float8_e4m3fn, "fp16": jnp.float16}


def _jax_latent(c, kr, arena):
    cj, krj = jnp.asarray(c), jnp.asarray(kr)
    if arena == "int8":
        (cq, cs), (krq, krs) = jpa.quantize_kv(cj), jpa.quantize_kv(krj)
        return cq, krq, cs, krs
    return cj.astype(_JDT[arena]), krj.astype(_JDT[arena]), None, None


def _torch_latent(c, kr, arena):
    ct, krt = torch.from_numpy(c), torch.from_numpy(kr)
    if arena == "int8":
        (cq, cs), (krq, krs) = pa.quantize_kv(ct), pa.quantize_kv(krt)
        return cq, krq, cs, krs
    return ct.to(ARENAS[arena]), krt.to(ARENAS[arena]), None, None


CASES = [(arena, C, qr_dtype)
         for arena in ("fp32", "bf16", "fp8", "int8", "fp16")
         for C in (1, 3) for qr_dtype in ("same",)] + [
    ("bf16", 1, "fp32"), ("int8", 3, "fp32")]


@pytest.mark.parametrize("arena,C,qr_dtype", CASES)
def test_mla_read_matches_the_reference(arena, C, qr_dtype):
    """C == 1 decode and C > 1 chunks, a table hole, pad rows (a decode
    row padded to C, a free slot), every arena dtype, q_rope in the
    model's dtype or wider than q_abs: the port's kernel walk (``cuda``
    backend, plain version on the CPU) equals the JAX Pallas kernel in
    interpret mode, and the port's gather reference the JAX XLA
    reference."""
    rs = np.random.RandomState(C * 10 + len(arena))
    B, H, kvr, rd, bl, T = 4, 4, 16, 8, 4, 6
    fills = [T * bl - C, bl - 1, 0, 9]
    c, kr, pos, t, table = mk_latent(rs, B, kvr, rd, bl, T, C, fills,
                                     holes=((0, 2),))
    t[3, 1:] = -1
    t[2] = -1
    qdt = "fp32" if arena == "fp32" else "bf16"
    qa = rs.randn(B, C, H, kvr).astype(np.float32)
    qr = rs.randn(B, C, H, rd).astype(np.float32)
    qr_dt = qdt if qr_dtype == "same" else qr_dtype
    jc, jkr, jcs, jkrs = _jax_latent(c, kr, arena)
    tc, tkr, tcs, tkrs = _torch_latent(c, kr, arena)
    jqa, jqr = (jnp.asarray(qa).astype(_JDT[qdt]),
                jnp.asarray(qr).astype(_JDT[qr_dt]))
    tqa, tqr = (torch.from_numpy(qa).to(ARENAS[qdt]),
                torch.from_numpy(qr).to(ARENAS[qr_dt]))
    scale = (kvr + rd) ** -0.5
    live = t >= 0
    tol = ATTN_TOL[arena]
    for jb, tb in (("pallas", "cuda"), ("xla", "gather")):
        want = jops.decode_mla(jqa, jqr, jc, jkr, jnp.asarray(pos),
                               jnp.asarray(t), scale=scale,
                               table=jnp.asarray(table), backend=jb,
                               c_scale=jcs, kr_scale=jkrs)
        got = ops.decode_mla(tqa, tqr, tc, tkr, torch.from_numpy(pos),
                             torch.from_numpy(t), scale=scale,
                             table=torch.from_numpy(table), backend=tb,
                             c_scale=tcs, kr_scale=tkrs)
        assert got.shape == (B, C, H, kvr) and got.dtype == torch.float32
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want, np.float32)[live],
                                   rtol=tol, atol=tol, err_msg=tb)
    counts = ops.launch_counts()
    assert counts["mla_paged"] == counts["mla_paged_chunk"] == 0


def test_mla_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the CUDA wrappers raise on CPU tensors."""
    rs = np.random.RandomState(0)
    c, kr, pos, t, table = mk_latent(rs, 2, 16, 8, 4, 2, 1, [3, 1])
    args = (torch.from_numpy(c), torch.from_numpy(kr),
            torch.from_numpy(pos))
    qa = torch.from_numpy(rs.randn(2, 1, 4, 16).astype(np.float32))
    qr = torch.from_numpy(rs.randn(2, 1, 4, 8).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        pa.mla_paged_cuda(qa[:, 0], qr[:, 0], *args,
                          torch.from_numpy(t[:, 0].copy()),
                          torch.from_numpy(table), scale=0.2)
    with pytest.raises(ValueError, match="CUDA"):
        pa.mla_paged_chunk_cuda(qa, qr, *args, torch.from_numpy(t),
                                torch.from_numpy(table), scale=0.2)
    assert pa.mla_paged_cuda.launches == 0
    assert pa.mla_paged_chunk_cuda.launches == 0


@pytest.mark.parametrize("arena,packed,jb,tb", [
    ("fp32", False, "xla", "gather"), ("fp32", True, "pallas", "cuda"),
    ("int8", True, "pallas", "cuda"), ("int8", False, "xla", "gather")])
def test_mla_layer_matches_the_reference(arena, packed, jb, tb):
    """Two slot-batched steps of one ``deepseek-v3-671b-smoke`` MLA layer
    (a C = 3 chunk with a pad token, then a decode token) in both
    packages on the same paged latent pool: outputs of live rows within
    1e-5 and the written arena (latents, int8 scales, positions) equal
    to the reference's. ``packed``: every projection int8, ``wukv``
    dequantized on read."""
    name = "deepseek-v3-671b-smoke"
    jcfg, tcfg = jget_config(name), get_config(name)
    jp = jmla.make_mla_params(jax.random.key(2), jcfg)
    if packed:
        from repro.config import QuantPolicy as JQuantPolicy
        from repro.core.quant.policy import quantize_tree as jquantize_tree
        from repro_torch.config import QuantPolicy
        jcfg = dataclasses.replace(jcfg, quant=JQuantPolicy(8, 0))
        tcfg = dataclasses.replace(tcfg, quant=QuantPolicy(8, 0))
        jp = jquantize_tree({"attn": jp}, JQuantPolicy(8, 0),
                            min_size=256)["attn"]
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    jdt = {"fp32": jnp.float32, "int8": jnp.int8}[arena]
    jc = jmla.init_mla_cache_paged(jcfg, 2, 16, 9, 4, jdt)
    tc = mla.init_mla_cache_paged(tcfg, 2, 16, 9, 4, dtype=ARENAS[arena])
    table = np.array([[7, 2, -1, -1], [0, 5, 3, -1]], np.int32)
    rs = np.random.RandomState(4)
    for t in ([[0, 1, 2], [0, 1, -1]], [[3], [2]], [[4], [-1]]):
        t = np.asarray(t, np.int32)
        x = rs.randn(2, t.shape[1], jcfg.d_model).astype(np.float32)
        want, jc = jmla.mla_decode_slots(jp, jnp.asarray(x), jc,
                                         jnp.asarray(t), jcfg,
                                         table=jnp.asarray(table),
                                         attn_backend=jb)
        got, tc = mla.mla_decode_slots(tp, torch.from_numpy(x), tc,
                                       torch.from_numpy(t), tcfg,
                                       table=torch.from_numpy(table),
                                       attn_backend=tb)
        live = t >= 0
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], rtol=1e-5,
                                   atol=1e-5)
        assert sorted(tc) == sorted(jc)
        for leaf in tc:
            w = np.asarray(jc[leaf])
            if leaf in ("pos", "k_rope", "c") and arena == "int8":
                np.testing.assert_array_equal(tc[leaf].numpy(), w)
            else:
                np.testing.assert_allclose(tc[leaf].float().numpy(), w,
                                           rtol=1e-6, atol=1e-6)


# ------------------------------------------- the tensor-core kernel's model


@pytest.mark.parametrize("arena", ["fp32", "bf16", "fp8", "int8", "fp16"])
def test_mla_route_is_by_dtype_and_width(arena):
    """bf16, fp16, fp8 and int8 arenas take the tensor-core kernel at
    latent widths that are multiples of 64 and rope widths that are
    multiples of 16 from 16, together at most 576 (deepseek-v3's 512 and
    64 among them); fp32 arenas and other widths the CUDA-core one."""
    dt = ARENAS[arena]
    want = "cuda_core" if arena == "fp32" else "tensor_core"
    for kvr, rope in ((512, 64), (64, 16), (256, 128), (128, 32),
                      (448, 128)):
        assert pa.mla_route(dt, kvr, rope) == want
    for kvr, rope in ((16, 8), (576, 64), (96, 64), (512, 8), (512, 0),
                      (512, 128), (512, 72), (448, 144)):
        assert pa.mla_route(dt, kvr, rope) == "cuda_core"
    # fp8 keeps the reference's per-block softmax in one CTA: block_len
    # 16 or 32, up to 2048 positions; the others split up to 16384
    for bl in (4, 8, 16, 32, 64):
        assert pa.mla_route(dt, 512, 64, bl) == (
            "cuda_core" if arena == "fp8" and bl not in (16, 32) else want)
    for positions in (160, 2048, 2049, 16384, 16385):
        longest = 2048 if arena == "fp8" else 16384
        assert pa.mla_route(dt, 512, 64, 16, positions) == (
            want if positions <= longest else "cuda_core")
        if pa.mla_route(dt, 512, 64, 16, positions) == "tensor_core":
            plan = pa.mla_split_plan(4, 128, positions // 16, 16,
                                     exact=arena == "fp8")
            assert plan.per <= pa.MLA_MAX_STEPS


def _shares(plan, split):
    """The steps that split ``split`` of ``plan`` walks (the kernel's
    s_begin = split * per)."""
    return range(split * plan.per, min(plan.steps, (split + 1) * plan.per))


@pytest.mark.parametrize("B,R,T,bl", [(4, 2048, 10, 16),   # served chunk
                                      (4, 2048, 128, 16),  # ... 2048 pos.
                                      (4, 128, 10, 16),    # decode, 160
                                      (4, 128, 16, 16),    # ... 256
                                      (4, 128, 128, 16),   # ... 2048
                                      (4, 120, 128, 16), (1, 8, 16, 4),
                                      (4, 24, 12, 4), (2, 128, 64, 32),
                                      (1, 16, 1, 5), (4, 48, 512, 16)])
def test_mla_split_plan_partitions_every_step_once(B, R, T, bl):
    """Every 32-position step of the table is walked by exactly one
    split; no split is empty, none walks more than MLA_MAX_STEPS, a
    split walk fits one cluster; the chunk's walk is one CTA a row tile
    of 64 rows where its CTAs fill the card, and the decode's walk
    spreads towards one CTA an SM."""
    plan = pa.mla_split_plan(B, R, T, bl)
    assert plan.steps == max(1, -(-(T * bl) // pa.MLA_STEP))
    assert plan.sub == pa.MLA_STEP
    walked = sorted(s for sp in range(plan.splits)
                    for s in _shares(plan, sp))
    assert walked == list(range(plan.steps))
    assert all(len(_shares(plan, sp)) for sp in range(plan.splits))
    assert plan.per <= pa.MLA_MAX_STEPS
    assert 1 <= plan.splits <= pa.MLA_MAX_SPLITS
    assert plan.stages in (2, 3) and (plan.stages == 2 or plan.per >= 3)
    ctas = B * -(-R // (pa.MLA_GROUP * plan.groups))
    if plan.groups == 4 and ctas >= pa.SMS // 2:
        assert plan.splits == -(-plan.steps // pa.MLA_MAX_STEPS)
    else:
        assert B * -(-R // 64) < pa.SMS // 2
        assert ctas * plan.splits <= pa.MLA_SPLIT_CTAS
    # the served shapes: the chunk in 128 CTAs of 64 rows, unsplit; the
    # decode split 5 ways at 160 positions, 8 at 256 and 2048
    if (B, R, T, bl) == (4, 2048, 10, 16):
        assert plan == pa.MlaPlan(4, 5, 1, 5, 3, 32)
    if (B, R, T, bl) == (4, 128, 10, 16):
        assert plan == pa.MlaPlan(2, 5, 5, 1, 2, 32)
    if (B, R, T, bl) == (4, 128, 16, 16):
        assert plan == pa.MlaPlan(4, 8, 8, 1, 2, 32)
    if (B, R, T, bl) == (4, 128, 128, 16):
        assert plan == pa.MlaPlan(4, 64, 8, 8, 3, 32)
    # fp8's walk: the reference's, one CTA a row tile, one update a block
    if bl in (16, 32) and plan.steps <= pa.MLA_MAX_STEPS:
        exact = pa.mla_split_plan(B, R, T, bl, exact=True)
        assert (exact.steps, exact.splits, exact.per, exact.sub) == (
            plan.steps, 1, plan.steps, bl)
    else:
        with pytest.raises(ValueError):
            pa.mla_split_plan(B, R, T, bl, exact=True)


def _mla_share(q, qr, cl, krl, posl, live, tq, steps, scale, cdt, sub):
    """One split of the tensor-core kernel: fp32 online softmax over its
    32-position steps (the score one (kvr + rope)-deep product, scaled
    after), one update every ``sub`` positions, p rounded to the compute
    dtype ``cdt`` into P . c; a step with no assigned position is
    skipped. Returns (m, l, acc) per (B, R)."""
    B, R, kvr = q.shape
    m = torch.full((B, R, 1), pa.NEG_INF)
    l = torch.zeros((B, R, 1))
    acc = torch.zeros((B, R, kvr))
    for step in steps:
        first = step * pa.MLA_STEP
        step_live = live[:, first:first + pa.MLA_STEP].any(-1)[:, None, None]
        for p0 in range(first, first + pa.MLA_STEP, sub):
            sl = slice(p0, p0 + sub)
            s = (torch.cat([q, qr], -1)
                 @ torch.cat([cl[:, sl], krl[:, sl]], -1).transpose(-1, -2))
            s = s * scale
            p_pos = posl[:, sl][:, None, :]
            ok = (p_pos >= 0) & (p_pos <= tq[:, :, None])
            s = torch.where(ok, s, torch.full_like(s, pa.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            m = torch.where(step_live, m_new, m)
            l = torch.where(step_live, l * corr + p.sum(-1, keepdim=True), l)
            acc = torch.where(step_live,
                              acc * corr + p.to(cdt).float() @ cl[:, sl],
                              acc)
    return m, l, acc


def _mla_tensor_core(qa, qr, c, kr, pos, t, table, scale, c_scale, kr_scale,
                     plan):
    """Plain model of the MLA tensor-core kernel on the partition of
    ``plan``: q_abs and q_rope rounded to the compute dtype, the arena
    read per logical position (int8 dequantized to bf16; unassigned
    positions zero and masked), each split walked on its own, then the
    splits' (m, l, acc) combined with exp(m_s - M) weights (a split with
    every position masked weighs 0). Returns o_lat (B, C, H, kvr)
    fp32."""
    B, C, H, kvr = qa.shape
    nb, bl = c.shape[:2]
    T = table.shape[1]
    cdt = pa.mla_compute_dtype(c.dtype)
    L = plan.steps * pa.MLA_STEP
    lpos = torch.arange(L)
    col = torch.clamp(lpos // bl, max=T - 1)
    blk = torch.where(lpos[None] < T * bl, table[:, col].long(),
                      torch.full((B, L), -1))
    live = blk >= 0
    idx = (blk.clamp(min=0) * bl + (lpos % bl)[None]).reshape(-1)

    def logical(a, sc):
        rows = pa.take_blocks(a.reshape(nb * bl, a.shape[-1]), idx)
        if sc is not None:
            rows = pa.dequantize_kv(rows, sc.reshape(-1)[idx])
        rows = rows.float().reshape(B, L, a.shape[-1])
        return torch.where(live[..., None], rows, torch.zeros(()))
    cl, krl = logical(c, c_scale), logical(kr, kr_scale)
    posl = pos.new_full((B, L), -1)
    posl[:, :T * bl] = torch.where(live[:, :T * bl], pos,
                                   torch.full_like(pos, -1))
    q = qa.reshape(B, C * H, kvr).to(cdt).float()
    qrr = qr.reshape(B, C * H, qr.shape[-1]).to(cdt).float()
    tq = t.repeat_interleave(H, dim=1)
    parts = [_mla_share(q, qrr, cl, krl, posl, live, tq,
                        _shares(plan, sp), scale, cdt, plan.sub)
             for sp in range(plan.splits)]
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
    acc = sum(wi * ai for wi, (_, _, ai) in zip(w, parts))
    return (acc / torch.clamp_min(l, 1e-30)).reshape(B, C, H, kvr)


# (arena, C, T, bl): the decode split over 8 CTAs of one step (256
# positions, block_len 16), a step gathering 8 blocks (block_len 4); fp8
# walks as the reference does (one CTA, one update a block of 16 or 32)
MODEL_CASES = [(arena, C, T, bl) for arena in ("bf16", "fp8", "int8", "fp16")
               for C in (1, 3)
               for T, bl in ((16, 16), (4, 32) if arena == "fp8" else (24, 4))]


@pytest.mark.parametrize("arena,C,T,bl", MODEL_CASES)
def test_tensor_core_mla_model_matches_jax_pallas_kernel(arena, C, T, bl):
    """The MLA tensor-core kernel's arithmetic (cdt-rounded q and p, a
    per-step online softmax on ``mla_split_plan``'s partition, per-split
    partials and their combine) against the JAX Pallas kernels
    (``mla_paged_p`` at C == 1, ``mla_paged_chunk_p`` at C > 1) in
    interpret mode at ATTN_TOL on live rows: a poisoned arena, blocks
    handed out of order, a table hole, pad rows, and splits whose
    positions are all masked (an assigned step whose positions are not
    written yet; a chunk token's later positions). C > 1 is also held on
    one split, as the served chunk walks."""
    rs = np.random.RandomState(T * 10 + bl + C + len(arena))
    B, H, kvr, rd = 4, 8, 64, 16
    fills = [T * bl - C, bl - 1, 31, 2 * pa.MLA_STEP - 1]
    c, kr, pos, t, table = mk_latent(rs, B, kvr, rd, bl, T, C, fills,
                                     holes=((0, 1),))
    # row 0's third step: assigned blocks whose positions are unwritten
    step = slice(2 * pa.MLA_STEP, 3 * pa.MLA_STEP)
    assert (table[0, step.start // bl:step.stop // bl] >= 0).all()
    pos[0, step] = pa.EMPTY_POS
    t[3, 1:] = -1
    if C == 1:
        t[2] = -1
    qa = rs.randn(B, C, H, kvr).astype(np.float32)
    qr = rs.randn(B, C, H, rd).astype(np.float32)
    scale = (kvr + rd) ** -0.5
    jc, jkr, jcs, jkrs = _jax_latent(c, kr, arena)
    tc, tkr, tcs, tkrs = _torch_latent(c, kr, arena)
    assert pa.mla_route(tc.dtype, kvr, rd, bl) == "tensor_core"
    want = np.asarray(jops.decode_mla(
        jnp.asarray(qa).astype(jnp.bfloat16),
        jnp.asarray(qr).astype(jnp.bfloat16), jc, jkr, jnp.asarray(pos),
        jnp.asarray(t), scale=scale, table=jnp.asarray(table),
        backend="pallas", c_scale=jcs, kr_scale=jkrs), np.float32)
    exact = arena == "fp8"
    plan = pa.mla_split_plan(B, C * H, T, bl, exact=exact)
    assert (plan.splits == 1) == exact
    plans = [plan] + ([plan._replace(splits=1, per=plan.steps)]
                      if C > 1 and not exact else [])
    args = (torch.from_numpy(qa).bfloat16(), torch.from_numpy(qr).bfloat16(),
            tc, tkr, torch.from_numpy(pos), torch.from_numpy(t),
            torch.from_numpy(table), scale, tcs, tkrs)
    live = t >= 0
    tol = ATTN_TOL[arena]
    for p in plans:
        got = _mla_tensor_core(*args, p)
        assert got.shape == (B, C, H, kvr)
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy()[live], want[live], rtol=tol,
                                   atol=tol, err_msg=str(p))
