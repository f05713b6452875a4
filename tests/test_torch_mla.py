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
