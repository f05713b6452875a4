"""Card-only tests of the port's CUDA kernels (``-m gpu``; they skip
without a card). This file imports neither JAX nor the JAX package, so
it runs on a GPU machine that has only the port's requirements:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

``mk_arena`` (numpy only) builds the paged-attention inputs that the
CPU parity tests share.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quant.policy import quantize_tensor
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import qconv1d, qmatmul, ref

ARENAS = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp8": torch.float8_e4m3fn, "int8": torch.int8}
# the reference tests' tolerances: fp32 attention 1e-5; bf16, fp8 and
# int8 arenas (bf16 compute) and qmatmul 2e-2
ATTN_TOL = {"fp32": 1e-5, "bf16": 2e-2, "fp8": 2e-2, "int8": 2e-2}


def mk_arena(rs, B, Hkv, hd, bl, T, C, fills, *, poison=99.0, holes=()):
    """A paged KV state as the attention read sees it mid-tick: row b has
    positions ``[0, fills[b] + C)`` written (its C query tokens last,
    ``t[b] = fills[b] + arange(C)``) in arena blocks handed out in random
    order; every unwritten byte is ``poison`` (a recycled arena's stale
    KV). ``holes`` lists (b, j) table entries punched back to -1, their
    positions emptied as the pool's lockstep pos write does. Returns
    numpy (k, v, pos, t, table) with fp32 arenas (n_blocks, bl, Hkv,
    hd), n_blocks = B * T + 3."""
    n_blocks = B * T + 3
    Leff = T * bl
    k = np.full((n_blocks, bl, Hkv, hd), poison, np.float32)
    v = np.full((n_blocks, bl, Hkv, hd), poison, np.float32)
    table = np.full((B, T), -1, np.int32)
    pos = np.full((B, Leff), pa.EMPTY_POS, np.int32)
    free = list(rs.permutation(n_blocks))
    t = np.zeros((B, C), np.int32)
    for b in range(B):
        n = fills[b]
        assert n + C <= Leff
        t[b] = np.arange(n, n + C)
        for j in range(-(-(n + C) // bl)):
            table[b, j] = free.pop()
        for p in range(n + C):
            blk, off = table[b, p // bl], p % bl
            k[blk, off] = rs.randn(Hkv, hd)
            v[blk, off] = rs.randn(Hkv, hd)
            pos[b, p] = p
    for b, j in holes:
        table[b, j] = -1
        pos[b, j * bl:(j + 1) * bl] = pa.EMPTY_POS
    return k, v, pos, t, table


def arena_as(k, v, arena: str, device="cpu"):
    """fp32 numpy arenas -> torch arenas of the named storage mode (int8
    with its fp32 scale arenas, quantized per token per KV head)."""
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if arena == "int8":
        (kq, ks), (vq, vs) = pa.quantize_kv(kt), pa.quantize_kv(vt)
        return tuple(a.to(device) for a in (kq, vq, ks, vs))
    dt = ARENAS[arena]
    return kt.to(dt).to(device), vt.to(dt).to(device), None, None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-3, 1e-3)),
                                       (torch.bfloat16, (2 ** -7, 1e-2))])
@pytest.mark.parametrize("T,k", [(2500, 75), (1001, 25), (37, 5)])
def test_cuda_kernel_matches_plain_version(T, k, dtype, tol):
    """On a card: the CUDA kernel against its plain version at C=344,
    ragged T, both ReLU settings; each wrapper call counts one launch.
    bf16 tolerance: one bf16 ulp (both round an fp32 sum to bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rs = np.random.RandomState(k)
    C = 344
    xp = torch.from_numpy(rs.randn(3, T + k - 1, C).astype(np.float32))
    dw = quantize_tensor(torch.from_numpy(rs.randn(k, C).astype(np.float32)), 8)
    pw = quantize_tensor(torch.from_numpy(rs.randn(C, C).astype(np.float32)), 8)
    g = torch.from_numpy(rs.rand(1, C).astype(np.float32))
    b = torch.from_numpy(rs.randn(1, C).astype(np.float32))
    args = [t.cuda() for t in (xp.to(dtype), dw.data, pw.data, dw.scale,
                               pw.scale, g, b)]
    before = qconv1d.qconv1d_block_cuda.launches
    for relu in (True, False):
        got = qconv1d.qconv1d_block_cuda(*args, relu=relu)
        want = ref.qconv1d_block_ref(*args, relu=relu)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (3, T, C)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=tol[0], atol=tol[1])
    assert qconv1d.qconv1d_block_cuda.launches == before + 2


@pytest.mark.gpu
def test_served_forward_launches_the_kernel_per_fused_block():
    """On a card: a served rubicall-smoke read with every block packed at
    8 bits goes through the CUDA kernel on the three fused blocks
    (01-03) of every forward, and finishes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dataclasses import replace

    from repro_torch.config import QuantPolicy, get_config
    from repro_torch.core.quant.policy import quantize_tree
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serving.engine import Request
    cfg = replace(get_config("rubicall-smoke"), quant=QuantPolicy(8, 8))
    params = quantize_tree(api.init_params(torch.Generator().manual_seed(0),
                                           cfg), QuantPolicy(8, 0),
                           min_size=1)
    eng = api.make_serving_engine(params, cfg, n_slots=2, chunk_samples=300)
    ops.reset_launch_counts()
    for i in range(3):
        eng.submit(Request(rid=i, signal=np.random.RandomState(i).randn(
            700).astype(np.float32)))
    done = eng.run()
    s = eng.metrics.summary()
    assert all(r.status == "finished" for r in done.values())
    assert ops.launch_counts()["qconv1d_block"] == \
        3 * (s["bucket_hits"] + s["bucket_misses"])


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(4, 2560, 2560), (64, 2560, 6912),
                                   (4, 6912, 2560), (4, 2560, 151936),
                                   (5, 37, 50), (130, 301, 200)])
def test_cuda_qmatmul_matches_plain_version(M, K, N, dtype, bits):
    """On a card: the qmatmul kernel against its plain version at every
    qwen1.5-4b projection shape and ragged M/N/K (odd K: the int4 pad
    row), tolerance 2e-2; each wrapper call counts one launch."""
    _cuda()
    rs = np.random.RandomState(M + K + N + bits)
    w = quantize_tensor(torch.from_numpy(rs.randn(K, N).astype(np.float32)),
                        bits)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).to("cuda", dtype)
    wq, sc = w.data.cuda(), w.scale.cuda()
    before = qmatmul.qmatmul_cuda.launches
    got = qmatmul.qmatmul_cuda(x, wq, sc, bits=bits)
    want = ref.qmatmul_ref(x, wq, sc, bits=bits)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert qmatmul.qmatmul_cuda.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("arena", list(ARENAS))
@pytest.mark.parametrize("Hkv,group,C,window", [(20, 1, 1, 0), (2, 16, 1, 0),
                                                (20, 1, 16, 0),
                                                (2, 16, 4, 0),
                                                (2, 16, 16, 0),
                                                (4, 2, 4, 24)])
def test_cuda_gqa_paged_matches_plain_version(Hkv, group, C, window, arena):
    """On a card: the paged-attention kernel (C == 1 decode, C > 1
    chunk) against its plain version at qwen1.5-4b's heads (20 x 128,
    group 1) and chatglm3-6b's (2 KV heads, group 16), block_len 16, a
    poisoned arena with blocks handed out of order, a table hole, pad
    rows and a ring window; live rows at the reference tolerances."""
    _cuda()
    rs = np.random.RandomState(Hkv * 7 + group + C + window)
    B, hd, bl, T = 4, 128, 16, 16
    fills = [T * bl - C, bl - 1, 0, 37]
    k, v, pos, t, table = mk_arena(rs, B, Hkv, hd, bl, T, C, fills,
                                   holes=[(0, 5)])
    t[3, 1:] = -1                            # a decode row in a mixed tick
    if C == 1:
        t[2] = -1                            # a free slot
    kd, vd, ks, vs = arena_as(k, v, arena, "cuda")
    dev = dict(device="cuda")
    pos_d, t_d, tb_d = (torch.from_numpy(a).to(**dev)
                        for a in (pos, t, table))
    H = Hkv * group
    q = torch.from_numpy(rs.randn(B, C, H, hd).astype(np.float32)).to(
        "cuda", torch.bfloat16 if arena != "fp32" else torch.float32)
    kw = dict(window=window, k_scale=ks, v_scale=vs)
    if C == 1:
        qh = q.reshape(B, Hkv, group, hd)
        got = pa.gqa_paged_cuda(qh, kd, vd, pos_d, t_d[:, 0].contiguous(),
                                tb_d, **kw).reshape(B, 1, H * hd)
        want = ref.gqa_paged_ref(qh, kd, vd, pos_d, t_d[:, 0], tb_d,
                                 **kw).reshape(B, 1, H * hd)
    else:
        got = pa.gqa_paged_chunk_cuda(q, kd, vd, pos_d, t_d, tb_d, **kw)
        want = ref.gqa_paged_chunk_ref(q, kd, vd, pos_d, t_d, tb_d, **kw)
    torch.cuda.synchronize()
    assert got.shape == (B, C, H * hd) and got.dtype == q.dtype
    assert bool(torch.isfinite(got).all())
    live = torch.from_numpy(t >= 0).cuda()
    tol = ATTN_TOL[arena]
    torch.testing.assert_close(got.float()[live], want.float()[live],
                               rtol=tol, atol=tol)
