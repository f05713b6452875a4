"""Card-only tests of the port's CUDA kernels (qconv1d, qmatmul, the GQA
and MLA paged attention, flash attention and the SSD scan; ``-m gpu``;
they skip without a card). This file imports neither JAX nor the JAX package, so
it runs on a GPU machine that has only the port's requirements:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

``mk_arena`` and ``mk_latent`` (numpy only) build the paged-attention
inputs that the CPU parity tests share.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quant.policy import quantize_tensor
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import qconv1d, qmatmul, ref
from repro_torch.kernels import ssd_scan

ARENAS = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "fp8": torch.float8_e4m3fn, "int8": torch.int8,
          "fp16": torch.float16}
# the reference tests' tolerances: fp32 attention 1e-5; bf16, fp8 and
# int8 arenas (bf16 compute), fp16 arenas (fp16 compute) and qmatmul 2e-2
ATTN_TOL = {"fp32": 1e-5, "bf16": 2e-2, "fp8": 2e-2, "int8": 2e-2,
            "fp16": 2e-2}


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


def mk_latent(rs, B, kvr, rd, bl, T, C, fills, *, holes=()):
    """:func:`mk_arena` for MLA's latent arenas: numpy (c, k_rope, pos,
    t, table) with fp32 c (n_blocks, bl, kvr) and k_rope (n_blocks, bl,
    rd), poisoned where unwritten."""
    k, _, pos, t, table = mk_arena(rs, B, 1, kvr + rd, bl, T, C, fills,
                                   holes=holes)
    return (np.ascontiguousarray(k[:, :, 0, :kvr]),
            np.ascontiguousarray(k[:, :, 0, kvr:]), pos, t, table)


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
@pytest.mark.parametrize("T,k,C", [(2500, 75, 344), (1001, 25, 344),
                                   (37, 5, 344),
                                   (20, 75, 344),     # halo wider than T
                                   (129, 31, 96),     # a half-width slab
                                   (300, 9, 100)])    # C % 8: CUDA cores
def test_cuda_kernel_matches_plain_version(T, k, C, dtype, tol):
    """On a card: the CUDA kernel on the unpadded window against its
    plain version on the padded one, ragged T, T < k, both ReLU
    settings; each wrapper call counts one launch on the route its dtype
    and shape take (bf16 at C % 8 == 0 on tensor cores). bf16
    tolerance: one bf16 ulp (both round an fp32 sum to bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rs = np.random.RandomState(k + C)
    x = torch.from_numpy(rs.randn(3, T, C).astype(np.float32))
    dw = quantize_tensor(torch.from_numpy(rs.randn(k, C).astype(np.float32)), 8)
    pw = quantize_tensor(torch.from_numpy(rs.randn(C, C).astype(np.float32)), 8)
    g = torch.from_numpy(rs.rand(1, C).astype(np.float32))
    b = torch.from_numpy(rs.randn(1, C).astype(np.float32))
    args = [t.cuda() for t in (x.to(dtype), dw.data, pw.data, dw.scale,
                               pw.scale, g, b)]
    pad = (k - 1) // 2
    xp = torch.nn.functional.pad(args[0], (0, 0, pad, k - 1 - pad))
    route = qconv1d.route(dtype, C, k)
    assert route == ("tensor_core" if dtype == torch.bfloat16 and C % 8 == 0
                     else "cuda_core")
    before = qconv1d.qconv1d_block_cuda.launches
    routes = dict(qconv1d.qconv1d_block_cuda.routes)
    for relu in (True, False):
        got = qconv1d.qconv1d_block_cuda(*args, relu=relu)
        want = ref.qconv1d_block_ref(xp, *args[1:], relu=relu)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (3, T, C)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=tol[0], atol=tol[1])
    assert qconv1d.qconv1d_block_cuda.launches == before + 2
    assert qconv1d.qconv1d_block_cuda.routes == {**routes,
                                                 route: routes[route] + 2}


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
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(4, 2560, 2560), (64, 2560, 2560),
                                   (64, 2560, 6912), (64, 6912, 2560),
                                   (64, 2560, 151936), (16, 7168, 256),
                                   (1, 64, 16), (33, 777, 136),
                                   (65, 520, 272), (200, 96, 48)])
def test_cuda_qmatmul_routes_and_values(M, K, N, dtype, bits):
    """On a card: each call takes the route ``qmatmul.route`` names
    (bf16 on tensor cores at the decode's M = 4, the mixed tick's M = 64
    and ragged M/N/K, fp32 on CUDA cores), counted once on that route,
    and matches the plain version at 2e-2."""
    _cuda()
    rs = np.random.RandomState(M + K + N + bits + 1)
    w = quantize_tensor(torch.from_numpy(rs.randn(K, N).astype(np.float32)),
                        bits)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).to("cuda", dtype)
    wq, sc = w.data.cuda(), w.scale.cuda()
    route = qmatmul.route(dtype, M)
    assert route == ("tensor_core" if dtype == torch.bfloat16
                     else "cuda_core")
    before = dict(qmatmul.qmatmul_cuda.routes)
    got = qmatmul.qmatmul_cuda(x, wq, sc, bits=bits)
    want = ref.qmatmul_ref(x, wq, sc, bits=bits)
    torch.cuda.synchronize()
    assert qmatmul.qmatmul_cuda.routes == {**before,
                                           route: before[route] + 1}
    assert got.shape == (M, N) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["tensor_core", "cuda_core"])
@pytest.mark.parametrize("M", [4, 64])
def test_cuda_qmatmul_bf16_on_either_route(M, path):
    """bf16 x on either kernel when the route is named (the timing rows
    of chip_smoke.py compare both), 2e-2 against the plain version; the
    tensor-core kernel refuses fp32 x."""
    _cuda()
    rs = np.random.RandomState(M)
    w = quantize_tensor(torch.from_numpy(rs.randn(2560, 6912).astype(
        np.float32)), 8)
    x = torch.from_numpy(rs.randn(M, 2560).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    wq, sc = w.data.cuda(), w.scale.cuda()
    before = dict(qmatmul.qmatmul_cuda.routes)
    got = qmatmul.qmatmul_cuda(x, wq, sc, path=path)
    want = ref.qmatmul_ref(x, wq, sc)
    torch.cuda.synchronize()
    assert qmatmul.qmatmul_cuda.routes == {**before, path: before[path] + 1}
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    with pytest.raises(TypeError, match="bf16"):
        qmatmul.qmatmul_cuda(x.float(), wq, sc, path="tensor_core")


@pytest.mark.gpu
@pytest.mark.parametrize("arena", list(ARENAS))
@pytest.mark.parametrize("Hkv,group,C,window,bl,T", [
    (20, 1, 1, 0, 16, 16), (2, 16, 1, 0, 16, 16), (20, 1, 16, 0, 16, 16),
    (2, 16, 4, 0, 16, 16), (2, 16, 16, 0, 16, 16), (4, 2, 4, 24, 16, 16),
    (20, 1, 16, 0, 16, 128),                 # 2048 positions: split across CTAs
    (20, 1, 1, 0, 16, 128), (2, 16, 1, 8, 16, 128),   # 2048, decode
    (4, 2, 4, 0, 4, 16), (2, 16, 16, 0, 32, 16)])   # block_len 4 and 32
def test_cuda_gqa_paged_matches_plain_version(Hkv, group, C, window, bl, T,
                                              arena):
    """On a card: the paged-attention kernels (C == 1 decode and C > 1
    chunk, on tensor cores for bf16, fp8, int8 and fp16 arenas) against
    their plain version at qwen1.5-4b's heads (20 x 128, group 1) and
    chatglm3-6b's (2 KV heads, group 16), block_len 4, 16 and 32, 256
    and 2048 positions, a poisoned arena with blocks handed out of
    order, a table hole, pad rows and a ring window; live rows at the
    reference tolerances; each call counts one launch on the route
    its dtype and shape take."""
    _cuda()
    rs = np.random.RandomState(Hkv * 7 + group + C + window + bl + T)
    B, hd = 4, 128
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
    fn = pa.gqa_paged_cuda if C == 1 else pa.gqa_paged_chunk_cuda
    route = "tensor_core" if arena != "fp32" else "cuda_core"
    before = dict(fn.routes)
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
    assert fn.routes == {**before, route: before[route] + 1}


def _mla_case(H, kvr, rd, bl, T, C, arena, qdt=None):
    """One MLA kernel call (C == 1 decode, C > 1 chunk) against its plain
    version on a poisoned latent arena with blocks handed out of order,
    a table hole and pad rows; live rows at the reference tolerances;
    the call counts one launch, on the route ``mla_route`` names. q in
    ``qdt`` (default: fp32 over fp32 arenas, else bf16)."""
    rs = np.random.RandomState(H + kvr + C + T + bl)
    B = 4
    fills = [T * bl - C, bl - 1, 0, 37 % (T * bl - C)]
    c, kr, pos, t, table = mk_latent(rs, B, kvr, rd, bl, T, C, fills,
                                     holes=[(0, 5)])
    t[3, 1:] = -1
    if C == 1:
        t[2] = -1
    cd, krd, cs, krs = arena_as(c, kr, arena, "cuda")
    pos_d, t_d, tb_d = (torch.from_numpy(a).cuda() for a in (pos, t, table))
    qdt = qdt or (torch.float32 if arena == "fp32" else torch.bfloat16)
    qa = torch.from_numpy(rs.randn(B, C, H, kvr).astype(np.float32)).to(
        "cuda", qdt)
    qr = torch.from_numpy(rs.randn(B, C, H, rd).astype(np.float32)).to(
        "cuda", qdt)
    kw = dict(scale=(128 + rd) ** -0.5, c_scale=cs, kr_scale=krs)
    fn = pa.mla_paged_cuda if C == 1 else pa.mla_paged_chunk_cuda
    route = pa.mla_route(cd.dtype, kvr, rd, bl, T * bl)
    before, routes = fn.launches, dict(fn.routes)
    if C == 1:
        args = (qa[:, 0].contiguous(), qr[:, 0].contiguous(), cd, krd,
                pos_d, t_d[:, 0].contiguous(), tb_d)
        got = fn(*args, **kw)[:, None]
        want = ref.mla_paged_ref(*args, **kw)[:, None]
    else:
        got = fn(qa, qr, cd, krd, pos_d, t_d, tb_d, **kw)
        want = ref.mla_paged_chunk_ref(qa, qr, cd, krd, pos_d, t_d, tb_d,
                                       **kw)
    torch.cuda.synchronize()
    assert got.shape == (B, C, H, kvr) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert fn.launches == before + 1
    assert fn.routes == {**routes, route: routes[route] + 1}
    live = torch.from_numpy(t >= 0).cuda()
    tol = ATTN_TOL[arena]
    torch.testing.assert_close(got[live], want[live], rtol=tol, atol=tol)
    return route


@pytest.mark.gpu
@pytest.mark.parametrize("arena", list(ARENAS))
@pytest.mark.parametrize("H,kvr,rd,bl,C", [(128, 512, 64, 16, 1),
                                           (128, 512, 64, 16, 16),
                                           (4, 16, 8, 4, 3)])
def test_cuda_mla_paged_matches_plain_version(H, kvr, rd, bl, C, arena):
    """On a card: the MLA kernels (C == 1 decode, C > 1 chunk) against
    their plain version at deepseek-v3's widths (128 heads, latent 512,
    rope 64, block_len 16) and a small ragged shape, a poisoned arena
    with blocks handed out of order, a table hole and pad rows; live rows
    at the reference tolerances; each wrapper call counts one launch on
    the route ``mla_route`` names: at deepseek's widths the tensor-core
    kernel over every arena but fp32."""
    _cuda()
    route = _mla_case(H, kvr, rd, bl, 16, C, arena)
    if kvr == 512:
        assert route == ("cuda_core" if arena == "fp32" else "tensor_core")


@pytest.mark.gpu
@pytest.mark.parametrize("arena", list(ARENAS))
@pytest.mark.parametrize("H,kvr,rd,bl,T,C", [
    (128, 512, 64, 16, 128, 1),     # 2048 positions: the decode splits
    (128, 512, 64, 16, 128, 16),    # the chunk walks 64 steps in one CTA
    (128, 512, 64, 4, 64, 1),       # block_len 4: 8 blocks a step
    (128, 512, 64, 32, 8, 16),      # block_len 32: one block a step
    (40, 512, 64, 16, 16, 3),       # R = 120: a ragged row tile
    (40, 512, 64, 32, 64, 1),       # R = 40, 2048 positions, split
    (16, 256, 32, 16, 10, 2)])      # narrower widths, R = 32
def test_cuda_mla_tensor_core_long_tables_and_ragged_rows(H, kvr, rd, bl, T,
                                                          C, arena):
    """On a card: the MLA kernels at 2048 positions (the decode's walk
    split across a cluster, the chunk's 64 steps in one CTA), block_len 4
    and 32, ragged row tiles and narrower widths, against their plain
    version as ``test_cuda_mla_paged_matches_plain_version`` holds them;
    fp8 at block_len 4 takes the CUDA-core kernel."""
    _cuda()
    route = _mla_case(H, kvr, rd, bl, T, C, arena)
    assert route == ("cuda_core" if arena == "fp32" or (
        arena == "fp8" and bl not in (16, 32)) else "tensor_core")


@pytest.mark.gpu
@pytest.mark.parametrize("arena", ["bf16", "fp8", "int8", "fp16"])
@pytest.mark.parametrize("C", [1, 16])
def test_cuda_mla_tensor_core_takes_fp32_queries(C, arena):
    """On a card: fp32 q_abs and q_rope (``decode_mla`` widens both when
    their dtypes differ) over every tensor-core arena at deepseek-v3's
    widths, rounded to the compute dtype in the kernel as in the plain
    version, at the reference tolerance."""
    _cuda()
    assert _mla_case(128, 512, 64, 16, 16, C, arena,
                     qdt=torch.float32) == "tensor_core"


# bf16 outputs: the kernel and its plain version both round an fp32 sum
# to bf16 in other summation orders, so they may differ by one bf16 ulp
# (at most 2^-7 relative); atol covers fp32 order noise near zero
BF16_ULP = (2 ** -7, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,d,causal", [
    (2, 512, 512, 20, 20, 128, True),        # qwen1.5-4b's heads
    (2, 512, 512, 20, 20, 128, False),
    (2, 333, 333, 16, 2, 128, True),         # GQA group 8, ragged S
    (1, 200, 77, 8, 1, 64, False),           # Sq != Sk, d 64
    (1, 130, 130, 4, 2, 64, True),
    (2, 40, 40, 4, 2, 16, True),             # smoke width: d padded to 64
    (1, 100, 100, 4, 4, 80, False),          # d padded to 128
    (1, 2048, 2048, 4, 4, 128, True),        # a long prompt
    (1, 129, 129, 4, 4, 128, True)])         # one row past a 128-row tile
def test_cuda_flash_attention_matches_plain_version(B, Sq, Sk, H, Hkv, d,
                                                    causal, dtype):
    """On a card: the flash-attention kernel against its plain version,
    causal and not, GQA by index, ragged lengths; fp32 at the reference
    test's 1e-4, bf16 at one bf16 ulp; each call counts one launch, bf16
    on the tensor-core route and fp32 on the CUDA-core one."""
    _cuda()
    rs = np.random.RandomState(Sq + Sk + H + d)
    q, k, v = (torch.from_numpy(rs.randn(B, S, h, d).astype(np.float32)).to(
        "cuda", dtype) for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))
    before = fa.flash_attention_cuda.launches
    routes = dict(fa.flash_attention_cuda.routes)
    route = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    want = ref.flash_attention_gqa_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == (B, Sq, H, d) and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    assert fa.flash_attention_cuda.launches == before + 1
    assert fa.flash_attention_cuda.routes == {**routes,
                                              route: routes[route] + 1}
    rtol, atol = (1e-4, 1e-4) if dtype == torch.float32 else BF16_ULP
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hd,N,chunk", [
    (2, 2048, 24, 64, 128, 256),             # mamba2-130m's heads
    (2, 2000, 24, 64, 128, 256),             # ragged: 256 does not divide
    (2, 256, 2, 32, 16, 64),                 # tests/test_kernels.py shapes
    (2, 512, 4, 64, 32, 128),
    (1, 77, 1, 32, 4, 256),
    (2, 40, 8, 16, 16, 32),                  # smoke width: hd padded to 32
    (1, 100, 3, 48, 6, 64)])                 # hd to 64, N to 8
def test_cuda_ssd_scan_matches_plain_version(B, S, nh, hd, N, chunk, dtype):
    """On a card: the SSD kernel against its plain version (the chunked
    algorithm), y and the final state; A spans mamba2's -1..-16 so the
    decay sums grow large; fp32 at the reference test's 5e-3, bf16 y at
    one bf16 ulp (atol 1e-3 for fp32 order noise on |y| up to ~50), the
    fp32 state at 5e-3; each call counts one launch."""
    _cuda()
    rs = np.random.RandomState(S + nh + N)
    x = torch.from_numpy(rs.randn(B, S, nh, hd).astype(np.float32))
    dt = torch.from_numpy((rs.rand(B, S, nh) * 0.1).astype(np.float32))
    A = -torch.linspace(1.0, 16.0, nh)
    Bm = torch.from_numpy(rs.randn(B, S, N).astype(np.float32))
    Cm = torch.from_numpy(rs.randn(B, S, N).astype(np.float32))
    D = torch.from_numpy(rs.rand(nh).astype(np.float32) + 0.5)
    x, Bm, Cm = (a.to("cuda", dtype) for a in (x, Bm, Cm))
    dt, A, D = (a.cuda() for a in (dt, A, D))
    before = ssd_scan.ssd_scan_cuda.launches
    y, h = ssd_scan.ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk=chunk)
    wy, wh = ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk)
    torch.cuda.synchronize()
    assert y.shape == (B, S, nh, hd) and y.dtype == dtype
    assert h.shape == (B, nh, hd, N) and h.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    assert ssd_scan.ssd_scan_cuda.launches == before + 1
    rtol, atol = ((5e-3, 5e-3) if dtype == torch.float32
                  else (BF16_ULP[0], 1e-3))
    torch.testing.assert_close(y.float(), wy.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(h, wh, rtol=5e-3, atol=5e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hd,N", [
    (4, 2048, 24, 64, 128),                  # mamba2-130m's prefill
    (2, 2000, 24, 64, 128),                  # ragged last chunk
    (1, 128, 5, 64, 128),                    # one chunk; heads not of 4
    (1, 129, 3, 64, 64),                     # 128 + 1 positions
    (2, 256, 2, 32, 16),                     # padded to 64 and 64
    (2, 40, 8, 16, 16),
    (1, 100, 3, 48, 6),
    (1, 77, 2, 128, 128)])                   # hd 128: CUDA cores
def test_cuda_ssd_scan_routes_and_values(B, S, nh, hd, N, dtype):
    """On a card: each call takes the route ``ssd_scan.route`` names
    (bf16 on the tensor-core state and chunk passes up to hd 64 and N
    128, fp32 and wider on the CUDA-core walk), counted once on that
    route, with y and the final state at the plain version's existing
    tolerances (fp32 5e-3; bf16 y one bf16 ulp with atol 1e-3; state
    5e-3)."""
    _cuda()
    rs = np.random.RandomState(B + S + nh + hd + N)
    x = torch.from_numpy(rs.randn(B, S, nh, hd).astype(np.float32))
    dt = torch.from_numpy((rs.rand(B, S, nh) * 0.1).astype(np.float32))
    A = -torch.linspace(1.0, 16.0, nh)
    Bm = torch.from_numpy(rs.randn(B, S, N).astype(np.float32))
    Cm = torch.from_numpy(rs.randn(B, S, N).astype(np.float32))
    D = torch.from_numpy(rs.rand(nh).astype(np.float32) + 0.5)
    x, Bm, Cm = (a.to("cuda", dtype) for a in (x, Bm, Cm))
    dt, A, D = (a.cuda() for a in (dt, A, D))
    route = ssd_scan.route(dtype, hd, N)
    assert (route == "tensor_core") == (dtype == torch.bfloat16
                                        and hd <= 64)
    before = dict(ssd_scan.ssd_scan_cuda.routes)
    y, h = ssd_scan.ssd_scan_cuda(x, dt, A, Bm, Cm, D, chunk=256)
    wy, wh = ref.ssd_chunked(x, dt, A, Bm, Cm, D, 256)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_scan_cuda.routes == {**before,
                                             route: before[route] + 1}
    assert y.shape == (B, S, nh, hd) and h.shape == (B, nh, hd, N)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    rtol, atol = ((5e-3, 5e-3) if dtype == torch.float32
                  else (BF16_ULP[0], 1e-3))
    torch.testing.assert_close(y.float(), wy.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(h, wh, rtol=5e-3, atol=5e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-130m-smoke", "qwen1.5-4b-smoke"])
def test_cuda_static_prefill_matches_the_cpu_path(arch):
    """On a card: the static path at smoke width (the kernels through
    their padded head dims) against the same prefill and decode steps on
    the CPU (plain versions), fp32: logits and every cache leaf at 1e-4;
    the prefill launches the slice's kernel once per layer."""
    _cuda()
    from repro_torch.config import get_config
    from repro_torch.core.quant.policy import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.lm import transformer as tfm
    cfg = get_config(arch)
    params = api.init_params(0, cfg, device="cpu")
    tok = torch.from_numpy(np.random.RandomState(0).randint(
        1, cfg.vocab_size, (2, 45)).astype(np.int32))
    out = []
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        ops.reset_launch_counts()
        with torch.no_grad():
            logits, caches = tfm.prefill(p, tok.to(dev), cfg, cache_len=48,
                                         cache_dtype=torch.float32)
            counts = {k: c for k, c in ops.launch_counts().items() if c}
            nxt = logits.argmax(-1).to(torch.int32)
            step, caches = tfm.decode_step(p, caches, nxt, 45, cfg)
        out.append((logits.cpu(), step.cpu(), caches, counts))
    (lc, sc, cc, _), (lg, sg, cg, counts) = out
    kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    assert counts == {kernel: cfg.n_layers}
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sg, sc, rtol=1e-4, atol=1e-4)
    for g, tree in cc.items():
        for name, want in tree.items():
            torch.testing.assert_close(cg[g][name].cpu(), want, rtol=1e-4,
                                       atol=1e-4)
