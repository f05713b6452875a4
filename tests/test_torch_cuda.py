"""Card-only tests of the port's CUDA kernels (qconv1d, qmatmul, the GQA
and MLA paged attention, flash attention and the SSD scan) and of
training on the card (the CTC loss, a train step, checkpoints, the
packed identity gate, the LM training forward's gradients and the
prefill kernels' refusal of inputs that require grad), the contiguous
layouts of ``decode_gqa`` and ``decode_mla`` and the audio runner's
staging; ``-m gpu``;
they skip without a card. This
file imports neither JAX nor the JAX package, so it runs on a GPU
machine that has only the port's requirements:

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
from repro_torch.kernels import ops, qconv1d, qmatmul, ref
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
    _gqa_case(Hkv, group, C, window, bl, T, arena, hd=128)


@pytest.mark.gpu
@pytest.mark.parametrize("arena", list(ARENAS))
@pytest.mark.parametrize("C,window,T", [
    (1, 1024, 128), (16, 1024, 128),         # the window over 2048
    (1, 0, 80), (16, 0, 80)])                # a full layer at cache_len 1280
def test_cuda_gqa_paged_at_hymba_heads(C, window, T, arena):
    """On a card: the paged kernels at hymba-1.5b's heads (5 KV heads,
    group 5, head dim 64: R = 5 or 80 query rows, odd in their 16-row
    tiles), a window of 1024 over 2048 positions and a full layer's 80
    blocks; checked as the cases above."""
    _gqa_case(5, 5, C, window, 16, T, arena, hd=64)


def _gqa_case(Hkv, group, C, window, bl, T, arena, *, hd):
    _cuda()
    rs = np.random.RandomState(Hkv * 7 + group + C + window + bl + T)
    B = 4
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
    (1, 129, 129, 4, 4, 128, True),          # one row past a 128-row tile
    (4, 1536, 1536, 25, 5, 64, True),        # hymba-1.5b's prefill
    (4, 1500, 1500, 6, 6, 64, False),        # whisper-tiny's encoder
    (4, 512, 512, 14, 2, 64, True)])         # internvl2-1b's prefill
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
    (1, 100, 3, 48, 6, 64),                  # hd to 64, N to 8
    (4, 1536, 50, 64, 16, 256)])             # hymba-1.5b's prefill
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
def test_cuda_ssd_chunk_scan_takes_a_layer_slice(dtype):
    """hymba-1.5b keeps D as 50 fp32 values a layer, so an odd layer's
    slice of the stacked leaf starts 8 bytes past a 16-byte boundary:
    ``ops.ssd_chunk_scan`` hands the kernel an aligned copy (the kernel
    refused the slice until it did) and matches the plain version."""
    _cuda()
    rs = np.random.RandomState(50)
    B, S, nh, hd, N = 2, 300, 50, 64, 16
    D = (torch.from_numpy(rs.rand(3, nh).astype(np.float32)) + 0.5).cuda()
    D = D.unbind(0)[1]
    assert D.data_ptr() % 16 == 8
    x = torch.from_numpy(rs.randn(B, S, nh, hd).astype(np.float32)).to(
        "cuda", dtype)
    dt = torch.from_numpy((rs.rand(B, S, nh) * 0.1).astype(np.float32))
    Bm, Cm = (torch.from_numpy(rs.randn(B, S, N).astype(np.float32)).to(
        "cuda", dtype) for _ in range(2))
    A = -torch.linspace(1.0, 16.0, nh, device="cuda")
    y, h = ops.ssd_chunk_scan(x, dt.cuda(), A, Bm, Cm, D, chunk=256)
    wy, wh = ref.ssd_chunked(x, dt.cuda(), A, Bm, Cm, D, 256)
    torch.cuda.synchronize()
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
@pytest.mark.parametrize("arch", ["mamba2-130m-smoke", "qwen1.5-4b-smoke",
                                  "granite-moe-1b-a400m-smoke",
                                  "deepseek-v3-671b-smoke"])
def test_cuda_static_prefill_matches_the_cpu_path(arch):
    """On a card: the static path at smoke width (the kernels through
    their padded head dims) against the same prefill and decode steps on
    the CPU (plain versions), fp32: logits and every cache leaf at 1e-4;
    the prefill launches the slice's kernel once per layer (MLA's
    prefill launches none)."""
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
    assert counts == ({} if cfg.mla else {kernel: cfg.n_layers})
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sg, sc, rtol=1e-4, atol=1e-4)
    for g, tree in cc.items():
        for name, want in tree.items():
            torch.testing.assert_close(cg[g][name].cpu(), want, rtol=1e-4,
                                       atol=1e-4)


STATIC_GRAPH_SMOKE = ["qwen1.5-4b-smoke", "mamba2-130m-smoke",
                      "hymba-1.5b-smoke", "whisper-tiny-smoke",
                      "granite-moe-1b-a400m-smoke", "deepseek-v3-671b-smoke"]


def _cache_leaves(tree, path=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _cache_leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


@pytest.mark.gpu
@pytest.mark.parametrize("arch", STATIC_GRAPH_SMOKE)
def test_cuda_static_graphs_match_eager_plans(arch, no_tf32):
    """``serve.static_generate`` through its plans captured as CUDA
    graphs and through eager plans, on the same weights and prompts:
    the same greedy tokens; the prefill's last-position logits and every
    cache leaf after the last step bit for bit; the same launches by
    route in each half; 2 graphs and no retrace."""
    _cuda()
    from repro_torch.config import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    cfg = get_config(arch)
    params = api.init_params(0, cfg, device="cuda")
    batch = api.make_smoke_batch(0, cfg, 2, 40, device="cuda")
    out = []
    for graphs in (True, False):
        ops.reset_launch_counts()
        r = serve.static_generate(params, cfg, batch["tokens"], 8,
                                  patch_embeds=batch.get("patch_embeds"),
                                  frames=batch.get("frames"), graphs=graphs)
        torch.cuda.synchronize()
        out.append((r, ops.launch_counts(routes=True)))
    (g, rg), (e, re_) = out
    assert torch.equal(g["tokens"], e["tokens"])
    assert torch.equal(g["logits"], e["logits"])
    got, want = (dict(_cache_leaves(r["caches"])) for r in (g, e))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert torch.equal(got[path], leaf), path
    assert rg == re_
    for half in ("launches_prefill", "launches_decode"):
        assert g[half] == e[half]
    assert g["plans"]["graphs"] == 2 and e["plans"]["graphs"] == 0
    assert g["plans"]["retraces"] == e["plans"]["retraces"] == 0


@pytest.fixture
def no_tf32():
    """fp32 convs and matmuls in fp32 (cuDNN's TF32 default would round
    the classifier's operands to 10 mantissa bits)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.gpu
@pytest.mark.parametrize("qos", ["accuracy", "latency"])
def test_cuda_streamed_read_equals_the_offline_read(qos):
    """On a card: a rubicall-smoke read streamed in bursts (activation
    quantizers off, every block packed at 8 bits, bf16) gives the bases
    of the same read served whole through the same engine; both go
    through the kernel on the tensor-core route, three fused blocks a
    forward. The engine takes a read-until policy whose classifier lies
    on the CPU: the runner moves it to the card (threshold -1e9 keeps
    every read)."""
    _cuda()
    from dataclasses import replace

    from repro_torch.config import QuantPolicy, get_config
    from repro_torch.core.quant.policy import quantize_tree
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.basecaller import classifier as rc
    from repro_torch.serving.engine import Request
    from repro_torch.serving.stream import ReadUntil, StreamingRequest
    cfg = replace(get_config("rubicall-smoke"), quant=QuantPolicy(8, 0),
                  dtype="bfloat16")
    params = quantize_tree(api.init_params(torch.Generator().manual_seed(0),
                                           cfg), QuantPolicy(8, 0),
                           min_size=1)
    policy = ReadUntil(params=rc.init_params(
        torch.Generator().manual_seed(1)), threshold=-1e9)
    eng = api.make_serving_engine(params, cfg, n_slots=2, chunk_samples=300,
                                  qos=qos, read_until=policy)
    assert all(v.is_cuda for v in eng.runner.read_until.params.values())
    sig = np.random.RandomState(4).randn(2300).astype(np.float32)
    ops.reset_launch_counts()
    req = StreamingRequest(rid=0)
    eng.submit(req)
    for a in range(0, sig.size, 170):
        req.append(sig[a:a + 170])
        for _ in range(4):
            eng.step()
    req.finish()
    eng.run()
    streamed = eng.metrics.summary()
    eng.submit(Request(rid=1, signal=sig))
    done = eng.run()
    s = eng.metrics.summary()
    assert done[0].status == done[1].status == "finished"
    assert done[0].out_tokens == done[1].out_tokens and done[1].out_tokens
    forwards = s["bucket_hits"] + s["bucket_misses"]
    assert streamed["bucket_hits"] + streamed["bucket_misses"] >= \
        -(-sig.size // 300)
    assert ops.launch_counts(routes=True)["qconv1d_block"] == {
        "tensor_core": 3 * forwards, "cuda_core": 0}


@pytest.mark.gpu
def test_cuda_classifier_forward_matches_the_cpu(no_tf32):
    """On a card: the read-until classifier's forward on CUDA equals the
    CPU one within 1e-5."""
    _cuda()
    from repro_torch.models.basecaller import classifier as rc
    x, _ = rc.make_training_set(np.random.RandomState(0), 7500,
                                n_per_class=4)
    p = rc.init_params(torch.Generator().manual_seed(0))
    want = rc.forward(p, torch.from_numpy(x))
    got = rc.forward({k: v.cuda() for k, v in p.items()},
                     torch.from_numpy(x).cuda())
    assert got.is_cuda and got.shape == (8,)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_cuda_classifier_fit_stays_on_the_card(no_tf32):
    """On a card: ``fit`` trains where its params lie, returns params on
    the card, and follows the CPU fit (20 steps) within 1e-4 relative."""
    _cuda()
    from repro_torch.models.basecaller import classifier as rc
    x, y = rc.make_training_set(np.random.RandomState(1), 1380,
                                n_per_class=8)
    p = rc.init_params(torch.Generator().manual_seed(2))
    want, want_loss = rc.fit(p, x, y, steps=20, lr=0.1)
    got, loss = rc.fit({k: v.cuda() for k, v in p.items()}, x, y, steps=20,
                       lr=0.1)
    assert all(v.is_cuda and not v.requires_grad for v in got.values())
    assert np.isfinite(loss) and loss == pytest.approx(want_loss, rel=1e-4)
    for k, v in want.items():
        torch.testing.assert_close(got[k].cpu(), v, rtol=1e-4,
                                   atol=1e-4 * float(v.abs().max()))


# ---------------------------------------------------------------------------
# Training (slice 10)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,L", [(4, 170, 57), (8, 683, 200)])
def test_cuda_ctc_loss_matches_its_plain_twin(B, T, L):
    """On a card: ``F.ctc_loss`` (targets int64 on the card: the native
    CUDA implementation, not cuDNN's) against ``ctc_loss_ref``, the
    reference's scan, on the same logits: loss 1e-5 relative, gradients
    with respect to the logits at four fp32 ulps of the largest per-row
    log-likelihood (``tests/test_torch_training.py``)."""
    _cuda()
    from repro_torch.models.basecaller.ctc import ctc_loss, ctc_loss_ref
    rs = np.random.RandomState(T)
    z = torch.from_numpy((3 * rs.randn(B, T, 5)).astype(np.float32))
    lens = torch.from_numpy(rs.randint(L // 2, L + 1, size=B).astype(
        np.int32))
    labels = torch.from_numpy(rs.randint(1, 5, size=(B, L)).astype(np.int32))
    labels[torch.arange(L)[None, :] >= lens[:, None]] = 0
    out = []
    for fn, dev in ((ctc_loss, "cuda"), (ctc_loss_ref, "cuda"),
                    (ctc_loss_ref, "cpu")):
        zt = z.clone().to(dev).requires_grad_()
        loss = fn(torch.log_softmax(zt, -1), labels.to(dev), lens.to(dev))
        (g,) = torch.autograd.grad(loss, zt)
        out.append((float(loss.detach()), g.cpu()))
    ll = torch.nn.functional.ctc_loss(
        torch.log_softmax(z, -1).transpose(0, 1), labels.long(),
        torch.full((B,), T), lens.long(), reduction="none")
    for loss, g in out[:2]:
        assert loss == pytest.approx(out[2][0], rel=1e-5)
    torch.testing.assert_close(out[1][1], out[2][1], rtol=0, atol=1e-5)
    torch.testing.assert_close(out[0][1], out[2][1], rtol=0,
                               atol=max(4 * float(ll.max()) * 2 ** -23, 1e-5))


@pytest.mark.gpu
@pytest.mark.parametrize("n_micro", [1, 2])
def test_cuda_train_step_matches_the_cpu(n_micro, no_tf32):
    """On a card: one rubicall-smoke train step (fp32, activation
    quantizers off, so no grid step can flip) from the same params and
    batch as the same step on the CPU: loss 1e-5, grad norm 1e-4, BN
    state 1e-5, params within 1e-3 of lr (2 lr where the gradient is
    within 1e-4 of zero, as ``tests/test_torch_training.py``); every
    leaf of the new carry stays on the card."""
    _cuda()
    from dataclasses import replace

    from repro_torch.config import QuantPolicy, get_config
    from repro_torch.core.quant.policy import tree_items, tree_map
    from repro_torch.models import api
    from repro_torch.training import optimizer as opt
    cfg = get_config("rubicall-smoke")
    cfg = replace(cfg, quant=QuantPolicy(8, 0, overrides=tuple(
        (p, (w, 0)) for p, (w, _) in cfg.quant.overrides)))
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    batch = api.make_smoke_batch(0, cfg, 4, 512, device="cpu")
    oc = opt.AdamWConfig(lr=5e-3, total_steps=10, warmup_steps=0)
    outs = []
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        carry = api.TrainCarry(p, opt.init_opt_state(p, oc), tree_map(
            lambda t: t.to(dev), api.init_model_state(cfg)))
        carry, m = api.make_train_step(cfg, oc, n_micro)(
            carry, {k: v.to(dev) for k, v in batch.items()})
        assert all(v.device.type == dev for _, v in tree_items(carry.params))
        assert m["loss"].device.type == dev
        outs.append((carry, m))
    (cc, cm), (gc, gm) = outs
    assert float(gm["loss"]) == pytest.approx(float(cm["loss"]), rel=1e-5)
    assert float(gm["grad_norm"]) == pytest.approx(float(cm["grad_norm"]),
                                                   rel=1e-4)
    for (k, a), (_, b) in zip(tree_items(gc.model_state),
                              tree_items(cc.model_state)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
    mm = dict(tree_items(cc.opt_state.m))
    scale = max(float(v.abs().max()) for v in mm.values())
    for (k, a), (_, b) in zip(tree_items(gc.params), tree_items(cc.params)):
        atol = torch.where(mm[k].abs() < 1e-4 * scale, 2.0, 1e-3) * oc.lr
        assert bool(((a.cpu() - b).abs() <= atol).all()), k


@pytest.mark.gpu
def test_cuda_checkpoint_round_trip(tmp_path):
    """On a card: a carry of CUDA tensors (int8 AdamW state) saved
    asynchronously and restored into a CUDA carry, bit for bit."""
    _cuda()
    from repro_torch.config import get_config
    from repro_torch.core.quant.policy import tree_map
    from repro_torch.models import api
    from repro_torch.training import optimizer as opt
    from repro_torch.training.checkpoint import CheckpointManager, leaf_items
    cfg = get_config("rubicall-smoke")
    p = tree_map(lambda t: t.cuda(), api.init_params(
        torch.Generator().manual_seed(0), cfg))
    oc = opt.AdamWConfig(state_bits=8)
    grads = tree_map(torch.ones_like, p)
    p, st, _ = opt.adamw_update(p, grads, opt.init_opt_state(p, oc), oc)
    carry = api.TrainCarry(p, st, tree_map(lambda t: t.cuda(),
                                           api.init_model_state(cfg)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(5, carry)
    mgr.wait()
    like = tree_map(torch.zeros_like, p)
    step, got = mgr.restore(api.TrainCarry(
        like, opt.init_opt_state(like, oc), carry.model_state))
    assert step == 5
    want = dict(leaf_items(carry))
    for k, v in leaf_items(got):
        assert v.is_cuda and v.dtype == want[k].dtype
        assert torch.equal(v, want[k]), k


@pytest.mark.gpu
def test_cuda_packed_identity_through_the_kernel(no_tf32):
    """On a card: rubicall-smoke under QuantPolicy(8, 8), trained 60
    steps on the card, packed to int8 (every conv, min_size=1):
    ``eval_identity`` through the kernel (3 launches a forward, on the
    CUDA-core route: fp32) and through its plain version on the card
    agree within 0.005."""
    _cuda()
    from dataclasses import replace
    from unittest import mock

    from repro_torch.config import QuantPolicy, get_config
    from repro_torch.core.quant.policy import quantize_tree
    from repro_torch.kernels import ops
    from repro_torch.training import evaluate
    cfg = replace(get_config("rubicall-smoke"), quant=QuantPolicy(8, 8))
    params, state, loss = evaluate.train_model(cfg, steps=60, device="cuda")
    assert np.isfinite(loss)
    packed = quantize_tree(params, QuantPolicy(8, 0), min_size=1)

    def plain(x, *w, relu=True):
        k = w[0].shape[0]
        pad = (k - 1) // 2
        return ref.qconv1d_block_ref(torch.nn.functional.pad(
            x, (0, 0, pad, k - 1 - pad)), *w, relu=relu)
    ops.reset_launch_counts()
    kern = evaluate.eval_identity(cfg, packed, state, n_batches=2)
    routes = ops.launch_counts(routes=True)["qconv1d_block"]
    assert routes == {"tensor_core": 0, "cuda_core": 3 * 2}
    with mock.patch.object(qconv1d, "qconv1d_block_cuda", plain):
        want = evaluate.eval_identity(cfg, packed, state, n_batches=2)
    assert abs(kern - want) <= 0.005


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-4b-smoke",
                                  "granite-moe-1b-a400m-smoke",
                                  "deepseek-v3-671b-smoke",
                                  "mamba2-130m-smoke"])
def test_cuda_lm_grads_match_the_cpu(arch, no_tf32):
    """On a card: the LM loss and every gradient leaf at smoke size
    (fp32 master leaves, fp32 compute) against the same loss on the CPU:
    loss and metrics 1e-5 relative, each leaf within 1e-5 of the tree's
    largest |gradient|. The mixers' projections (``wq``, ``wk``, ``wv``;
    MLA's ``wdq``, ``wuq``, ``wdkv``, ``wukv``; the SSM's ``in_proj``) get
    non-zero gradients on the card, and the training forward launches no
    kernel: the prefill kernels have no backward."""
    _cuda()
    from repro_torch.config import get_config
    from repro_torch.core.quant.policy import tree_items, tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import api
    cfg = get_config(arch)
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             dtype=torch.float32)
    batch = api.make_smoke_batch(torch.Generator().manual_seed(1), cfg, 2,
                                 64)
    out = []
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        ops.reset_launch_counts()
        (loss, (m, _)), g = api.value_and_grad(
            api.make_loss_fn(cfg), p, {}, {k: v.to(dev)
                                           for k, v in batch.items()})
        assert not any(ops.launch_counts().values())
        out.append((float(loss), {k: float(v) for k, v in m.items()},
                    {k: v.cpu() for k, v in tree_items(g)}))
    (cl, cm, cg), (gl, gm, gg) = out
    assert gl == pytest.approx(cl, rel=1e-5)
    assert set(gm) == set(cm)
    for k in cm:
        assert gm[k] == pytest.approx(cm[k], rel=1e-5), k
    scale = max(float(v.abs().max()) for v in cg.values())
    for k, want in cg.items():
        torch.testing.assert_close(gg[k], want, rtol=0, atol=1e-5 * scale,
                                   msg=k)
    mixer = [k for k in cg if any(f"/{n}/" in k for n in (
        "wq", "wk", "wv", "wdq", "wuq", "wdkv", "wukv", "in_proj"))]
    assert mixer
    for k in mixer:
        assert float(gg[k].abs().max()) > 0, k


@pytest.mark.gpu
def test_cuda_prefill_kernels_refuse_inputs_that_require_grad():
    """On a card: ``ops.flash_attention`` and ``ops.ssd_chunk_scan`` (and
    ``ops.qmatmul``) raise for an input that requires grad while grad is
    enabled (their kernels record nothing for autograd), and run under
    ``torch.no_grad``."""
    _cuda()
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, grad=False):
        return torch.randn(shape, generator=g, device="cuda").requires_grad_(
            grad)
    for i in range(3):
        qkv = [randn(1, 32, 2, 64, grad=j == i) for j in range(3)]
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(*qkv)
        with torch.no_grad():
            assert ops.flash_attention(*qkv).shape == (1, 32, 2, 64)
    x, dt = randn(1, 64, 2, 16, grad=True), randn(1, 64, 2).abs()
    A, D = -torch.ones(2, device="cuda"), torch.ones(2, device="cuda")
    Bm, Cm = randn(1, 64, 16), randn(1, 64, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_chunk_scan(x, dt, A, Bm, Cm, D, chunk=32)
    with torch.no_grad():
        y, h = ops.ssd_chunk_scan(x, dt, A, Bm, Cm, D, chunk=32)
    assert y.shape == x.shape and h.shape == (1, 2, 16, 16)
    w = quantize_tensor(randn(256, 128), 8)
    xq = randn(4, 256, grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.qmatmul(xq, w)
    with torch.no_grad():
        assert ops.qmatmul(xq, w).shape == (4, 128)


# a bf16 query over fp32 rows (the audio family's cross-attention): fp32
# compute, then one bf16 rounding of the output, which fp32 sums in
# another order can land one bf16 ulp apart, at most 2^-7 of |want|
CROSS_TOL = dict(rtol=2 ** -7, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("arena", ["fp32", "bf16", "bf16q_fp32"])
@pytest.mark.parametrize("B,C,Se,H,Hkv,hd", [
    (4, 1, 1500, 6, 6, 64),      # whisper-tiny's cross-attention decode
    (1, 1, 1500, 6, 6, 64), (3, 1, 8, 6, 6, 64), (2, 3, 1500, 6, 6, 64),
    (2, 1, 8, 4, 2, 64),
    (2, 1, 256, 4, 2, 128), (2, 1, 257, 4, 2, 128)])
def test_cuda_decode_gqa_contiguous_matches_plain(B, C, Se, H, Hkv, hd,
                                                  arena):
    """On a card: ``decode_gqa`` over contiguous rows (``table=None``:
    the audio family's encoder buffer) through the paged kernels, the
    rows viewed as blocks of ``contiguous_block_len`` (375 at 1500 and
    hd 64; at hd 128, 128 at 256 and 204 at the prime 257, padded with
    masked positions), against the same call on the CPU (the kernels'
    plain versions): every position visible, one row's ``t`` halfway;
    fp32 at 1e-5 on the CUDA-core route, bf16 at 2e-2 on the
    tensor-core route, and a bf16 query over fp32 rows (the served
    cross-attention, CUDA-core) at one bf16 ulp of the output
    (``CROSS_TOL``); one launch a call."""
    _cuda()
    rs = np.random.RandomState(Se + B + C)
    q_dt, kv_dt = ((torch.bfloat16, torch.float32) if arena == "bf16q_fp32"
                   else (ARENAS[arena],) * 2)
    q, k, v = (torch.from_numpy(rs.randn(B, S, h, hd).astype(np.float32))
               .to(dt) for S, h, dt in ((C, H, q_dt), (Se, Hkv, kv_dt),
                                        (Se, Hkv, kv_dt)))
    pos = torch.arange(Se, dtype=torch.int32)[None].expand(B, Se)
    t = torch.full((B, C), Se, dtype=torch.int32)
    t[-1, -1] = Se // 2
    want = ops.decode_gqa(q, k, v, pos, t, backend="cuda")
    ops.reset_launch_counts()
    got = ops.decode_gqa(*(a.cuda() for a in (q, k, v, pos, t)),
                         backend="cuda")
    torch.cuda.synchronize()
    name = "gqa_paged" if C == 1 else "gqa_paged_chunk"
    assert ops.launch_counts()[name] == 1
    assert got.dtype == q_dt and bool(torch.isfinite(got).all())
    tol = (CROSS_TOL if arena == "bf16q_fp32" else
           dict(rtol=ATTN_TOL[arena], atol=ATTN_TOL[arena]))
    torch.testing.assert_close(got.cpu(), want, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [1, 16])
@pytest.mark.parametrize("L", [544, 541])
def test_cuda_decode_mla_contiguous_matches_plain(L, C, dtype):
    """On a card: ``decode_mla`` over contiguous latent rows
    (``table=None``, the static path's layout) through the MLA kernels,
    the rows viewed as blocks of ``mla_contiguous_block_len`` (34 at 544;
    64 at the prime 541, padded with masked positions), against the same
    call on the CPU (the kernels' plain versions) at deepseek-v3's widths
    (H 128, kvr 512, rope 64): stale rows past each fill, a hole, a
    decode row padded to C and a free row; live rows at the attention
    tolerance of the rows' dtype (fp32 on the CUDA-core route, bf16 on
    the tensor-core route); one launch a call."""
    _cuda()
    rs = np.random.RandomState(L + C)
    B, H, kvr, rd = 4, 128, 512, 64
    pos = np.full((B, L), pa.EMPTY_POS, np.int32)
    t = np.zeros((B, C), np.int32)
    for b, f in enumerate((L - C, L // 2, 1, 0)):
        pos[b, :f + C] = np.arange(f + C)
        t[b] = np.arange(f, f + C)
    pos[0, 3] = pa.EMPTY_POS
    t[2, 1:] = -1
    t[3] = -1
    args = [torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
            for shape in ((B, C, H, kvr), (B, C, H, rd), (B, L, kvr),
                          (B, L, rd))] + [torch.from_numpy(pos),
                                          torch.from_numpy(t)]
    kw = dict(scale=(128 + rd) ** -0.5, table=None, backend="cuda")
    want = ops.decode_mla(*args, **kw)
    ops.reset_launch_counts()
    got = ops.decode_mla(*(a.cuda() for a in args), **kw)
    torch.cuda.synchronize()
    name = "mla_paged" if C == 1 else "mla_paged_chunk"
    route = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    assert ops.launch_counts(routes=True)[name][route] == 1
    assert ops.launch_counts()[name] == 1
    assert got.shape == (B, C, H, kvr) and got.dtype == torch.float32
    live = torch.from_numpy(t >= 0)
    tol = ATTN_TOL["fp32" if dtype == torch.float32 else "bf16"]
    torch.testing.assert_close(got.cpu()[live], want[live], rtol=tol,
                               atol=tol)


@pytest.mark.gpu
def test_cuda_core_smem_bytes_match_the_kernel():
    """``pa.cuda_core_smem_bytes`` (what ``contiguous_block_len`` sizes
    a block by) equals the built kernel's own count, and the longest
    block it allows fits the limit while one more does not."""
    _cuda()
    from repro_torch.kernels import paged_attention as pa
    lib = pa._lib()
    for rows, bl, hd in ((1, 16, 64), (6, 375, 64), (16, 390, 64),
                         (4, 204, 128), (48, 8, 32)):
        assert pa.cuda_core_smem_bytes(rows, bl, hd) == \
            lib.gqa_paged_smem_bytes(rows, bl, hd)
    for hd in (64, 128):
        top = pa.cuda_core_max_block(hd)
        assert lib.gqa_paged_smem_bytes(16, top, hd) <= pa.SMEM_LIMIT \
            < lib.gqa_paged_smem_bytes(16, top + 1, hd)


@pytest.mark.gpu
def test_cuda_encoder_prefix_stage_matches_the_cpu():
    """On a card: the audio runner's admission (``encode``, then every
    xdec layer's cross K/V into the slot's row) at whisper-tiny-smoke
    against the same staging on the CPU, fp32 with TF32 off: every
    buffer leaf at 1e-4; the other slot's row stays zero."""
    _cuda()
    from repro_torch.config import get_config
    from repro_torch.core.quant.policy import tree_map
    from repro_torch.models import api
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import SamplingParams
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config("whisper-tiny-smoke")
        params = api.init_params(0, cfg, device="cpu")
        frames = np.random.RandomState(0).randn(
            cfg.frontend_tokens, cfg.d_model).astype(np.float32)
        bufs = []
        for dev in ("cpu", "cuda"):
            eng = api.make_serving_engine(
                tree_map(lambda a: a.to(dev), params), cfg, device=dev,
                n_slots=2, cache_len=16, prefill_chunk=4,
                cache_dtype=torch.float32)
            eng.runner.admit(1, Request(
                rid=0, prompt=[1], sampling=SamplingParams(max_new_tokens=1),
                frames=frames))
            bufs.append(tree_map(lambda a: a.cpu(), eng.runner.enc_kv))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for g, leaves in bufs[0].items():
        for name, want in leaves.items():
            got = bufs[1][g][name]
            assert bool((got[:, 0] == 0).all())
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,row", [
    (torch.bfloat16, (4, 64)), (torch.float8_e4m3fn, (4, 64)),
    (torch.int8, (4, 64)), (torch.float32, (4,)), (torch.float16, (3, 5)),
    (torch.int32, ()), (torch.bfloat16, (3,))])
@pytest.mark.parametrize("n", [4, 64])
def test_cuda_scatter_rows_matches_its_plain_version(dtype, row, n):
    """The drop-route scatter against the filtered ``index_put_``, byte
    for byte: every fourth write carries a sentinel in one index, the
    others land at distinct rows; rows of 2 to 512 bytes (word widths 2,
    4, 8 and 16)."""
    _cuda()
    from repro_torch.kernels import scatter_rows as sr
    rs = np.random.RandomState(n + len(row))
    n0, n1 = 24, 8
    src = torch.from_numpy(rs.randn(n, *row).astype(np.float32) * 9)
    dst = torch.from_numpy(rs.randn(n0, n1, *row).astype(np.float32) * 9)
    dst, src = (a.to(dtype) for a in (dst, src))
    flat = rs.permutation(n0 * n1)[:n]
    i0, i1 = flat // n1, flat % n1
    i0[::4] = n0
    i1[1::4] = n1 + 3
    i0, i1 = (torch.from_numpy(a.astype(np.int64)) for a in (i0, i1))
    want = dst.clone()
    ref.scatter_rows_ref(want, i0, i1, src)
    got = dst.cuda()
    ops.reset_launch_counts()
    ops.scatter_rows(got, i0.cuda(), i1.cuda(), src.cuda())
    assert ops.launch_counts(routes=True)["scatter_rows"] == {
        "tensor_core": 0, "cuda_core": 1}
    assert torch.equal(pa._bytes_view(got.cpu()), pa._bytes_view(want))
    assert sr.scatter_rows_cuda.launches == 1


def _graph_engines(arch, **kw):
    """The same smoke weights served through graph and eager plans."""
    from repro_torch.config import get_config
    from repro_torch.core.quant.policy import tree_map
    from repro_torch.models import api
    cfg = get_config(arch)
    if cfg.family == "basecaller":
        params = api.init_params(torch.Generator().manual_seed(0), cfg)
    else:
        params = api.init_params(0, cfg, device="cpu")
    params = tree_map(lambda a: a.cuda(), params)
    return cfg, [api.make_serving_engine(params, cfg, device="cuda",
                                         graphs=graphs, **kw)
                 for graphs in (True, False)]


GRAPH_LM_SMOKE = ["qwen1.5-4b-smoke", "hymba-1.5b-smoke",
                  "whisper-tiny-smoke", "deepseek-v3-671b-smoke",
                  "granite-moe-1b-a400m-smoke"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_LM_SMOKE)
def test_cuda_graph_plans_serve_like_eager_plans(arch, no_tf32):
    """Every plan of a smoke LM engine captured at warmup and replayed:
    greedy and sampled tokens equal the eager plans', launches by route
    equal, no retrace, one graph a plan."""
    _cuda()
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import SamplingParams
    cfg, engines = _graph_engines(arch, n_slots=2, cache_len=32,
                                  prefill_chunk=4, block_len=4,
                                  cache_dtype=torch.bfloat16)
    out = []
    for eng in engines:
        eng.warmup()
        eng.runner.plans.require_warm = True
        rs = np.random.RandomState(0)
        ops.reset_launch_counts()
        for i, (pl, mn) in enumerate([(6, 8), (11, 6), (3, 9)]):
            sp = (SamplingParams(max_new_tokens=mn, temperature=0.8,
                                 top_k=20, seed=i) if i == 1
                  else SamplingParams(max_new_tokens=mn))
            frames = (rs.randn(cfg.frontend_tokens, cfg.d_model).astype(
                np.float32) if cfg.family == "audio" else None)
            eng.submit(Request(rid=i, prompt=rs.randint(
                1, cfg.vocab_size, pl).tolist(), sampling=sp, frames=frames))
        done = eng.run()
        torch.cuda.synchronize()
        out.append(({i: (r.status, list(r.out_tokens))
                     for i, r in done.items()},
                    ops.launch_counts(routes=True), eng.runner.plan_stats()))
    (tg, rg, sg), (te, re_, se) = out
    assert tg == te and all(s == "finished" for s, _ in tg.values())
    assert rg == re_
    assert sg["graphs"] == sg["plans"] and se["graphs"] == 0
    assert sg["retraces"] == se["retraces"] == 0


@pytest.mark.gpu
def test_cuda_graph_tick_is_bitwise_the_eager_tick():
    """rubicall-smoke's window plan with the read-until classifier: one
    tick through the captured graph and through the eager plan, log-probs
    and logits bit for bit, the same launches by route; tick N's output
    unchanged after tick N+1's replay."""
    _cuda()
    from types import SimpleNamespace
    from repro_torch.models.basecaller import classifier as rc
    from repro_torch.serving.stream import ReadUntil
    ru = ReadUntil(params=rc.init_params(torch.Generator().manual_seed(1)),
                   eject_after_chunks=2, threshold=0.0)
    cfg, engines = _graph_engines("rubicall-smoke", n_slots=2,
                                  chunk_samples=300, read_until=ru)
    r0 = engines[0].runner
    W = r0.core + 2 * r0.halo
    rs = np.random.RandomState(3)
    ticks = [[SimpleNamespace(final=False, payload=(
        rs.randn(W, 1).astype(np.float32), 0, 10, -r0.halo, 4 * W, 1))
        for _ in range(2)] for _ in range(2)]
    outs = []
    for eng in engines:
        eng.runner.warmup()
        ops.reset_launch_counts()
        first = eng.runner.dispatch(ticks[0])[1]
        second = eng.runner.dispatch(ticks[1])[1]
        torch.cuda.synchronize()
        outs.append((first, second, ops.launch_counts(routes=True)))
    (g1, g2, rg), (e1, e2, re_) = outs
    for got, want in zip((*g1, *g2), (*e1, *e2)):
        assert torch.equal(got, want)
    assert rg == re_
    assert engines[0].runner.plan_stats()["graphs"] == 1
