"""The port's Mamba-2 SSD scan and SSM layer against the JAX package's.

Both packages get the same numpy inputs. The JAX side runs its Pallas
``ssd_scan_p`` in interpret mode (``ops.ssd_chunk_scan``), its model's
``ssd_chunked`` and its sequential oracle ``ssd_scan_ref``; the port runs,
on CPU tensors, the plain version of its CUDA ``ssd_scan`` kernel
(``ref.ssd_chunked``, also what ``ops.ssd_chunk_scan`` runs on the CPU)
and its ``ssd_scan_ref``. Scan tolerance: the reference test's 5e-3
(observed ≤ 4.3e-6: fp32 summation order only). A length the chunk does not
divide is compared with the JAX model's ``ssd_chunked`` (the Pallas
kernel asserts S % chunk == 0). The layer tests run ``ssm_forward`` and
``ssm_decode`` of ``mamba2-130m-smoke`` in fp32 with bridged weights at
1e-5 (observed ~1e-7). The CUDA kernel itself is held to its plain
version on a card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import api as japi
from repro.models.lm import ssm as jssm
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.models.lm import ssm

# tests/test_kernels.py's shapes, then lengths that 64 does not divide
SHAPES = [(256, 2, 32, 16, 64), (512, 4, 64, 32, 128), (128, 2, 32, 16, 128)]
RAGGED = [(200, 2, 32, 16, 64), (77, 3, 16, 8, 32)]


def _inputs(S, nh, hd, N, B=2, seed=0):
    rng = np.random.RandomState(S + nh + seed)
    return (rng.randn(B, S, nh, hd).astype(np.float32),
            (rng.rand(B, S, nh) * 0.1).astype(np.float32),
            -(rng.rand(nh) + 0.5).astype(np.float32),
            rng.randn(B, S, N).astype(np.float32),
            rng.randn(B, S, N).astype(np.float32),
            (rng.rand(nh) + 0.5).astype(np.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,nh,hd,N,chunk", SHAPES)
def test_plain_ssd_matches_jax_pallas_kernel(S, nh, hd, N, chunk):
    """The port's plain version (what the wrapper runs on the CPU) vs the
    JAX Pallas kernel in interpret mode, at 5e-3."""
    args = _inputs(S, nh, hd, N)
    want = jops.ssd_chunk_scan(*(jnp.asarray(a) for a in args), chunk=chunk)
    got, _ = ops.ssd_chunk_scan(*(torch.from_numpy(a) for a in args),
                                chunk=chunk)
    _close(got, want, 5e-3)


@pytest.mark.parametrize("S,nh,hd,N,chunk", SHAPES + RAGGED)
def test_plain_ssd_and_state_match_jax_model_chunked(S, nh, hd, N, chunk):
    """y and the final state (the decode hand-off) against the JAX
    model's ``ssd_chunked``, ragged lengths included, at 5e-3."""
    args = _inputs(S, nh, hd, N, seed=1)
    wy, wh = jssm.ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
    gy, gh = ref.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk)
    assert gy.shape == (2, S, nh, hd) and gh.shape == (2, nh, hd, N)
    assert gh.dtype == torch.float32
    _close(gy, wy, 5e-3)
    _close(gh, wh, 5e-3)


@pytest.mark.parametrize("S,nh,hd,N,chunk", SHAPES[:1] + RAGGED)
def test_sequential_ssd_ref_matches_jax_ref(S, nh, hd, N, chunk):
    """The port's exact recurrence (``ssd_scan_ref``, heads folded into
    rows, B/C repeated per head) against the JAX oracle, and against the
    port's chunked plain version, at 5e-3."""
    x, dt, A, Bm, Cm, D = _inputs(S, nh, hd, N, seed=2)
    B = x.shape[0]
    folded = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(
                  B * nh, S, hd),
              np.ascontiguousarray(dt.transpose(0, 2, 1)).reshape(B * nh, S),
              np.tile(A, B), np.repeat(Bm[:, None], nh, 1).reshape(
                  B * nh, S, N),
              np.repeat(Cm[:, None], nh, 1).reshape(B * nh, S, N),
              np.tile(D, B))
    want = jref.ssd_scan_ref(*(jnp.asarray(a) for a in folded))
    got = ref.ssd_scan_ref(*(torch.from_numpy(a) for a in folded))
    _close(got, want, 5e-3)
    chunked, _ = ref.ssd_chunked(*(torch.from_numpy(a) for a in
                                   (x, dt, A, Bm, Cm, D)), chunk)
    _close(got.reshape(B, nh, S, hd).permute(0, 2, 1, 3), chunked, 5e-3)


def test_ssd_scan_wrapper_refuses_a_device_without_a_kernel():
    args = [torch.zeros(s, device="meta") for s in
            ((1, 4, 1, 32), (1, 4, 1), (1,), (1, 4, 8), (1, 4, 8), (1,))]
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_chunk_scan(*args)


@pytest.fixture(scope="module")
def ssm_layer():
    """Layer 0's SSM parameters of mamba2-130m-smoke (fp32), JAX and
    bridged."""
    jcfg = jget_config("mamba2-130m-smoke")
    jp = japi.init_params(jax.random.key(3), jcfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    j1 = jax.tree.map(lambda a: a[0], jp["groups"]["g0_ssm"]["ssm"])
    t1 = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
              else v[0]) for k, v in tp["groups"]["g0_ssm"]["ssm"].items()}
    return jcfg, get_config("mamba2-130m-smoke"), j1, t1


@pytest.mark.parametrize("S", [64, 50])
def test_ssm_forward_and_decode_match_jax(ssm_layer, S):
    """``ssm_forward`` (output and the h/conv hand-off) and three
    ``ssm_decode`` steps from that state, against the JAX layer in fp32
    at 1e-5. S = 50: the smoke chunk (32) does not divide it."""
    jcfg, tcfg, jp, tp = ssm_layer
    assert set(tp) == {"in_proj", "conv_w", "conv_b", "A_log", "D",
                       "dt_bias", "out_proj"}
    rng = np.random.RandomState(S)
    x = rng.randn(2, S, tcfg.d_model).astype(np.float32)
    jy, jst = jssm.ssm_forward(jp, jnp.asarray(x), jcfg)
    ty, tst = ssm.ssm_forward(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy, 1e-5)
    for k in ("h", "conv"):
        assert tuple(tst[k].shape) == jst[k].shape
        _close(tst[k], jst[k], 1e-5)
    for _ in range(3):
        xt = rng.randn(2, 1, tcfg.d_model).astype(np.float32)
        jy, jst = jssm.ssm_decode(jp, jnp.asarray(xt), jst, jcfg)
        ty, tst = ssm.ssm_decode(tp, torch.from_numpy(xt), tst, tcfg)
        _close(ty, jy, 1e-5)
        _close(tst["h"], jst["h"], 1e-5)
        _close(tst["conv"], jst["conv"], 1e-5)


@pytest.mark.parametrize("dtype,hd,N,want", [
    (torch.bfloat16, 64, 128, "tensor_core"),   # mamba2-130m
    (torch.bfloat16, 16, 8, "tensor_core"),     # padded to 64 and 64
    (torch.bfloat16, 128, 128, "cuda_core"),
    (torch.bfloat16, 64, 256, "cuda_core"),
    (torch.float32, 64, 128, "cuda_core")])
def test_route_is_by_dtype_and_shape(dtype, hd, N, want):
    assert ssd_scan.route(dtype, hd, N) == want
    if want == "tensor_core":
        assert ssd_scan.tc_state_width(N) == (64 if N <= 64 else 128)


def _split(v):
    """An fp32 operand as the kernel feeds it to the tensor cores: bf16
    hi + bf16 lo, both widened back."""
    hi = v.to(torch.bfloat16).float()
    return hi + (v - hi).to(torch.bfloat16).float()


def _two_pass_model(x, dt, A, Bm, Cm, D, Q=ssd_scan.TC_CHUNK):
    """The tensor-core route's arithmetic in chunks of Q (zero-padded past
    S). State pass: per chunk the state before it is kept as hi + lo, then
    h = exp(total) h + (x w)^T B with x w as hi + lo. Chunk pass: G = C
    B^T, the causal M = G exp(cum_t - cum_s) dt_s as hi + lo times x,
    plus exp(cum_t) C (h_prev hi + lo)^T, plus D x. x, B, C are bf16
    values; all sums fp32. Returns (y fp32, final state)."""
    Bsz, S, nh, hd = x.shape
    N = Bm.shape[-1]
    T = -(-S // Q)
    pad = T * Q - S
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    Bf = torch.nn.functional.pad(Bm.float(), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(Cm.float(), (0, 0, 0, pad))
    xr = xf.reshape(Bsz, T, Q, nh, hd)
    dtr = dtf.reshape(Bsz, T, Q, nh)
    Br, Cr = Bf.reshape(Bsz, T, Q, N), Cf.reshape(Bsz, T, Q, N)
    cum = torch.cumsum(dtr * A.float(), dim=2)            # (B, T, Q, nh)
    total = cum[:, :, -1]                                 # (B, T, nh)
    # state pass
    h = torch.zeros((Bsz, nh, hd, N))
    h_prev = []
    for c in range(T):
        h_prev.append(_split(h))
        w = torch.exp(total[:, c, None] - cum[:, c]) * dtr[:, c]
        xw = _split(xr[:, c] * w[..., None])              # (B, Q, nh, hd)
        h = h * torch.exp(total[:, c])[:, :, None, None] + torch.einsum(
            "bqhd,bqn->bhdn", xw, Br[:, c])
    # chunk pass
    G = torch.einsum("btqn,btsn->btqs", Cr, Br)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, T, t, s, nh)
    decay = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                                  torch.full_like(diff, -torch.inf)))
    M = _split(G[..., None] * decay * dtr[:, :, None, :, :])
    y = torch.einsum("btqsh,btshd->btqhd", M, xr)
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "btqn,bthdn->btqhd", Cr, torch.stack(h_prev, dim=1))
    y = y + D.float()[None, None, None, :, None] * xr
    return y.reshape(Bsz, T * Q, nh, hd)[:, :S], h


def _bf16_inputs(S, nh, hd, N, seed):
    """``_inputs`` with x, B and C rounded to bf16 values (what the
    tensor-core route reads), kept as fp32 arrays for both packages."""
    x, dt, A, Bm, Cm, D = _inputs(S, nh, hd, N, seed=seed)
    rnd = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
           for a in (x, Bm, Cm)]
    return rnd[0], dt, A, rnd[1], rnd[2], D


@pytest.mark.parametrize("S,nh,hd,N,chunk", SHAPES)
def test_two_pass_model_matches_jax_pallas_kernel(S, nh, hd, N, chunk):
    """The tensor-core route's two-pass arithmetic (Q = 128, fp32
    operands as bf16 hi + lo) against the JAX Pallas kernel in interpret
    mode at the reference's chunk, at 5e-3."""
    args = _bf16_inputs(S, nh, hd, N, seed=3)
    want = jops.ssd_chunk_scan(*(jnp.asarray(a) for a in args), chunk=chunk)
    got, _ = _two_pass_model(*(torch.from_numpy(a) for a in args))
    _close(got, want, 5e-3)


@pytest.mark.parametrize("S,nh,hd,N,chunk", SHAPES + RAGGED)
def test_two_pass_model_and_state_match_jax_model_chunked(S, nh, hd, N,
                                                          chunk):
    """y and the final state of the two-pass model against the JAX
    model's ``ssd_chunked``, ragged lengths (the last chunk zero-padded)
    included, at 5e-3."""
    args = _bf16_inputs(S, nh, hd, N, seed=4)
    wy, wh = jssm.ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
    gy, gh = _two_pass_model(*(torch.from_numpy(a) for a in args))
    assert gy.shape == (2, S, nh, hd) and gh.shape == (2, nh, hd, N)
    _close(gy, wy, 5e-3)
    _close(gh, wh, 5e-3)
