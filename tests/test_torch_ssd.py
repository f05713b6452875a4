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
from repro_torch.kernels import ops, ref
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
