"""The port's flash attention and whole-prompt attention layer against
the JAX package's.

Both packages get the same numpy inputs. The JAX side runs its Pallas
``flash_attention_p`` in interpret mode (``ops.flash_attention``, heads
folded into rows and KV heads repeated per group) or, where that kernel
asserts S % 128 == 0, its dense oracle ``ref.flash_attention_ref``; the
port runs, on CPU tensors, the plain version of its CUDA
``flash_attention`` kernel (``ref.flash_attention_gqa_ref``, what
``ops.flash_attention`` runs on the CPU). Tolerance: the reference
test's 1e-4 (observed ≤ 8.3e-7). A plain model of the bf16 kernel's
tensor-core arithmetic (bf16 operands, 64-key tiles, P in two bf16
terms) is held to the Pallas kernel at the same 1e-4. The layer test runs the port's
``attn_forward`` (which calls ``ops.flash_attention``) against the JAX
``attn_forward`` (which calls ``blockwise_attn``) with bridged
``qwen1.5-4b-smoke`` weights in fp32 at 1e-5. The CUDA kernel itself is held to its plain version on a
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.config import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import api as japi
from repro.models.lm import attention as jattn
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models.lm import attention as attn


def _qkv(B, Sq, Sk, H, Hkv, d):
    rng = np.random.RandomState(Sq + Sk + H + d)
    return (rng.randn(B, Sq, H, d).astype(np.float32),
            rng.randn(B, Sk, Hkv, d).astype(np.float32),
            rng.randn(B, Sk, Hkv, d).astype(np.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


# tests/test_kernels.py's shapes (causal only where Sq == Sk)
@pytest.mark.parametrize("Sq,Sk,H,Hkv,d,causal", [
    (128, 128, 4, 4, 64, True), (128, 128, 4, 4, 64, False),
    (256, 256, 4, 2, 64, True), (256, 256, 4, 2, 64, False),
    (128, 256, 8, 1, 128, False)])
def test_plain_flash_matches_jax_pallas_kernel(Sq, Sk, H, Hkv, d, causal):
    q, k, v = _qkv(2, Sq, Sk, H, Hkv, d)
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal)
    assert got.shape == (2, Sq, H, d)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("Sq,Sk,H,Hkv,d,causal", [
    (200, 200, 4, 2, 64, True), (77, 150, 8, 1, 128, False),
    (150, 77, 4, 4, 32, True)])
def test_plain_flash_matches_jax_oracle_at_ragged_lengths(Sq, Sk, H, Hkv, d,
                                                          causal):
    """Lengths the Pallas kernel cannot take (S % 128 != 0): the port's
    plain version against the JAX dense oracle, GQA repeat done on the
    JAX side as its ``ops.flash_attention`` does."""
    q, k, v = _qkv(2, Sq, Sk, H, Hkv, d)
    g = H // Hkv

    def fold(a, rep):
        a = jnp.asarray(a).transpose(0, 2, 1, 3)
        a = jnp.repeat(a, rep, axis=1) if rep > 1 else a
        return a.reshape(-1, a.shape[2], d)
    want = jref.flash_attention_ref(fold(q, 1), fold(k, g), fold(v, g),
                                    causal=causal)
    want = want.reshape(2, H, Sq, d).transpose(0, 2, 1, 3)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal)
    _close(got, want, 1e-4)


def _tensor_core_flash(q, k, v, causal, p_terms=2):
    """Plain model of the bf16 tensor-core kernel's arithmetic: bf16 q, k
    and v (widened exactly), fp32 scores scaled after the dot, 64-key
    tiles with an online softmax (fp32 m, l over the unrounded p), and
    P . V with p as ``p_terms`` bf16 terms (2: p_hi + p_lo, as the
    kernel; 1: p rounded once). q (B, Sq, H, d), k/v (B, Sk, Hkv, d)."""
    B, Sq, H, d = q.shape
    Sk, g = k.shape[1], H // k.shape[2]

    def heads(a, rep):
        return (a.to(torch.bfloat16).float().transpose(1, 2)
                .repeat_interleave(rep, dim=1))
    qf, kf, vf = heads(q, 1), heads(k, g), heads(v, g)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, d))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, 64):
        kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
        s = (qf @ kt.transpose(-1, -2)) * d ** -0.5
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(keys <= rows, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vt
        if p_terms == 2:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).transpose(1, 2)


# the Pallas shapes above; inputs rounded to bf16 first (the kernel's
# inputs are bf16), handed to JAX as fp32
@pytest.mark.parametrize("Sq,Sk,H,Hkv,d,causal", [
    (128, 128, 4, 4, 64, True), (128, 128, 4, 4, 64, False),
    (256, 256, 4, 2, 64, True), (256, 256, 4, 2, 128, False),
    (128, 256, 8, 1, 128, False)])
def test_tensor_core_flash_model_matches_jax_pallas_kernel(Sq, Sk, H, Hkv, d,
                                                           causal):
    """The tensor-core flash kernel's arithmetic (bf16 operands, 64-key
    tiles, P as p_hi + p_lo) against the JAX Pallas kernel in interpret
    mode on bf16-representable inputs, at the reference test's 1e-4.
    The two-term P is also closer to the reference than a single bf16
    P, which would not meet the tolerance on its own."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
               for a in _qkv(2, Sq, Sk, H, Hkv, d))
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal), np.float32)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    got = _tensor_core_flash(*args, causal)
    assert got.shape == (2, Sq, H, d)
    _close(got, want, 1e-4)
    one = _tensor_core_flash(*args, causal, p_terms=1)
    err2 = float(np.abs(got.numpy() - want).max())
    err1 = float(np.abs(one.numpy() - want).max())
    assert err2 < err1 and err1 > 1e-4


def test_flash_wrapper_refuses_a_device_without_a_kernel():
    q = torch.zeros((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q, q)


@pytest.mark.parametrize("S", [48, 37])
def test_attn_forward_matches_jax_blockwise(S):
    """Layer 0's attention of qwen1.5-4b-smoke (QKV bias, rope, GQA 4:2)
    over a whole prompt, in full and with a window of 16: the port's
    output and K/V hand-off against the JAX layer's (``blockwise_attn``)
    at 1e-5."""
    jcfg = jget_config("qwen1.5-4b-smoke")
    tcfg = get_config("qwen1.5-4b-smoke")
    jp = japi.init_params(jax.random.key(5), jcfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    j1 = jax.tree.map(lambda a: a[0], jp["groups"]["g0_dense"]["attn"])
    t1 = {k: {kk: vv[0] for kk, vv in v.items()}
          for k, v in tp["groups"]["g0_dense"]["attn"].items()}
    x = np.random.RandomState(S).randn(2, S, tcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    jy, jkv = jattn.attn_forward(j1, jnp.asarray(x), jnp.asarray(pos), jcfg)
    ty, tkv = attn.attn_forward(t1, torch.from_numpy(x),
                                torch.from_numpy(pos.copy()), tcfg)
    _close(ty, jy, 1e-5)
    for name in ("k", "v"):
        _close(tkv[name], jkv[name], 1e-5)
    # a sliding window (the hybrid family's hybrid_swa layers) runs the
    # port's blockwise_attn, against the JAX layer's at 1e-5
    jy, jkv = jattn.attn_forward(j1, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                 window=16)
    ty, tkv = attn.attn_forward(t1, torch.from_numpy(x),
                                torch.from_numpy(pos.copy()), tcfg, window=16)
    _close(ty, jy, 1e-5)
    for name in ("k", "v"):
        _close(tkv[name], jkv[name], 1e-5)
