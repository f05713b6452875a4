"""The port's quantized matmul against the JAX package's.

On the CPU the port's ``ops.qmatmul`` runs the plain version of its CUDA
kernel; the JAX side runs its Pallas ``qmatmul_p`` in interpret mode on
shapes that meet that kernel's tiling contract, and its dequantized
matmul on ragged shapes (the Pallas kernel refuses them; the CUDA kernel
takes any shape). Both get the same numpy inputs and the same packed
weights. Tolerance 2e-2, the reference's (``tests/test_kernels.py``).
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant.policy import dequantize as jdequantize
from repro.core.quant.policy import quantize_tensor as jquantize_tensor
from repro.kernels import ops as jops
from repro_torch import bridge
from repro_torch.config import QuantPolicy, get_config
from repro_torch.kernels import ops, qmatmul
from repro_torch.models.lm import common

TOL = 2e-2


def _inputs(M, K, N, bits, dtype):
    rs = np.random.RandomState(M + K + N + bits)
    x = rs.randn(M, K).astype(np.float32)
    jw = jquantize_tensor(jnp.asarray(rs.randn(K, N), jnp.float32), bits)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, jnp.dtype(dtype).name))
    return jx, jw, tx, bridge.from_numpy_tree({"w": jw}, device="cpu")["w"]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("M,K,N", [(256, 512, 128), (4, 256, 384)])
def test_qmatmul_matches_the_pallas_kernel(M, K, N, dtype, bits):
    jx, jw, tx, tw = _inputs(M, K, N, bits, dtype)
    want = np.asarray(jops.qmatmul(jx, jw), np.float32)
    got = ops.qmatmul(tx, tw)
    assert got.shape == (M, N) and got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL, atol=TOL)
    assert ops.launch_counts()["qmatmul"] == 0       # CPU: plain version


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N", [(5, 37, 50), (3, 301, 200),
                                   (130, 64, 130)])
def test_qmatmul_ragged_shapes_and_odd_k(M, K, N, bits):
    """Any M, N, K; an odd K leaves a pad row in the int4 packing that
    the product must drop."""
    jx, jw, tx, tw = _inputs(M, K, N, bits, jnp.float32)
    assert tw.data.shape[0] == (K if bits == 8 else (K + 1) // 2)
    want = np.asarray(jx @ jdequantize(jw, jnp.float32))
    got = ops.qmatmul(tx, tw)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_dense_routes_packed_weight_through_qmatmul(monkeypatch):
    """``dense`` takes the qmatmul route exactly when the config carries
    8-bit weights for the layer and the reference's tiling contract
    holds; the route is the integer matmul (exact against numpy), and
    the fallback dequantizes on read."""
    from repro_torch.core.quant.policy import quantize_tensor
    cfg = replace(get_config("qwen1.5-4b-smoke"), dtype="float32",
                  quant=QuantPolicy(weight_bits=8, act_bits=0))
    rs = np.random.RandomState(3)
    w_p = quantize_tensor(torch.from_numpy(rs.randn(64, 128).astype(
        np.float32)), 8)
    calls = []
    real = ops.qmatmul
    monkeypatch.setattr(ops, "qmatmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.from_numpy(rs.randn(4, 64).astype(np.float32))
    y = common.dense({"kernel": w_p}, x, cfg=cfg, tag="mlp/wi")
    assert calls == [1]
    want = (x.numpy() @ w_p.data.numpy().astype(np.float32)) \
        * w_p.scale.numpy()
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-6)
    x130 = torch.from_numpy(rs.randn(130, 64).astype(np.float32))
    y130 = common.dense({"kernel": w_p}, x130, cfg=cfg, tag="mlp/wi")
    assert calls == [1]                  # 130 % 128 != 0: no kernel
    want130 = (x130.numpy() @ w_p.data.numpy().astype(np.float32)) \
        * w_p.scale.numpy()
    np.testing.assert_allclose(y130.numpy(), want130, rtol=1e-5, atol=1e-5)
    cfg16 = replace(cfg, quant=QuantPolicy(
        weight_bits=8, act_bits=0, overrides=(("mlp/wi", (16, 16)),)))
    common.dense({"kernel": w_p}, x, cfg=cfg16, tag="mlp/wi")
    assert calls == [1]                  # a 16-bit layer never routes


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        qmatmul.qmatmul_cuda(x, torch.zeros(16, 8, dtype=torch.int8),
                             torch.ones(1, 8))
    assert qmatmul.qmatmul_cuda.launches == 0


@pytest.mark.parametrize("dtype,M,want", [
    (torch.bfloat16, 4, "tensor_core"), (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 130, "tensor_core"), (torch.float32, 4, "cuda_core"),
    (torch.float32, 64, "cuda_core")])
def test_route_is_by_dtype(dtype, M, want):
    """bf16 x (every served projection, decode and mixed ticks) takes the
    tensor-core kernel; fp32 x keeps the reference's fp32 sum on the CUDA
    cores."""
    assert qmatmul.route(dtype, M) == want


@pytest.mark.parametrize("M,K,N,want", [
    (64, 2560, 6912, (640, 4)), (64, 2560, 2560, (320, 8)),
    (4, 6912, 2560, (896, 8)), (4, 2560, 151936, (2560, 1)),
    (64, 1536, 24576, (1536, 1)), (5, 37, 50, (64, 1)),
    (130, 301, 200, (64, 5))])
def test_tensor_core_plan_splits_k_over_one_cluster(M, K, N, want):
    """``tc_plan``: splits of whole 64-row multiples, at most 8 (the CTAs
    of one cluster), every split non-empty, and a grid of at most two
    CTAs per SM (one wave) unless one split already exceeds it."""
    kr, splits = qmatmul.tc_plan(M, K, N)
    assert (kr, splits) == want
    assert kr % qmatmul.TC_KS == 0 and 1 <= splits <= qmatmul.TC_MAX_SPLITS
    assert kr * (splits - 1) < K <= kr * splits
    tiles = -(-N // qmatmul.TC_BN) * -(-M // qmatmul.TC_MMAX)
    assert splits == 1 or tiles * splits <= 2 * qmatmul.SMS


def _tensor_core_model(x, w_q, scale, bits):
    """The tensor-core kernel's arithmetic: bf16 x times the exact bf16
    of each int8/int4 weight (an exact fp32 product), summed in fp32
    over each K split of ``tc_plan``, the splits' partial sums added in
    split order, the scale after the sum, one rounding to bf16."""
    from repro_torch.core.quant.policy import unpack_int4
    M, K = x.shape
    w = (unpack_int4(w_q)[:K] if bits == 4 else w_q).float()
    assert torch.equal(w.to(torch.bfloat16).float(), w)   # exact in bf16
    xf = x.to(torch.bfloat16).float()
    kr, splits = qmatmul.tc_plan(M, K, w.shape[1])
    acc = torch.zeros((M, w.shape[1]), dtype=torch.float32)
    for s in range(splits):
        acc = acc + xf[:, s * kr:(s + 1) * kr] @ w[s * kr:(s + 1) * kr]
    return (acc * scale).to(torch.bfloat16)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N", [(64, 512, 256), (4, 1024, 256),
                                   (64, 256, 384)])
def test_tensor_core_model_matches_the_pallas_kernel(M, K, N, bits):
    """The tensor-core arithmetic (bf16 x, exact bf16 weights, fp32 sums
    over up to 8 K splits added in order) against the JAX Pallas kernel
    in interpret mode, at the reference's 2e-2, at the mixed tick's M =
    64 and the decode's M = 4."""
    jx, jw, tx, tw = _inputs(M, K, N, bits, jnp.bfloat16)
    assert qmatmul.tc_plan(M, K, N)[1] > 1 or K <= 256
    want = np.asarray(jops.qmatmul(jx, jw), np.float32)
    got = _tensor_core_model(tx, tw.data, tw.scale.float().reshape(1, -1),
                             bits)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL,
                               atol=TOL)
