"""The port's fused qconv1d block against the JAX package's.

On the CPU the port's ``ops.qconv1d_block`` runs its plain PyTorch
version and the JAX one its Pallas kernel in interpret mode; both get
the same numpy inputs and the same packed weights. Tolerance 1e-3, the
JAX package's own kernel tolerance (tests/test_kernels.py). The CUDA
kernels themselves are held to the plain version on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``; here a plain model
of the tensor-core kernel's arithmetic (the two-term bf16 A operand) is
held to the JAX kernel, and the route rule is checked.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.core.quant.policy import quantize_tensor as jquantize_tensor
from repro.kernels import ops as jops
from repro_torch import bridge
from repro_torch.core.quant.policy import quantize_tensor
from repro_torch.kernels import ops, qconv1d


def _inputs(T, C, k):
    rng = np.random.RandomState(T + C + k)
    x = rng.randn(2, T, C).astype(np.float32)
    dw = rng.randn(k, C).astype(np.float32)
    pw = rng.randn(C, C).astype(np.float32)
    g = rng.rand(C).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    return x, dw, pw, g, b


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("T,C,k", [(256, 128, 9), (512, 128, 31),
                                   (256, 256, 5), (40, 344, 5),
                                   (90, 344, 75),
                                   (20, 344, 75), (4, 64, 9)])  # T < k
def test_qconv1d_block_matches_jax(T, C, k, relu):
    x, dw, pw, g, b = _inputs(T, C, k)
    jdw = jquantize_tensor(jnp.asarray(dw), 8)
    jpw = jquantize_tensor(jnp.asarray(pw), 8)
    want = np.asarray(jops.qconv1d_block(jnp.asarray(x), jdw, jpw,
                                         jnp.asarray(g), jnp.asarray(b),
                                         relu=relu))
    packed = bridge.from_numpy_tree({"dw": jdw, "pw": jpw}, device="cpu")
    ops.reset_launch_counts()
    got = ops.qconv1d_block(torch.from_numpy(x), packed["dw"], packed["pw"],
                            torch.from_numpy(g), torch.from_numpy(b),
                            relu=relu)
    assert got.shape == (2, T, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
    assert set(ops.launch_counts().values()) == {0}      # CPU: plain version


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the CUDA wrapper raises on a CPU tensor instead of
    computing it some other way."""
    x, dw, pw, g, b = _inputs(16, 8, 3)
    pdw = quantize_tensor(torch.from_numpy(dw), 8)
    ppw = quantize_tensor(torch.from_numpy(pw), 8)
    with pytest.raises(ValueError, match="CUDA"):
        qconv1d.qconv1d_block_cuda(
            torch.from_numpy(x), pdw.data, ppw.data, pdw.scale, ppw.scale,
            torch.from_numpy(g)[None], torch.from_numpy(b)[None])
    assert qconv1d.qconv1d_block_cuda.launches == 0
    assert set(qconv1d.qconv1d_block_cuda.routes.values()) == {0}


RUBICALL_KS = (5, 9, 25, 31, 55, 75)


@pytest.mark.parametrize("k", RUBICALL_KS)
def test_route_is_by_dtype_and_shape(k):
    """bf16 at C a multiple of 8 up to 352 and k up to 96 whose tiles fit
    in shared memory takes the tensor-core kernel (RUBICALL's C = 344 at
    every k it serves); fp32, C % 8 != 0, C > 352 and a k past 96 or
    whose ring no longer fits take the CUDA-core kernel."""
    assert qconv1d.route(torch.bfloat16, 344, k) == "tensor_core"
    assert qconv1d.route(torch.bfloat16, 96, k) == "tensor_core"
    assert qconv1d.route(torch.float32, 344, k) == "cuda_core"
    assert qconv1d.route(torch.bfloat16, 100, k) == "cuda_core"
    assert qconv1d.route(torch.bfloat16, 360, k) == "cuda_core"
    assert qconv1d.route(torch.bfloat16, 344, 115) == "cuda_core"
    assert qconv1d.route(torch.bfloat16, 96, 96) == "tensor_core"
    assert qconv1d.route(torch.bfloat16, 96, 97) == "cuda_core"
    assert qconv1d.route(torch.bfloat16, 352, 96) == "tensor_core"
    # the budget the source's header states for C = 344, k = 75
    assert qconv1d.tc_smem_bytes(344, 75) == 217632
    assert qconv1d.tc_smem_bytes(352, 96) <= qconv1d.SMEM_LIMIT


def _tensor_core_model(x, dw_q, dw_s, pw_q, pw_s, g, b, *, relu, terms):
    """The tensor-core kernel's arithmetic on the CPU: bf16 x, the fp32
    depthwise sum in ascending tap order over the zero halo, the sum as
    one bf16 term or as hi + lo, each term times the int8 pw exactly
    with fp32 accumulation, then pw_s, gamma, beta, ReLU; fp32 out."""
    B, T, C = x.shape
    k = dw_q.shape[0]
    pad = (k - 1) // 2
    xp = torch.nn.functional.pad(x.to(torch.bfloat16).float(),
                                 (0, 0, pad, k - 1 - pad))
    dw = dw_q.float() * dw_s
    acc = torch.zeros((B, T, C))
    for i in range(k):
        acc = acc + xp[:, i:i + T] * dw[i]
    hi = acc.to(torch.bfloat16).float()
    parts = [hi, (acc - hi).to(torch.bfloat16).float()][:terms]
    y = sum(p.double() @ pw_q.double() for p in parts).float()
    y = y * pw_s * g + b
    return torch.clamp_min(y, 0.0) if relu else y


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("T,C,k", [(90, 344, 75), (40, 96, 31),
                                   (20, 344, 75)])
def test_tensor_core_model_matches_jax(T, C, k, relu):
    """The tensor-core kernel's two-term bf16 A operand keeps the
    reference's fp32 acc: its model agrees with the JAX kernel (on the
    same bf16-rounded x) at the reference's 1e-3, and its error is a
    small fraction of what one bf16 term gives."""
    x, dw, pw, g, b = _inputs(T, C, k)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    jdw = jquantize_tensor(jnp.asarray(dw), 8)
    jpw = jquantize_tensor(jnp.asarray(pw), 8)
    want = np.asarray(jops.qconv1d_block(jnp.asarray(x), jdw, jpw,
                                         jnp.asarray(g), jnp.asarray(b),
                                         relu=relu))
    packed = bridge.from_numpy_tree({"dw": jdw, "pw": jpw}, device="cpu")
    pdw, ppw = packed["dw"], packed["pw"]
    args = (torch.from_numpy(x), pdw.data.reshape(k, C), pdw.scale.reshape(C),
            ppw.data, ppw.scale.reshape(C), torch.from_numpy(g),
            torch.from_numpy(b))
    two = _tensor_core_model(*args, relu=relu, terms=2).numpy()
    one = _tensor_core_model(*args, relu=relu, terms=1).numpy()
    np.testing.assert_allclose(two, want, rtol=1e-3, atol=1e-3)
    err_two, err_one = np.abs(two - want).max(), np.abs(one - want).max()
    assert err_two < err_one / 16, (err_two, err_one)
