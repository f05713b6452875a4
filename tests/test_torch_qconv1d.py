"""The port's fused qconv1d block against the JAX package's.

On the CPU the port's ``ops.qconv1d_block`` runs its plain PyTorch
version and the JAX one its Pallas kernel in interpret mode; both get
the same numpy inputs and the same packed weights. Tolerance 1e-3, the
JAX package's own kernel tolerance (tests/test_kernels.py). The CUDA
kernel itself is held to the plain version on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
                                   (90, 344, 75)])
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
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, 0, 1, 1))
    with pytest.raises(ValueError, match="CUDA"):
        qconv1d.qconv1d_block_cuda(
            xp, pdw.data, ppw.data, pdw.scale, ppw.scale,
            torch.from_numpy(g)[None], torch.from_numpy(b)[None])
    assert qconv1d.qconv1d_block_cuda.launches == 0
