"""Card-only tests of the port's CUDA kernels (``-m gpu``; they skip
without a card). This file imports neither JAX nor the JAX package, so
it runs on a GPU machine that has only the port's requirements:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quant.policy import quantize_tensor
from repro_torch.kernels import qconv1d, ref


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
