"""Quantization in the PyTorch port against the JAX package: packing,
scales and quantized trees are bitwise equal (both frameworks round
half to even); fake-quant is equal and its STE gradient is the
identity."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.config import QuantPolicy as JQuantPolicy
from repro.config import get_config as jget_config
from repro.core.quant import policy as jpol
from repro.core.quant.fake_quant import fake_quant as jfake_quant
from repro.models.basecaller import model as jbc
from repro_torch import bridge
from repro_torch.config import QuantPolicy
from repro_torch.core.quant import policy as tpol
from repro_torch.core.quant.fake_quant import fake_quant


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_packed_equal(jp, tp):
    assert tp.bits == jp.bits and tp.orig_shape == tuple(jp.orig_shape)
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))
    assert tp.data.dtype == torch.int8
    np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("shape", [(64, 32), (7, 5), (3, 16, 8)])
def test_quantize_tensor_bitwise(bits, per_channel, shape):
    w = np.random.RandomState(sum(shape) + bits).randn(*shape).astype(
        np.float32)
    jp = jpol.quantize_tensor(jnp.asarray(w), bits, per_channel)
    tp = tpol.quantize_tensor(torch.from_numpy(w), bits, per_channel)
    _assert_packed_equal(jp, tp)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jpol.dequantize(jp, dt)).astype(np.float32)
        got = tpol.dequantize(tp, tdt).float().numpy()
        np.testing.assert_array_equal(got, want)


def test_pack_unpack_int4_bitwise():
    q = np.random.RandomState(0).randint(-8, 8, size=(2, 10, 6)).astype(
        np.int8)
    jp = np.asarray(jpol.pack_int4(jnp.asarray(q)))
    tp = tpol.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tpol.unpack_int4(tp).numpy(), q)
    np.testing.assert_array_equal(
        tpol.unpack_int4(tp).numpy(),
        np.asarray(jpol.unpack_int4(jnp.asarray(jp))))


def test_quantize_tree_bitwise_rubicall_smoke():
    """rubicall-smoke params (JAX init, bridged), every conv leaf packed
    (min_size=1) at 8 bits: the same leaves pack, to the same bytes,
    scales and conv layouts; tree sizes agree."""
    cfg = jget_config("rubicall-smoke")
    jparams = jbc.init_params(jax.random.key(0), cfg)
    tparams = bridge.from_numpy_tree(_np_tree(jparams), device="cpu")
    jq = jpol.quantize_tree(jparams, JQuantPolicy(8, 0), min_size=1)
    tq = tpol.quantize_tree(tparams, QuantPolicy(8, 0), min_size=1)
    jflat = jax.tree_util.tree_flatten_with_path(
        jq, is_leaf=lambda x: isinstance(x, jpol.PackedTensor))[0]
    n_packed = 0
    for path, jleaf in jflat:
        tleaf = tq
        for k in path:
            tleaf = tleaf[k.key]
        if isinstance(jleaf, jpol.PackedTensor):
            _assert_packed_equal(jleaf, tleaf)
            n_packed += 1
        else:
            np.testing.assert_array_equal(tleaf.numpy(), np.asarray(jleaf))
    assert n_packed == 2 * cfg.n_blocks + 1       # every dw, pw and head_pw
    assert tpol.tree_size_bytes(tq) == jpol.tree_size_bytes(jq)


def test_bridge_keeps_dtypes_and_packed_nodes():
    """int8 stays int8, fp32 stays fp32, a JAX bf16 leaf becomes torch
    bf16 with the same values; PackedTensor nodes keep bits/orig_shape."""
    rs = np.random.RandomState(2)
    w = rs.randn(6, 4).astype(np.float32)
    tree = _np_tree({"a": {"q": jpol.quantize_tensor(jnp.asarray(w), 8),
                           "f": jnp.asarray(w),
                           "h": jnp.asarray(w, jnp.bfloat16)}})
    out = bridge.from_numpy_tree(tree, device="cpu")
    _assert_packed_equal(tree["a"]["q"], out["a"]["q"])
    assert out["a"]["f"].dtype == torch.float32
    np.testing.assert_array_equal(out["a"]["f"].numpy(), w)
    assert out["a"]["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["a"]["h"].float().numpy(),
                                  tree["a"]["h"].astype(np.float32))


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("axis", [None, -1])
def test_fake_quant_matches(bits, axis):
    x = np.random.RandomState(bits).randn(4, 9, 12).astype(np.float32)
    ax = None if axis is None else x.ndim - 1
    want = np.asarray(jfake_quant(jnp.asarray(x), bits, axis=ax))
    got = fake_quant(torch.from_numpy(x), bits, axis=ax).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis", [None, 1])
def test_fake_quant_ste_gradient_is_identity(axis):
    x = torch.from_numpy(np.random.RandomState(1).randn(5, 7).astype(
        np.float32) * 3).requires_grad_()
    y = fake_quant(x, 4, axis=axis)
    assert not torch.equal(y.detach(), x.detach())    # values moved
    (y * torch.arange(35.0).reshape(5, 7)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(),
                                  np.arange(35.0).reshape(5, 7))
