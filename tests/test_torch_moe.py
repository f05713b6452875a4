"""The port's MoE FFN against the JAX package's.

- ``_top_k_dispatch``: dispatch equal and combine weights within 1e-6 of
  the reference's on the same gates, over k, a capacity that overflows,
  exact ties (broken to the first expert) and pad masks.
- ``moe_ffn``: the same output within 1e-5 in fp32 for float and packed
  int8 and int4 experts (router through the quantized matmul as served),
  for the decode fold (S == 1: the batch is one dispatch group) and for
  chunks (S > 1, a group per row), with pad tokens, recording gradients
  or not. With more experts than a call can choose (``n = G·S·k < E``)
  the port gathers the chosen experts' weights into ``n`` slots, over
  several chunks, the last one partial; where ``n == E`` it walks every
  expert in chunks. The reference runs every expert.
- ``moe_ffn`` runs on meta tensors: no op of the expert path reads the
  routing's values (meta raises on ``nonzero``, ``.cpu()``, ``unique``).
- Packing as the weights are drawn equals packing the drawn tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.config import QuantPolicy as JQuantPolicy
from repro.config import get_config as jget_config
from repro.core.quant.policy import quantize_tree as jquantize_tree
from repro.models.lm import moe as jmoe
from repro_torch import bridge
from repro_torch.config import QuantPolicy, get_config
from repro_torch.core.quant.policy import (Packer, PackedTensor,
                                           quantize_tree, tree_map)
from repro_torch.models import api
from repro_torch.models.lm import moe

ARCHS = ("deepseek-v3-671b-smoke", "granite-moe-1b-a400m-smoke")


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("G,S,E,k,capacity,masked,ties", [
    (1, 4, 8, 2, 4, False, False),
    (2, 8, 4, 2, 4, True, False),      # 16 picks on 4 x 4 slots: overflow
    (3, 6, 4, 3, 2, True, False),      # tight capacity, k = 3
    (2, 5, 4, 2, 4, False, True),      # exact ties
])
def test_top_k_dispatch_matches_the_reference(G, S, E, k, capacity, masked,
                                              ties):
    rs = np.random.RandomState(G * 100 + S * 10 + k)
    z = rs.randn(G, S, E) * 2.0
    z[:, :, 0] += 1.0                  # skew: expert 0 overflows first
    if ties:
        z[:, ::2] = 0.0                # uniform rows: every gate ties
    gates = _softmax(z)
    mask = (rs.rand(G, S) > 0.3) if masked else None
    jd, jc, jaux = jmoe._top_k_dispatch(
        jnp.asarray(gates), k, capacity,
        mask=None if mask is None else jnp.asarray(mask))
    td, tc, taux = moe._top_k_dispatch(
        torch.from_numpy(gates), k, capacity,
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    # the overflow case really drops picks: fewer than k slots a token
    if capacity * E < S * k:
        assert int(td.sum()) < (G * S if mask is None else mask.sum()) * k


def _models(arch, packed, **changes):
    """Both packages' configs (``changes`` applied to each), the
    reference's expert params and their bridge; ``packed``: weight bits
    (0: float)."""
    jcfg = dataclasses.replace(jget_config(arch), **changes)
    tcfg = dataclasses.replace(get_config(arch), **changes)
    jp = jmoe.make_moe_params(jax.random.key(1), jcfg)
    if packed:
        jcfg = dataclasses.replace(jcfg, quant=JQuantPolicy(packed, 0))
        tcfg = dataclasses.replace(tcfg, quant=QuantPolicy(packed, 0))
        jp = jquantize_tree({"ffn": jp}, JQuantPolicy(packed, 0),
                            min_size=256)["ffn"]
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    if packed:
        assert isinstance(tp["wi"], PackedTensor)
        assert isinstance(tp["router"]["kernel"], PackedTensor)
    return jcfg, tcfg, jp, tp


def _check_moe_ffn(jcfg, tcfg, jp, tp, B, S, decode, grad):
    rs = np.random.RandomState(B + S)
    x = rs.randn(B, S, jcfg.d_model).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[-1, -1] = False                            # a pad token
    if S > 1:
        mask[0, 5:] = False                         # a padded chunk
    want, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, decode=decode,
                              pad_mask=jnp.asarray(mask))
    tx = torch.from_numpy(x).requires_grad_(grad)
    with torch.enable_grad() if grad else torch.no_grad():
        got, taux = moe.moe_ffn(tp, tx, tcfg, decode=decode,
                                pad_mask=torch.from_numpy(mask))
    assert got.shape == (B, S, jcfg.d_model) and got.dtype == torch.float32
    assert got.requires_grad == grad
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-5)
    if grad:
        got.sum().backward()
        assert tx.grad is not None and torch.isfinite(tx.grad).all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("packed", [False, True, 4])
@pytest.mark.parametrize("B,S,decode", [(4, 1, True), (2, 8, False)])
def test_moe_ffn_matches_the_reference(arch, packed, B, S, decode):
    """Float (False), int8 (True) or int4 (4) experts, each call under
    ``no_grad`` and recording gradients."""
    models = _models(arch, 8 if packed is True else int(packed))
    for grad in (False, True):
        _check_moe_ffn(*models, B, S, decode, grad)


@pytest.mark.parametrize("E,k,B,S,decode,ff", [
    (24, 4, 3, 1, True, 64),     # n = 12 < 24: gathered, chunks 8 + 4
    (24, 4, 3, 1, True, 33),     # the same; int4 stacks with a pad row
    (20, 4, 2, 8, False, 64),    # n == E = 20: chunks 8 + 8 + 4
])
@pytest.mark.parametrize("packed", [0, 8, 4])
def test_moe_ffn_over_many_experts_matches_the_reference(E, k, B, S, decode,
                                                         ff, packed):
    """More experts than the smoke configs' 4, so the slot count
    ``n = min(E, G·S·k)`` spans several chunks, and on a decode fold
    falls below ``E``: the chosen experts are gathered into slots by a
    table on the device, and the slots past them hold unchosen experts
    that must add nothing."""
    G, rows = (1, B * S) if decode else (B, S)
    assert (G * rows * k < E) == decode
    _check_moe_ffn(*_models("granite-moe-1b-a400m-smoke", packed,
                            n_experts=E, experts_per_tok=k, d_ff=ff,
                            moe_d_ff=ff),
                   B, S, decode, grad=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_runs_on_meta_tensors(arch):
    """Meta tensors carry shapes and no values, and raise on every op
    whose result depends on them (``nonzero``, ``.cpu()``, ``.tolist()``,
    ``unique``, ``bincount``): the whole layer, routing and experts, and
    its int8 stacks, runs on them at the decode fold's gathered slots
    and at a chunk's every expert."""
    tcfg = dataclasses.replace(get_config(arch), n_experts=24,
                               experts_per_tok=4, quant=QuantPolicy(8, 0))
    p = moe.make_moe_params(torch.Generator().manual_seed(0), tcfg,
                            pack=Packer(QuantPolicy(8, 0), min_size=256))
    assert isinstance(p["wi"], PackedTensor)
    p = tree_map(lambda t: t.to("meta"), p)
    for B, S, decode in ((3, 1, True), (2, 8, False)):
        x = torch.empty((B, S, tcfg.d_model), device="meta")
        mask = torch.ones((B, S), dtype=torch.bool, device="meta")
        y, aux = moe.moe_ffn(p, x, tcfg, decode=decode, pad_mask=mask)
        assert y.device.type == "meta" and y.shape == (B, S, tcfg.d_model)
        assert aux.shape == ()
    with pytest.raises(NotImplementedError):
        torch.nonzero(x)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b-smoke",
                                  "qwen1.5-4b-smoke"])
def test_packing_while_drawing_equals_packing_the_tree(arch):
    """``init_params(wbits=8)`` packs each leaf as it is drawn (expert
    stacks a few experts at a time): bit for bit the packing of the
    drawn float tree."""
    cfg = get_config(arch)
    whole = quantize_tree(api.init_params(
        torch.Generator().manual_seed(3), cfg, device="cpu"),
        QuantPolicy(8, 0))
    drawn = api.init_params(torch.Generator().manual_seed(3), cfg,
                            device="cpu", wbits=8)

    def flat(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from flat(v, prefix + k + "/")
            elif isinstance(v, PackedTensor):
                yield prefix + k + "/data", v.data
                yield prefix + k + "/scale", v.scale
            else:
                yield prefix + k, v
    a, b = dict(flat(whole)), dict(flat(drawn))
    assert a.keys() == b.keys()
    assert any(k.endswith("/data") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
