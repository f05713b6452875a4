"""RUBICON core parity: distillation and SkipClip, pruning, the QABAS
space, latency table, supernet and search of the port against the JAX
package's, on the same numpy inputs and bridged weights (smoke size,
CPU).

Exact wherever the reference is exact: gate schedules, pruning masks,
space sizes, the latency table under the reference's constants, derived
configs. Losses and forwards 1e-5 (fp32 order); gradients 1e-4 of the
tree's largest (the CTC loss's fp32 backward, ``test_torch_training``).
The port's path sampler draws from a ``torch.Generator`` and cannot
reproduce JAX's threefry draws: it is held to its contract (two
distinct ops and quant choices a block, the same draws for the same
generator state).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.analysis import roofline as jroofline
from repro.config import get_config as jget_config
from repro.core import distill as jdistill
from repro.core import pruning as jpruning
from repro.core import skipclip as jskipclip
from repro.core.qabas import latency as jlatency
from repro.core.qabas import search as jsearch
from repro.core.qabas import space as jspace
from repro.core.qabas import supernet as jsupernet
from repro.core.quant.fake_quant import quant_dequant_params as jqdq
from repro.models.basecaller.ctc import ctc_loss as jctc_loss
from repro.models.basecaller import model as jbc
from repro_torch.config import get_config
from repro_torch.core import distill, pruning, skipclip
from repro_torch.core.qabas import latency, search, space, supernet
from repro_torch.core.quant.fake_quant import quant_dequant_params
from repro_torch.core.quant.policy import (quantize_tree, tree_items,
                                           tree_size_bytes)
from repro_torch.data.squiggle import SquiggleConfig, batches
from repro_torch.models import api
from repro_torch.models.basecaller import model as bc
from repro_torch.models.basecaller.ctc import ctc_loss
from test_torch_training import (_batch, _close_grads, _close_tree, _init,
                                 _j, _jflat, _np, _t, _tflat)

EXACT = 1e-5


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------- distill


@pytest.mark.parametrize("tau", [1.0, 2.0, 4.0])
def test_kd_and_skipclip_losses_match_reference(tau):
    rs = np.random.RandomState(int(tau))
    s, t = (rs.randn(2, 30, 5).astype(np.float32) * 3 for _ in range(2))
    want = jdistill.kd_loss(jnp.asarray(s), jnp.asarray(t), tau=tau)
    got = distill.kd_loss(torch.from_numpy(s), torch.from_numpy(t), tau=tau)
    assert float(got) == pytest.approx(float(want), rel=EXACT)
    assert float(distill.skipclip_loss(torch.tensor(3.0), got, 0.7)) == \
        pytest.approx(float(jdistill.skipclip_loss(3.0, want, 0.7)),
                      rel=EXACT)


def test_gates_for_epoch_match_reference():
    for n in (1, 4, 28):
        for stride in (1, 2, 3):
            for epoch in range(-1, 2 * n + 2):
                want = np.asarray(jskipclip.gates_for_epoch(n, epoch, stride))
                got = skipclip.gates_for_epoch(n, epoch, stride)
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), want)


def test_skipclip_loss_value_and_grads_match_reference():
    """A bonito-smoke teacher (eval mode, no gradient) distilling into a
    bonito-smoke student mid-anneal (gates of epoch 2, stride 1)."""
    t_cfg = jget_config("bonito-smoke")
    tp, ts = _init(t_cfg, seed=1)
    sp, ss = _init(t_cfg, seed=2)
    b = _batch(S=288, B=2)
    gates = np.asarray(jskipclip.gates_for_epoch(4, 2, 1))
    jloss = jskipclip.make_skipclip_loss(t_cfg, t_cfg,
                                         jskipclip.SkipClipConfig())
    (wl, (wm, ws)), wg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _j(sp), _j(ss), _j(tp), _j(ts), _j(b), jnp.asarray(gates))
    cfg = get_config("bonito-smoke")
    tloss = skipclip.make_skipclip_loss(cfg, cfg, skipclip.SkipClipConfig())
    (gl, (gm, gs)), gg = api.value_and_grad(
        tloss, _t(sp), _t(ss), _t(tp), _t(ts), _tb(b),
        skipclip.gates_for_epoch(4, 2, 1))
    assert float(gl) == pytest.approx(float(wl), rel=EXACT)
    for k in ("ctc", "kd", "loss"):
        assert float(gm[k]) == pytest.approx(float(wm[k]), rel=EXACT)
    _close_tree(gs, ws, EXACT, EXACT)
    _close_grads(gg, wg, 1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_zero_gates_equal_stripped_skips(train):
    cfg = get_config("bonito-smoke")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    state = api.init_model_state(cfg)
    sig = torch.from_numpy(np.random.RandomState(0).randn(2, 96, 1)
                           .astype(np.float32))
    lp_gated, _ = bc.forward(params, state, sig, cfg, train=train,
                             skip_gates=torch.zeros(cfg.n_blocks))
    stripped = skipclip.strip_skip_params(params)
    lp_none, _ = bc.forward(stripped, state, sig, cfg, train=train)
    assert torch.equal(lp_gated, lp_none)
    assert not any("skip" in k for k, _ in tree_items(stripped))


# ---------------------------------------------------------------- pruning


@pytest.fixture(scope="module")
def bridged_rubicall():
    return _np(jbc.init_params(jax.random.key(5),
                               jget_config("rubicall-smoke")))


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.75])
def test_pruning_masks_match_reference(bridged_rubicall, sparsity):
    p = bridged_rubicall
    for jf, tf in ((jpruning.unstructured_mask, pruning.unstructured_mask),
                   (jpruning.structured_channel_mask,
                    pruning.structured_channel_mask)):
        want, got = jf(_j(p), sparsity), tf(_t(p), sparsity)
        w, g = _jflat(want), _tflat(got)
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert pruning.sparsity_of(got) == pytest.approx(
            jpruning.sparsity_of(want), abs=1e-12)
        assert pruning.model_size_bytes(_t(p), got, bits=8) == \
            jpruning.model_size_bytes(_j(p), want, bits=8)
        _close_tree(pruning.apply_mask(_t(p), got),
                    jpruning.apply_mask(_j(p), want), 0, 0)
    assert pruning.model_size_bytes(_t(p)) == jpruning.model_size_bytes(_j(p))


def test_pruning_walks_lists_of_blocks():
    """The supernet's ``blocks`` list: masks keyed through the list
    equal the reference's."""
    jp = jsupernet.init_supernet(jax.random.key(0), jspace.TINY_SPACE,
                                 channels=8)
    tp = _t(_np(jp))
    _close_tree(pruning.unstructured_mask(tp, 0.5),
                jpruning.unstructured_mask(jp, 0.5), 0, 0)


@pytest.mark.parametrize("bits,per_channel", [(8, True), (4, False)])
def test_quant_dequant_params_matches_reference(bridged_rubicall, bits,
                                                per_channel):
    p = bridged_rubicall
    _close_tree(quant_dequant_params(_t(p), bits, per_channel),
                jqdq(_j(p), bits, per_channel), 0, 1e-7)


# ---------------------------------------------------------------- QABAS


def test_search_spaces_match_reference():
    for name in ("DEFAULT_SPACE", "TINY_SPACE"):
        got, want = getattr(space, name), getattr(jspace, name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.n_ops, got.n_quant) == (want.n_ops, want.n_quant)
        assert got.size() == want.size()
        assert got.quant_size() == want.quant_size()
    # the reference test's bounds (paper: ~1.8e32 viable, ~6.7e20 quant)
    assert space.DEFAULT_SPACE.size() > 1e30
    assert space.DEFAULT_SPACE.quant_size() > 1e15


@pytest.mark.parametrize("chunk,channels", [(512, 64), (2048, 344)])
def test_latency_table_under_the_reference_constants(monkeypatch, chunk,
                                                     channels):
    """With the reference's roofline constants patched in, the table is
    the reference's exactly; with the port's own (the H100's), it is a
    different table of the same shape."""
    own = latency.latency_table(space.DEFAULT_SPACE, chunk=chunk,
                                channels=channels)
    for name in ("HBM_BW", "PEAK_BF16", "PEAK_INT8"):
        monkeypatch.setattr(latency, name, getattr(jroofline, name))
    got = latency.latency_table(space.DEFAULT_SPACE, chunk=chunk,
                                channels=channels)
    want = jlatency.latency_table(jspace.DEFAULT_SPACE, chunk=chunk,
                                  channels=channels)
    np.testing.assert_array_equal(got, want)
    assert own.shape == want.shape and not np.array_equal(own, want)
    assert (own[-1] == 0).all()                       # identity is free
    rs = np.random.RandomState(0)
    a, b = (np.array(jax.nn.softmax(rs.randn(28, n), -1))
            for n in own.shape)
    assert float(latency.expected_latency(
        torch.from_numpy(a), torch.from_numpy(b), got)) == pytest.approx(
            float(jlatency.expected_latency(a, b, want)), rel=EXACT)


def test_h100_constants_are_the_data_sheet():
    assert (latency.HBM_BW, latency.PEAK_BF16, latency.PEAK_INT8) == \
        (3.35e12, 989e12, 1979e12)


def _supernet_case(seed=0):
    sp = jspace.TINY_SPACE
    jp = jsupernet.init_supernet(jax.random.key(seed), sp, channels=16)
    rs = np.random.RandomState(seed)
    arch = {"alpha": rs.randn(sp.n_blocks, sp.n_ops).astype(np.float32),
            "beta": rs.randn(sp.n_blocks, sp.n_quant).astype(np.float32)}
    op_idx, q_idx = jsupernet.sample_paths(jax.random.key(seed + 1),
                                           _j(arch), sp)
    b = next(batches(SquiggleConfig(chunk_len=96, seed=seed), 2))
    return _np(jp), arch, np.array(op_idx), np.array(q_idx), b


@functools.lru_cache(maxsize=None)
def _jsupernet_grad():
    """The reference's supernet CTC value-and-grad (and log-probs),
    jitted once with the sampled paths and the batch as arguments."""
    def obj(pp, aa, b, op_idx, q_idx):
        lp = jsupernet.supernet_forward(pp, aa, b["signal"], op_idx, q_idx,
                                        jspace.TINY_SPACE)
        return jctc_loss(lp, b["labels"], b["label_lengths"]), lp
    return jax.jit(jax.value_and_grad(obj, argnums=(0, 1), has_aux=True))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_supernet_forward_and_grads_match_reference(seed):
    """The same sampled paths through both supernets: log-probs 1e-5;
    the CTC loss's gradients with respect to the params and the arch
    logits 1e-4 of each tree's largest."""
    p, arch, op_idx, q_idx, b = _supernet_case(seed)
    (wl, want), (wgp, wga) = _jsupernet_grad()(
        _j(p), _j(arch), _j(b), jnp.asarray(op_idx), jnp.asarray(q_idx))
    paths = (torch.from_numpy(op_idx), torch.from_numpy(q_idx))
    got = supernet.supernet_forward(_t(p), _t(arch), torch.from_numpy(
        b["signal"]), *paths, space.TINY_SPACE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=EXACT,
                               atol=EXACT)

    def tobj(both):
        lp = supernet.supernet_forward(both["p"], both["a"],
                                       torch.from_numpy(b["signal"]),
                                       *paths, space.TINY_SPACE)
        return ctc_loss(lp, torch.from_numpy(b["labels"]),
                        torch.from_numpy(b["label_lengths"])), ()
    (gl, _), gg = api.value_and_grad(tobj, {"p": _t(p), "a": _t(arch)})
    assert float(gl) == pytest.approx(float(wl), rel=EXACT)
    _close_grads(gg["p"], wgp, 1e-4)
    _close_grads(gg["a"], wga, 1e-4)


def test_sample_paths_contract():
    sp = space.TINY_SPACE
    arch = _t({"alpha": np.random.RandomState(0).randn(
        sp.n_blocks, sp.n_ops).astype(np.float32),
        "beta": np.zeros((sp.n_blocks, sp.n_quant), np.float32)})
    draws = [supernet.sample_paths(torch.Generator().manual_seed(s), arch,
                                   sp) for s in (3, 3, 4)]
    for op_idx, q_idx in draws:
        assert op_idx.shape == (sp.n_blocks, 2) and q_idx.shape == (
            sp.n_blocks, 2)
        assert (op_idx[:, 0] != op_idx[:, 1]).all()
        assert (q_idx[:, 0] != q_idx[:, 1]).all()
        assert ((0 <= op_idx) & (op_idx < sp.n_ops)).all()
        assert ((0 <= q_idx) & (q_idx < sp.n_quant)).all()
    assert all(torch.equal(a, b) for a, b in zip(draws[0], draws[1]))
    many = [supernet.sample_paths(torch.Generator().manual_seed(s), arch,
                                  sp)[0] for s in range(20)]
    assert len({tuple(m.flatten().tolist()) for m in many}) > 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_derive_config_matches_reference(seed):
    """The same arch logits derive the same config, field for field
    (identity ops drop their block)."""
    sp = jspace.TINY_SPACE
    rs = np.random.RandomState(seed)
    arch = {"alpha": rs.randn(sp.n_blocks, sp.n_ops).astype(np.float32),
            "beta": rs.randn(sp.n_blocks, sp.n_quant).astype(np.float32)}
    if seed == 3:                       # every block identity: one kept
        arch["alpha"][:, -1] = 10.0
    want = jsearch.derive_config(_j(arch), sp, channels=16)
    got = search.derive_config(_t(arch), space.TINY_SPACE, channels=16)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _data(chunk=96, batch=2):
    return batches(SquiggleConfig(chunk_len=chunk), batch)


def test_run_search_properties():
    qc = search.QABASConfig(steps=3, channels=16, chunk=96)
    params, arch, hist = search.run_search(
        torch.Generator().manual_seed(0), space.TINY_SPACE, qc, _data(),
        device="cpu")
    assert {k: len(v) for k, v in hist.items()} == {
        "w_loss": 3, "a_loss": 3, "latency": 3}
    assert all(np.isfinite(v).all() for v in hist.values())
    assert all(0 < lat < qc.target_latency for lat in hist["latency"])
    assert arch["alpha"].shape == (4, 4) and arch["beta"].shape == (4, 2)
    assert float(arch["alpha"].abs().sum()) > 0      # the arch step moved
    assert len(params["blocks"]) == 4 and not params["stem"].requires_grad
    again = search.run_search(torch.Generator().manual_seed(0),
                              space.TINY_SPACE, qc, _data(), device="cpu")
    assert again[2] == hist                           # same seed, same run
    cfg = search.derive_config(arch, space.TINY_SPACE, channels=16)
    assert cfg.family == "basecaller" and 1 <= cfg.n_blocks <= 4


def test_full_rubicon_workflow():
    """The paper's pipeline at smoke size on the port, as the reference's
    ``test_system.py::test_full_rubicon_workflow`` runs it: search,
    derive, one SkipClip step, prune, quantize."""
    qc = search.QABASConfig(steps=2, channels=16, chunk=96)
    _, arch, _ = search.run_search(None, space.TINY_SPACE, qc, _data(),
                                   device="cpu")
    student_cfg = search.derive_config(arch, space.TINY_SPACE, channels=16)
    t_cfg = get_config("bonito-smoke")
    t_params = api.init_params(torch.Generator().manual_seed(0), t_cfg)
    t_state = api.init_model_state(t_cfg)
    s_params = api.init_params(torch.Generator().manual_seed(3), student_cfg)
    s_state = api.init_model_state(student_cfg)
    loss_fn = skipclip.make_skipclip_loss(student_cfg, t_cfg,
                                          skipclip.SkipClipConfig())
    batch = _tb(next(_data()))
    gates = skipclip.gates_for_epoch(student_cfg.n_blocks, 2, 1)
    (loss, (m, _)), grads = api.value_and_grad(
        loss_fn, s_params, s_state, t_params, t_state, batch, gates)
    assert np.isfinite(float(loss)) and float(m["kd"]) >= 0
    assert max(float(g.abs().max()) for _, g in tree_items(grads)) > 0
    mask = pruning.unstructured_mask(s_params, 0.3)
    pruned = pruning.apply_mask(s_params, mask)
    q = quantize_tree(pruned, student_cfg.quant, min_size=64)
    assert tree_size_bytes(q) < tree_size_bytes(s_params)
