"""Basecaller forward parity: the PyTorch port against the JAX package.

Weights come from the JAX init, rescaled to unit gain (the init's
per-block gain of 0.12-0.35 would shrink the activations until every
comparison is trivially tiny), and are bridged through numpy, so both
packages run the same weights on the same inputs.

Tolerances, with their reasons:

- 1e-5 on log-probs (and BN state) wherever no activation quantizer can
  flip: the two packages differ only in fp32 summation order (observed
  max 5e-7).
- rubicall-smoke in train mode: 1e-2 on log-probs, 1e-3 on BN state.
  Its 8-bit activation fake-quant turns a 1e-7 difference of a value
  sitting on a grid half-step into a whole grid step, and train-mode
  BatchNorm renormalises it (observed max 4.5e-3 / 3.8e-4; the same run
  with the activation quantizers off differs by 4e-7).
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
from repro.models.basecaller import model as jbc
from repro.models.basecaller.ctc import greedy_decode as jgreedy_decode
from repro_torch import bridge
from repro_torch.config import QuantPolicy, get_config
from repro_torch.models.basecaller import model as bc
from repro_torch.models.basecaller.ctc import greedy_decode

EXACT = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def unit_gain(params):
    """Rescale each separable conv's taps (numpy tree, in place)."""
    for name, blk in params.items():
        if not name.startswith("block"):
            continue
        for rep in blk.values():
            if isinstance(rep, dict) and "dw" in rep:
                dw, pw = rep["dw"], rep["pw"]
                rep["dw"] = dw / (dw.std() * dw.shape[0] ** 0.5)
                rep["pw"] = pw * (2.0 / pw.shape[1]) ** 0.5 / pw.std()


def models(name, *, quant=None, packed=False, seed=0):
    """(jax cfg, port cfg, jax params, jax state, port params, port
    state); ``quant=(w, a)`` replaces the config's policy, ``packed``
    quantizes every conv leaf to int8 (min_size=1) for serving."""
    jcfg, tcfg = jget_config(name), get_config(name)
    if quant is not None:
        jcfg = dataclasses.replace(jcfg, quant=JQuantPolicy(*quant))
        tcfg = dataclasses.replace(tcfg, quant=QuantPolicy(*quant))
    p = _np(jbc.init_params(jax.random.key(seed), jcfg))
    unit_gain(p)
    jp = jax.tree.map(jnp.asarray, p)
    if packed:
        jp = jquantize_tree(jp, JQuantPolicy(8, 0), min_size=1)
    js = jbc.init_state(jcfg)
    return (jcfg, tcfg, jp, js,
            bridge.from_numpy_tree(_np(jp), device="cpu"),
            bridge.from_numpy_tree(_np(js), device="cpu"))


def _leaves(tree):
    """Torch state leaves in jax.tree.leaves order (sorted dict keys)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def both_forward(name, *, train, quant=None, packed=False, gates=None,
                 S=300, seed=0):
    jcfg, tcfg, jp, js, tp, ts = models(name, quant=quant, packed=packed,
                                        seed=seed)
    x = np.random.RandomState(seed).randn(2, S, 1).astype(np.float32)
    g = None if gates is None else np.asarray(gates, np.float32)
    jlp, jst = jbc.forward(jp, js, jnp.asarray(x), jcfg, train=train,
                           skip_gates=None if g is None else jnp.asarray(g))
    tlp, tst = bc.forward(tp, ts, torch.from_numpy(x), tcfg, train=train,
                          skip_gates=None if g is None
                          else torch.from_numpy(g))
    return (np.asarray(jlp), tlp.numpy(), jax.tree.leaves(jst),
            [t.numpy() for t in _leaves(tst)])


def _close(a, b, tol):
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["rubicall", "bonito", "causalcall",
                                  "rubicall-smoke", "bonito-smoke",
                                  "causalcall-smoke"])
def test_configs_match_reference(name):
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(jget_config(name))


def test_packed_rubicall_takes_kernel_route_on_the_same_blocks(monkeypatch):
    """Serving weights (every block at 8 bits, packed int8), eval mode:
    the fused qconv1d route fires on exactly the blocks where the JAX
    package fires it, and the log-probs agree."""
    import repro.kernels.ops as jops
    import repro_torch.kernels.ops as tops
    seen = {"jax": [], "torch": []}

    def spy(who, real):
        def call(x, dw, pw, *a, **k):
            seen[who].append((dw.orig_shape[0], x.shape[-1]))
            return real(x, dw, pw, *a, **k)
        return call
    monkeypatch.setattr(jops, "qconv1d_block",
                        spy("jax", jops.qconv1d_block))
    monkeypatch.setattr(tops, "qconv1d_block",
                        spy("torch", tops.qconv1d_block))
    jlp, tlp, _, _ = both_forward("rubicall-smoke", train=False,
                                  quant=(8, 8), packed=True)
    # blocks 01-03 (k 9, 25, 25; C=32); the stride-3 stem never fuses
    assert seen["torch"] == seen["jax"] == [(9, 32), (25, 32), (25, 32)]
    _close(tlp, jlp, EXACT)


@pytest.mark.parametrize("train", [False, True])
def test_rubicall_smoke_unpacked(train):
    """Float weights under rubicall's own mixed-precision policy (weight
    and activation fake-quant), with BN state updates in train mode."""
    jlp, tlp, jst, tst = both_forward("rubicall-smoke", train=train)
    lp_tol, st_tol = (1e-2, 1e-3) if train else (EXACT, EXACT)
    _close(tlp, jlp, lp_tol)
    assert len(jst) == len(tst)
    for a, b in zip(jst, tst):
        _close(b, np.asarray(a), st_tol)


@pytest.mark.parametrize("train", [False, True])
def test_bonito_smoke_skips_with_gates(train):
    """Skip branches gated strictly between 0 and 1 (SkipClip mid-anneal)."""
    jlp, tlp, jst, tst = both_forward("bonito-smoke", train=train,
                                      gates=[0.3, 0.7, 0.5, 0.9])
    _close(tlp, jlp, EXACT)
    for a, b in zip(jst, tst):
        _close(b, np.asarray(a), EXACT)


@pytest.mark.parametrize("train", [False, True])
def test_causalcall_smoke(train):
    """Dilated causal convs with residual skips."""
    jlp, tlp, jst, tst = both_forward("causalcall-smoke", train=train)
    _close(tlp, jlp, EXACT)
    for a, b in zip(jst, tst):
        _close(b, np.asarray(a), EXACT)


def test_forward_window_per_row_bounds():
    """One batched serving window with per-row (B,) read bounds: a read
    head (negative start), a mid-read window, and an idle row."""
    jcfg, tcfg, jp, js, tp, ts = models("rubicall-smoke", quant=(8, 8),
                                        packed=True)
    halo = bc.chunk_halo(tcfg)
    W = 300 + 2 * halo
    x = np.random.RandomState(3).randn(3, W, 1).astype(np.float32)
    start = np.array([-halo, 300 - halo, 0], np.int32)
    rlen = np.array([450, 900, 0], np.int32)
    want = np.asarray(jbc.forward_window(jp, js, jnp.asarray(x), jcfg,
                                         jnp.asarray(start),
                                         jnp.asarray(rlen)))
    got = bc.forward_window(tp, ts, torch.from_numpy(x), tcfg,
                            torch.from_numpy(start), torch.from_numpy(rlen))
    _close(got.numpy(), want, EXACT)


@pytest.mark.parametrize("name", ["rubicall", "bonito", "causalcall",
                                  "rubicall-smoke", "bonito-smoke",
                                  "causalcall-smoke"])
def test_chunk_geometry_matches(name):
    jcfg, tcfg = jget_config(name), get_config(name)
    assert bc.total_stride(tcfg) == jbc.total_stride(jcfg)
    assert bc.receptive_field(tcfg) == jbc.receptive_field(jcfg)
    assert bc.chunk_halo(tcfg) == jbc.chunk_halo(jcfg)
    sig = np.random.RandomState(1).randn(2345).astype(np.float32)
    st, halo = bc.total_stride(tcfg), bc.chunk_halo(tcfg)
    want = jbc.chunk_windows(sig, 600, halo, st)
    got = bc.chunk_windows(sig, 600, halo, st)
    assert [(n, s) for _, n, s in got] == [(n, s) for _, n, s in want]
    for (a, _, _), (b, _, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_greedy_decode_tokens_equal():
    """Greedy CTC over each package's own log-probs: identical calls."""
    jlp, tlp, _, _ = both_forward("bonito-smoke", train=False, S=900)
    want = jgreedy_decode(jnp.asarray(jlp))
    got = greedy_decode(tlp)
    assert [list(a) for a in got] == [list(b) for b in want]
    assert sum(len(a) for a in got) > 0
