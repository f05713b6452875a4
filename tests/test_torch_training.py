"""Training parity: the port's CTC loss, basecaller loss, AdamW, train
step, gradient compression, checkpoints, training loop, launcher and
identity harness against the JAX package's, on the same numpy inputs
and bridged weights (smoke size, CPU).

Tolerances, with their reasons:

- CTC loss: 1e-5 relative. Gradients with respect to the logits (never
  ``log_probs``: PyTorch's CTC backward returns ``exp(lp) - gamma``,
  which equals the true ``-gamma`` only through ``log_softmax``'s
  backward): ``ctc_loss_ref`` at 1e-5; ``F.ctc_loss`` at four fp32 ulps
  of the largest per-row log-likelihood, since its fp32 backward forms
  ``exp(lp + log alpha + log beta - ll)`` (observed 2.2e-4 at T=683,
  |ll| ~ 964, where the reference is within 1.8e-5 of float64).
  Every label of these cases fits its T frames; a row whose alignment
  cannot exist (``F.ctc_loss``: ``inf``) takes the reference's ~1e30
  and its gradient, held at 1e-5 in its own test.
- ``loss_fn`` with the activation quantizers off: loss 1e-5 relative,
  BatchNorm state 1e-5, each gradient leaf within 2e-4 of the tree's
  largest gradient (observed up to 5e-5: ``F.ctc_loss``'s fp32
  backward, carried through the net; the stem's pointwise conv feeds
  train-mode BatchNorm, which cancels its per-channel scale, so its
  own gradient is pure cancellation noise and no per-leaf relative
  bound can hold).
- rubicall-smoke's own policy (8-bit activation fake-quant on): a 1e-7
  difference of a value on a grid half-step flips it one grid step
  (1/127 of the tensor's max), and train-mode BatchNorm spreads it.
  The batch of seed 5 has such a flip (loss 2.5e-5 relative, BN state
  9.6e-5, gradients 1.4e-3 of the tree's max): bounds 2e-4, 1e-3 and
  1e-2.
- AdamW: 1e-6 relative on params and fp32 moments (same fp32 formula);
  int8 moments exact on all but a rounding tie, at most one code.
- Train steps and the 20-step trajectory: see each test.
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
from repro.models import api as japi
from repro.models.basecaller import model as jbc
from repro.models.basecaller.ctc import ctc_loss as jctc_loss
from repro.training import optimizer as jopt
from repro_torch import bridge
from repro_torch.config import QuantPolicy, get_config
from repro_torch.core.quant.policy import tree_items
from repro_torch.data.squiggle import SquiggleConfig, batches
from repro_torch.models import api
from repro_torch.models.basecaller import model as bc
from repro_torch.models.basecaller.ctc import ctc_loss, ctc_loss_ref
from repro_torch.training import evaluate
from repro_torch.training import optimizer as opt
from test_torch_basecaller import unit_gain

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jflat(tree):
    """'/'-keyed numpy leaves of a JAX tree (the port's tree_items keys)."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    return {k: v.detach().numpy() for k, v in tree_items(tree)}


def _close_tree(got, want, rtol, atol):
    got, want = _tflat(got), _jflat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _close_grads(got, want, frac):
    """Every leaf within ``frac`` of the tree's largest |gradient|."""
    got, want = _tflat(got), _jflat(want)
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=frac * scale, err_msg=k)


def _cfgs(name, act_quant=True):
    """(JAX cfg, port cfg); ``act_quant=False`` keeps the weight bits
    and turns every activation quantizer off."""
    jcfg, tcfg = jget_config(name), get_config(name)
    if not act_quant:
        q = tcfg.quant
        ov = tuple((p, (w, 0)) for p, (w, _) in q.overrides)
        jcfg = dataclasses.replace(jcfg, quant=JQuantPolicy(
            q.weight_bits, 0, overrides=ov))
        tcfg = dataclasses.replace(tcfg, quant=QuantPolicy(
            q.weight_bits, 0, overrides=ov))
    return jcfg, tcfg


def _init(jcfg, seed=0):
    """JAX init at unit gain and its BN state, as numpy trees."""
    p = _np(jbc.init_params(jax.random.key(seed), jcfg))
    unit_gain(p)
    return p, _np(jbc.init_state(jcfg))


def _batch(S=512, B=4, seed=3):
    return next(batches(SquiggleConfig(chunk_len=S, seed=seed), B))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return bridge.from_numpy_tree(tree, device="cpu")


# ---------------------------------------------------------------------------
# CTC


def _ctc_case(B, T, L, seed):
    rs = np.random.RandomState(seed)
    z = (3 * rs.randn(B, T, 5)).astype(np.float32)
    lens = rs.randint(max(L // 2, 1), L + 1, size=B).astype(np.int32)
    lens[0] = L
    labels = np.zeros((B, L), np.int32)
    for b in range(B):
        labels[b, :lens[b]] = rs.randint(1, 5, size=lens[b])
    assert T >= 2 * L + 1                       # every alignment exists
    return z, labels, lens


@pytest.mark.parametrize("fn", [ctc_loss, ctc_loss_ref],
                         ids=["F.ctc_loss", "ctc_loss_ref"])
@pytest.mark.parametrize("B,T,L", [(3, 40, 8), (4, 170, 57), (2, 683, 200),
                                   (2, 9, 1)])
def test_ctc_loss_and_logit_grads_match_reference(fn, B, T, L):
    z, labels, lens = _ctc_case(B, T, L, seed=T)

    def jloss(zz):
        return jctc_loss(jax.nn.log_softmax(zz, -1), jnp.asarray(labels),
                         jnp.asarray(lens))
    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    got = fn(torch.log_softmax(zt, -1), torch.from_numpy(labels),
             torch.from_numpy(lens))
    (g,) = torch.autograd.grad(got, zt)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    # per-row log-likelihoods bound F.ctc_loss's fp32 backward (docstring)
    ll = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(z), -1).transpose(0, 1),
        torch.from_numpy(labels).long(), torch.full((B,), T),
        torch.from_numpy(lens).long(), reduction="none")
    atol = 1e-5 if fn is ctc_loss_ref else 4 * float(ll.max()) * 2 ** -23
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=0,
                               atol=max(atol, 1e-5))


def test_ctc_loss_is_not_normalised_by_label_length():
    """The reference's ``-mean(ll)``, not ``reduction='mean'``."""
    z, labels, lens = _ctc_case(3, 60, 12, seed=1)
    lp = torch.log_softmax(torch.from_numpy(z), -1)
    per_row = torch.nn.functional.ctc_loss(
        lp.transpose(0, 1), torch.from_numpy(labels).long(),
        torch.full((3,), 60), torch.from_numpy(lens).long(),
        reduction="none")
    got = ctc_loss(lp, torch.from_numpy(labels), torch.from_numpy(lens))
    assert float(got) == pytest.approx(float(per_row.mean()), rel=1e-6)
    assert float(got) != pytest.approx(float((per_row / torch.from_numpy(
        lens)).mean()), rel=1e-3)


@pytest.mark.parametrize("fn", [ctc_loss, ctc_loss_ref],
                         ids=["F.ctc_loss", "ctc_loss_ref"])
def test_ctc_unalignable_row_takes_the_reference_value(fn):
    """B 2, T 4, V 5: row 0's 6 labels cannot align to 4 frames, row 1's
    2 can. The loss (about 5e29, finite) at 1e-5 relative and the logit
    gradients at 1e-5, both against the reference, as above."""
    z = (3 * np.random.RandomState(4).randn(2, 4, 5)).astype(np.float32)
    labels = np.array([[1, 2, 3, 4, 1, 2], [3, 1, 0, 0, 0, 0]], np.int32)
    lens = np.array([6, 2], np.int32)

    def jloss(zz):
        return jctc_loss(jax.nn.log_softmax(zz, -1), jnp.asarray(labels),
                         jnp.asarray(lens))
    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    got = fn(torch.log_softmax(zt, -1), torch.from_numpy(labels),
             torch.from_numpy(lens))
    (g,) = torch.autograd.grad(got, zt)
    assert np.isfinite(float(got.detach())) and float(got.detach()) > 1e29
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-5)


def test_train_step_on_an_unalignable_row_stays_finite():
    """rubicall-smoke (stride 3): 96 samples give 32 frames, too few for
    row 0's 40 labels. One train step leaves every parameter finite."""
    cfg = get_config("rubicall-smoke")
    p = api.init_params(torch.Generator().manual_seed(0), cfg)
    rs = np.random.RandomState(0)
    labels = rs.randint(1, 5, (2, 40)).astype(np.int32)
    labels[1, 8:] = 0
    batch = {"signal": torch.from_numpy(rs.randn(2, 96, 1).astype(
                 np.float32)),
             "labels": torch.from_numpy(labels),
             "label_lengths": torch.tensor([40, 8], dtype=torch.int32)}
    oc = opt.AdamWConfig(lr=5e-3, total_steps=2, warmup_steps=0)
    carry = api.TrainCarry(p, opt.init_opt_state(p, oc),
                           api.init_model_state(cfg))
    carry, m = api.make_train_step(cfg, oc)(carry, batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    for k, v in tree_items(carry.params):
        assert torch.isfinite(v).all(), k


# ---------------------------------------------------------------------------
# loss_fn


@pytest.mark.parametrize("name,act_quant,gates,seed", [
    ("rubicall-smoke", False, None, 3),
    ("bonito-smoke", False, [0.0, 1.0, 0.5, 0.25], 3),
    ("rubicall-smoke", True, None, 3),
    ("rubicall-smoke", True, None, 5),
])
def test_loss_fn_value_grads_and_state_match_reference(name, act_quant,
                                                       gates, seed):
    jcfg, tcfg = _cfgs(name, act_quant)
    p, s = _init(jcfg)
    b = _batch(seed=seed)
    g = None if gates is None else np.asarray(gates, np.float32)

    def jloss(pp, ss, bb):
        return jbc.loss_fn(pp, ss, bb, jcfg, skip_gates=None if g is None
                           else jnp.asarray(g))
    (wl, (_, ws)), wg = jax.value_and_grad(jloss, has_aux=True)(
        _j(p), _j(s), _j(b))

    def tloss(pp, ss, bb):
        return bc.loss_fn(pp, ss, bb, tcfg, skip_gates=None if g is None
                          else torch.from_numpy(g))
    (tl, (tm, ts)), tg = api.value_and_grad(
        tloss, _t(p), _t(s), {k: torch.from_numpy(v) for k, v in b.items()})
    loss_tol, state_tol, grad_tol = ((1e-5, 1e-5, 2e-4) if not act_quant
                                     else (2e-4, 1e-3, 1e-2))
    assert float(tl) == pytest.approx(float(wl), rel=loss_tol)
    assert float(tm["ctc_loss"]) == float(tl)
    _close_tree(ts, ws, state_tol, state_tol)
    _close_grads(tg, wg, grad_tol)
    assert all(not v.requires_grad for _, v in tree_items(ts))


# ---------------------------------------------------------------------------
# AdamW


def _rand_tree(rs, scale=1.0):
    return {"a": {"k": (scale * rs.randn(3, 5, 7)).astype(np.float32)},
            "b": (scale * rs.randn(11)).astype(np.float32),
            "c": [{"w": (scale * rs.randn(4, 4)).astype(np.float32)}]}


@pytest.mark.parametrize("state_bits", [0, 8])
def test_adamw_update_matches_reference(state_bits):
    rs = np.random.RandomState(state_bits)
    p = _rand_tree(rs)
    cfg = dict(lr=3e-2, warmup_steps=2, total_steps=10, weight_decay=0.05,
               clip_norm=1.5, state_bits=state_bits)
    jc, tc = jopt.AdamWConfig(**cfg), opt.AdamWConfig(**cfg)
    jp, tp = _j(p), _t(p)
    js, ts = jopt.init_opt_state(jp, jc), opt.init_opt_state(tp, tc)
    for i in range(4):
        g = _rand_tree(rs, scale=0.1 + i)
        jp, js, jm = jopt.adamw_update(jp, _j(g), js, jc)
        tp, ts, tm = opt.adamw_update(tp, _t(g), ts, tc)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    _close_tree(tp, jp, 1e-6, 1e-7)
    assert int(ts.step) == int(js.step) == 4 and ts.step.dtype == torch.int32
    if state_bits == 8:
        for got, want in ((ts.m, js.m), (ts.v, js.v)):
            for k, w in _jflat(want).items():
                d = np.abs(_tflat(got)[k].astype(np.int32) - w.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() < 0.05, k
        _close_tree(ts.m_scale, js.m_scale, 1e-6, 0)
        _close_tree(ts.v_scale, js.v_scale, 1e-6, 0)
    else:
        # atol: m nears zero where 0.9 m and 0.1 g cancel
        _close_tree(ts.m, js.m, 1e-6, 1e-7)
        _close_tree(ts.v, js.v, 1e-6, 1e-9)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_schedule_lr_matches_reference_over_many_steps(schedule):
    cfg = dict(lr=2e-3, warmup_steps=100, total_steps=1000,
               schedule=schedule)
    steps = np.arange(0, 1201, 7, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jopt.schedule_lr(
        jopt.AdamWConfig(**cfg), s))(jnp.asarray(steps)))
    got = opt.schedule_lr(opt.AdamWConfig(**cfg), torch.from_numpy(steps))
    # atol: near the end of the cosine, 1 + cos(pi * frac) cancels
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-7 * cfg["lr"])


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _rand_tree(np.random.RandomState(7))
    wg, wn = jopt.clip_by_global_norm(_j(g), max_norm)
    tg, tn = opt.clip_by_global_norm(_t(g), max_norm)
    assert float(tn) == pytest.approx(float(wn), rel=1e-6)
    _close_tree(tg, wg, 1e-6, 0)


# ---------------------------------------------------------------------------
# Train step


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    """One step of ``make_train_step`` (activation quantizers off, so
    only fp32 order differs): loss 1e-5 relative, grad norm 1e-4
    (``F.ctc_loss``'s fp32 backward, module docstring), BN state 1e-5,
    the first moments at the gradient tolerance, and every updated param
    within 1e-3 of the learning rate: Adam's first step moves a weight
    by lr * g / (|g| + eps). A weight whose gradient is within the
    gradient tolerance of zero (below 1e-4 of the tree's largest, e.g.
    all of the stem's pointwise conv, whose exact gradient is zero
    because train-mode BatchNorm cancels its per-channel scale) moves by
    lr times a ratio of fp32 noise in either package; there only the
    bound of one step, 2 lr, holds."""
    jcfg, tcfg = _cfgs("rubicall-smoke", act_quant=False)
    p, s = _init(jcfg)
    b = _batch(B=4)
    ocfg = dict(lr=5e-3, total_steps=20, warmup_steps=0)
    jc, tc = jopt.AdamWConfig(**ocfg), opt.AdamWConfig(**ocfg)
    jcarry = japi.TrainCarry(_j(p), jopt.init_opt_state(_j(p), jc), _j(s))
    tcarry = api.TrainCarry(_t(p), opt.init_opt_state(_t(p), tc), _t(s))
    jcarry, jm = jax.jit(japi.make_train_step(jcfg, jc, n_micro))(
        jcarry, _j(b))
    tcarry, tm = api.make_train_step(tcfg, tc, n_micro)(
        tcarry, {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(tm) == set(jm)
    for k, rel in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6)):
        assert tm[k].ndim == 0
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rel)
    _close_tree(tcarry.model_state, jcarry.model_state, 1e-5, 1e-5)
    m = _jflat(jcarry.opt_state.m)
    scale = max(float(np.abs(v).max()) for v in m.values())
    _close_tree(tcarry.opt_state.m, jcarry.opt_state.m, 0, 1e-4 * scale)
    got = _tflat(tcarry.params)
    for k, want in _jflat(jcarry.params).items():
        atol = np.where(np.abs(m[k]) < 1e-4 * scale, 2, 1e-3) * ocfg["lr"]
        assert (np.abs(got[k] - want) <= atol).all(), k


def test_train_step_microbatches_average_the_whole_batch():
    """n_micro=2 on a batch equals the mean of the two halves' losses,
    the BN state threaded through both halves in order."""
    cfg = get_config("bonito-smoke")
    p = api.init_params(torch.Generator().manual_seed(0), cfg)
    st = api.init_model_state(cfg)
    b = {k: torch.from_numpy(v) for k, v in _batch(B=4).items()}
    loss_fn = api.make_loss_fn(cfg)
    _, loss, st2 = api.microbatch_grads(loss_fn, p, st, b, 2)
    (l0, (_, s0)), _ = api.value_and_grad(
        loss_fn, p, st, {k: v[:2] for k, v in b.items()})
    (l1, (_, s1)), _ = api.value_and_grad(
        loss_fn, p, s0, {k: v[2:] for k, v in b.items()})
    assert float(loss) == pytest.approx((float(l0) + float(l1)) / 2,
                                        rel=1e-6)
    for (k, a), (_, c) in zip(tree_items(st2), tree_items(s1)):
        assert torch.equal(a, c), k


def test_make_loss_fn_refuses_lm_families():
    """A family with no layer plan raises and names itself; a ported one
    (qwen1.5-4b-smoke) gives the reference's loss on a bridged init
    (1e-5 relative; ``tests/test_torch_lm_training.py`` holds every
    family's loss and gradients)."""
    qwen = get_config("qwen1.5-4b-smoke")
    with pytest.raises(NotImplementedError, match="speech"):
        api.make_loss_fn(dataclasses.replace(qwen, family="speech"))
    jcfg = jget_config("qwen1.5-4b-smoke")
    jp = japi.init_params(jax.random.key(0), jcfg)
    rs = np.random.RandomState(0)
    b = {k: rs.randint(0, qwen.vocab_size, (2, 16)).astype(np.int32)
         for k in ("tokens", "labels")}
    want, _ = japi.make_loss_fn(jcfg)(jp, {}, _j(b))
    got, (metrics, state) = api.make_loss_fn(qwen)(
        _t(_np(jp)), {}, {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert set(metrics) == {"ce"} and state == {}


def test_n_microbatches_matches_reference():
    for args in [(8, 2048), (64, 2048, 8), (3, 70000), (48, 65536, 4)]:
        assert api.n_microbatches(get_config("rubicall"), *args) == \
            japi.n_microbatches(jget_config("rubicall"), *args)


def test_twenty_steps_follow_the_reference_trajectory():
    """rubicall-smoke under its own policy (activation fake-quant on),
    bridged init, the reference harness's batches: 20 losses within
    5e-3 relative of the reference's (observed 3.5e-4), falling as its
    do. A grid-step flip of an activation moves one step's loss by
    ~1e-4 relative, and each step's update carries it into the next."""
    jcfg, tcfg = _cfgs("rubicall-smoke")
    p, s = _init(jcfg, seed=1)
    ocfg = dict(lr=5e-3, total_steps=20, warmup_steps=3)
    jc, tc = jopt.AdamWConfig(**ocfg), opt.AdamWConfig(**ocfg)
    jcarry = japi.TrainCarry(_j(p), jopt.init_opt_state(_j(p), jc), _j(s))
    tcarry = api.TrainCarry(_t(p), opt.init_opt_state(_t(p), tc), _t(s))
    jstep = jax.jit(japi.make_train_step(jcfg, jc))
    tstep = api.make_train_step(tcfg, tc)
    it = evaluate.data_iter(0)
    want, got = [], []
    for _ in range(20):
        b = next(it)
        jcarry, jm = jstep(jcarry, _j(b))
        tcarry, tm = tstep(tcarry, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, rtol=5e-3)
    assert np.mean(got[-5:]) < np.mean(got[:5])
