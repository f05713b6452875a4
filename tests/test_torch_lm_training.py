"""LM training parity: the port's token stream, cross-entropy, blockwise
attention, chunked SSD, training forward (dense, MoE with its aux loss,
MLA with the MTP head, SSM), loss, training loop and LM checkpoints
against the JAX package's, on the same numpy inputs and bridged weights
(smoke size, fp32, CPU).

Tolerances, with their reasons (both sides fp32; only the order of
fp32 sums differs):

- Loss and metrics: 1e-5 relative (observed under 3e-7).
- Gradients: every leaf within 1e-5 of the tree's largest |gradient|
  (observed 2.5e-7 of it: ~1e-8 absolute against ~0.05).
- ``blockwise_attn``: outputs and input gradients 1e-5 (values of order
  1; observed ~1e-7).
- Chunked SSD gradients at chunk 32 against the reference's: 1e-4 of
  the largest |gradient| (a cumsum over 32 steps and exponentials of
  its differences).
- The 20-step trajectory: 5e-3 relative, the basecaller trajectory's
  bound (``tests/test_torch_training.py``).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.config import get_config as jget_config
from repro.data.tokens import token_batches as jtoken_batches
from repro.models import api as japi
from repro.models.lm import attention as jattn
from repro.models.lm import ssm as jssm
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_loop as jtrain_loop
from repro_torch.config import get_config
from repro_torch.core.quant.policy import tree_items, tree_map
from repro_torch.data.tokens import token_batches
from repro_torch.kernels import ref
from repro_torch.models import api
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm.common import cross_entropy
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop
from repro_torch.training.checkpoint import leaf_items
from test_torch_training import _close_tree, _j, _jflat, _np, _t, _tflat

ARCHS = ["qwen1.5-4b-smoke", "granite-moe-1b-a400m-smoke",
         "deepseek-v3-671b-smoke", "mamba2-130m-smoke"]


def _bridged(arch, seed=0):
    """(JAX cfg, port cfg, JAX params, port params) from one JAX init."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jp = japi.init_params(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, _t(_np(jp))


def _batch(cfg, B=2, S=64, seed=1):
    rs = np.random.RandomState(seed)
    return {k: rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The loss and every gradient leaf


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_metrics_and_grads_match_reference(arch):
    """dense (QKV bias), MoE (aux loss, the router's gradient through
    the gates and the load-balance term), MLA + MoE + MTP, SSM."""
    jcfg, tcfg, jp, tp = _bridged(arch)
    b = _batch(tcfg)
    (wl, (wm, _)), wg = jax.jit(jax.value_and_grad(
        japi.make_loss_fn(jcfg), has_aux=True))(jp, {}, _j(b))
    (tl, (tm, _)), tg = api.value_and_grad(api.make_loss_fn(tcfg), tp, {},
                                           _torch(b))
    assert float(tl) == pytest.approx(float(wl), rel=1e-5)
    assert set(tm) == set(wm)
    for k in wm:
        assert float(tm[k]) == pytest.approx(float(wm[k]), rel=1e-5), k
    got, want = _tflat(tg), _jflat(wg)
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    if tcfg.n_experts:
        router = [k for k in want if k.endswith("router/kernel")]
        assert router and all(np.abs(got[k]).max() > 0 for k in router)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_init_tree_matches_reference_layout(arch):
    """Training's fp32 init holds the reference's tree: every leaf's key
    and shape, the ``mtp`` head included; serving's draw keeps
    ``cfg.dtype``."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda: japi.init_params(jax.random.key(0),
                                                     jcfg))
    want = {"/".join(str(k.key) for k in path): leaf.shape for path, leaf
            in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tp = api.init_params(torch.Generator().manual_seed(0), tcfg,
                         dtype=torch.float32)
    got = {k: tuple(v.shape) for k, v in tree_items(tp)}
    assert got == want
    assert all(v.dtype == torch.float32 for _, v in tree_items(tp))
    assert ("mtp" in tp) == bool(tcfg.mtp_depth)
    big = replace(tcfg, dtype="bfloat16")
    served = api.init_params(torch.Generator().manual_seed(0), big)
    assert served["embed"].dtype == torch.bfloat16


def test_cross_entropy_matches_reference_with_ignored_labels():
    rs = np.random.RandomState(0)
    logits = (3 * rs.randn(2, 7, 11)).astype(np.float32)
    labels = rs.randint(0, 11, (2, 7)).astype(np.int32)
    labels[0, 2] = labels[1, 5] = -1
    from repro.models.lm.common import cross_entropy as jce
    ws, ww = jce(jnp.asarray(logits), jnp.asarray(labels))
    ts, tw = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert float(ts) == pytest.approx(float(ws), rel=1e-6)
    assert float(tw) == float(ww) == 12.0


@pytest.mark.parametrize("family", ["vlm", "audio", "hybrid"])
def test_unported_lm_families_raise_naming_what_is_missing(family):
    """Every family of the reference is ported now: vlm (internvl2-smoke,
    its patch positions cut off before the unembedding), audio
    (whisper-tiny-smoke, the frames through the training encoder) and
    hybrid (hymba-smoke) give the reference's loss on a bridged init,
    over the token stream's batches with their frontend stubs; a family
    with no layer plan raises and names itself."""
    arch = {"vlm": "internvl2-1b-smoke", "audio": "whisper-tiny-smoke",
            "hybrid": "hymba-1.5b-smoke"}[family]
    jcfg, tcfg, jp, tp = _bridged(arch)
    b = next(token_batches(tcfg, 2, 24, seed=1))
    want, _ = japi.make_loss_fn(jcfg)(jp, {}, _j(b))
    got, (metrics, _) = api.make_loss_fn(tcfg)(tp, {}, _torch(b))
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert set(metrics) == {"ce"}
    with pytest.raises(NotImplementedError, match="speech"):
        api.make_loss_fn(replace(tcfg, family="speech"))


# ---------------------------------------------------------------------------
# blockwise_attn


@pytest.mark.parametrize("case", [
    # B = 2, Sq = Sk = S; qc, kc: q_chunk, kv_chunk
    dict(S=48, H=4, Hkv=2, hd=16, hd_v=16, causal=True, qc=16, kc=16),
    dict(S=40, H=4, Hkv=4, hd=24, hd_v=16, causal=True, qc=8, kc=20),
    dict(S=48, H=4, Hkv=1, hd=16, hd_v=16, causal=False, qc=16, kc=24),
    dict(S=48, H=4, Hkv=2, hd=16, hd_v=16, causal=True, qc=16, kc=16,
         window=12),
    dict(S=30, H=2, Hkv=2, hd=8, hd_v=8, causal=True, qc=16, kc=16,
         window=64),
], ids=["causal_gqa", "hd_v", "full_mqa", "window", "window_wide"])
def test_blockwise_attn_matches_reference(case):
    """Forward and the gradient of a weighted sum with respect to q, k
    and v: causal (the triangular schedule skips chunks past the
    diagonal), non-causal, windowed, and a value width other than the
    query's (MLA's)."""
    rs = np.random.RandomState(case["S"])
    B, S, H, Hkv = 2, case["S"], case["H"], case["Hkv"]
    q = rs.randn(B, S, H, case["hd"]).astype(np.float32)
    k = rs.randn(B, S, Hkv, case["hd"]).astype(np.float32)
    v = rs.randn(B, S, Hkv, case["hd_v"]).astype(np.float32)
    w = rs.randn(B, S, H, case["hd_v"]).astype(np.float32)
    kw = dict(causal=case["causal"], window=case.get("window", 0),
              q_chunk=case["qc"], kv_chunk=case["kc"])

    def jf(q, k, v):
        return jnp.sum(jattn.blockwise_attn(q, k, v, **kw) * w)
    want, wg = jax.value_and_grad(jf, argnums=(0, 1, 2))(q, k, v)
    want_o = jattn.blockwise_attn(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attn.blockwise_attn(tq, tk, tv, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               rtol=1e-5, atol=1e-5)
    for got, ref_g in zip((tq.grad, tk.grad, tv.grad), wg):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_g),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The chunked SSD: the reference's gradient overflow, the port's masked
# exponent


def _ssd_inputs(dt_value, S=256, nh=4, hd=8, N=16, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(1, S, nh, hd).astype(np.float32)
    dt = np.full((1, S, nh), dt_value, np.float32)
    A = -np.linspace(1.0, 16.0, nh).astype(np.float32)
    Bm = rs.randn(1, S, N).astype(np.float32)
    Cm = rs.randn(1, S, N).astype(np.float32)
    D = np.ones(nh, np.float32)
    return x, dt, A, Bm, Cm, D


def _unmasked_ssd(x, dt, A, Bm, Cm, D, chunk):
    """The port's chunked SSD before the masked exponent, kept only to
    hold the new form to it bit for bit."""
    Bsz, S, nh, hd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    T = S // Q
    xr = x.reshape(Bsz, T, Q, nh, hd).float()
    dtr = dt.reshape(Bsz, T, Q, nh).float()
    Br = Bm.reshape(Bsz, T, Q, N).float()
    Cr = Cm.reshape(Bsz, T, Q, N).float()
    cum = torch.cumsum(dtr * A.float(), dim=2)
    total = cum[:, :, -1]
    G = torch.einsum("btqn,btsn->btqs", Cr, Br)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    M = G[..., None] * decay * dtr[:, :, None, :, :]
    M = torch.where(causal[None, None, :, :, None], M, torch.zeros_like(M))
    y_intra = torch.einsum("btqsh,btshd->btqhd", M, xr)
    w_state = torch.exp(total[:, :, None, :] - cum) * dtr
    S_chunk = torch.einsum("btqh,btqn,btqhd->bthdn", w_state, Br, xr)
    h = torch.zeros((Bsz, nh, hd, N))
    h_prevs = []
    for i in range(T):
        h_prevs.append(h)
        h = h * torch.exp(total[:, i])[:, :, None, None] + S_chunk[:, i]
    y_inter = torch.einsum("btqn,btqh,bthdn->btqhd", Cr, torch.exp(cum),
                           torch.stack(h_prevs, dim=1))
    y = y_intra + y_inter + D.float()[None, None, None, :, None] * xr
    return y.reshape(Bsz, S, nh, hd).to(x.dtype), h


def _jssd_grads(inputs, chunk):
    x, dt, A, Bm, Cm, D = (jnp.asarray(a) for a in inputs)

    def f(dt, A, x):
        y, h = jssm.ssd_chunked(x, dt, A, Bm, Cm, D, chunk)
        return jnp.sum(y ** 2) + jnp.sum(h ** 2)
    return jax.value_and_grad(f, argnums=(0, 1, 2))(dt, A, x)


def _tssd_grads(inputs, chunk):
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in inputs)
    dt, A, x = (t.requires_grad_() for t in (dt, A, x))
    y, h = ref.ssd_chunked(x, dt, A, Bm, Cm, D, chunk)
    loss = (y ** 2).sum() + (h ** 2).sum()
    return loss.detach(), torch.autograd.grad(loss, (dt, A, x))


def test_reference_ssd_gradient_overflows_at_chunk_256():
    """A fact of the reference, not a gate on it: at mamba2-130m's chunk
    of 256 and dt 0.1 its loss is finite and its gradients are not (the
    exponent above the diagonal reaches ~400 before the mask)."""
    loss, grads = _jssd_grads(_ssd_inputs(0.1), 256)
    assert np.isfinite(float(loss))
    assert not all(np.isfinite(np.asarray(g)).all() for g in grads[:2])


@pytest.mark.parametrize("chunk,dt", [(32, 0.01), (32, 0.1), (256, 0.01),
                                      (256, 0.1)])
def test_port_ssd_forward_is_bit_equal_to_the_unmasked_form(chunk, dt):
    args = [torch.from_numpy(a) for a in _ssd_inputs(dt)]
    y, h = ref.ssd_chunked(*args, chunk)
    y0, h0 = _unmasked_ssd(*args, chunk)
    assert torch.equal(y, y0) and torch.equal(h, h0)


@pytest.mark.parametrize("dt", [0.01, 0.1])
def test_port_ssd_gradients_finite_and_match_reference(dt):
    """Finite at chunk 256 where the reference's are not; equal to the
    reference's at chunk 32, where its are finite."""
    _, grads = _tssd_grads(_ssd_inputs(dt), 256)
    assert all(torch.isfinite(g).all() for g in grads)
    wl, wg = _jssd_grads(_ssd_inputs(dt), 32)
    tl, tg = _tssd_grads(_ssd_inputs(dt), 32)
    assert float(tl) == pytest.approx(float(wl), rel=1e-5)
    for got, want in zip(tg, wg):
        want = np.asarray(want)
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The token stream, the training loop and LM checkpoints


def test_token_batches_match_reference():
    cfg, jcfg = get_config("qwen1.5-4b-smoke"), jget_config("qwen1.5-4b-smoke")
    for seed in (0, 3):
        got, want = token_batches(cfg, 3, 40, seed), jtoken_batches(
            jcfg, 3, 40, seed)
        for _ in range(3):
            a, b = next(got), next(want)
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_twenty_lm_steps_of_train_loop_follow_the_reference(tmp_path):
    """qwen1.5-4b-smoke: both packages' ``train_loop.run`` resume from one
    step-0 checkpoint of the reference's init and train 20 steps on
    their token streams (same seed, same tokens): losses within 5e-3
    relative of the reference's, falling as its do."""
    jcfg, tcfg, jp, _ = _bridged("qwen1.5-4b-smoke", seed=2)
    ocfg = dict(lr=3e-3, total_steps=20, warmup_steps=3)
    jc, tc = jopt.AdamWConfig(**ocfg), opt.AdamWConfig(**ocfg)
    jckpt.CheckpointManager(str(tmp_path)).save(
        0, japi.TrainCarry(jp, jopt.init_opt_state(jp, jc), {}))
    loop = dict(steps=20, log_every=1, ckpt_every=1000,
                ckpt_dir=str(tmp_path))
    want = jtrain_loop.run(jcfg, jc, jtrain_loop.TrainLoopConfig(**loop),
                           jtoken_batches(jcfg, 4, 32))
    got = train_loop.run(tcfg, tc, train_loop.TrainLoopConfig(**loop),
                         token_batches(tcfg, 4, 32), device="cpu")
    wl = [r["loss"] for r in want["history"]]
    tl = [r["loss"] for r in got["history"]]
    assert len(tl) == len(wl) == 20
    np.testing.assert_allclose(tl, wl, rtol=5e-3)
    assert np.mean(tl[-5:]) < np.mean(tl[:5])
    _close_tree(got["carry"].params, want["carry"].params, 1e-2, 1e-4)


@pytest.mark.parametrize("arch", ["whisper-tiny-smoke", "internvl2-1b-smoke"])
def test_frontend_steps_on_the_stream_at_the_published_vocab(arch, tmp_path):
    """The audio and vlm smoke configs at their published (tied, for
    whisper) vocab: both packages' ``train_loop.run`` from one step-0
    checkpoint of the reference's init, 10 steps on their token streams
    (same seed: the same tokens and frontend stubs) at lr 2e-3 after 2
    warmup steps: losses within 5e-3 relative of the reference's. The
    reference's own losses stay within 0.1 of ln V, as on the card at
    full width: on the stream's ring of V tokens each step meets a few
    hundred new (token, next token) pairs, so 10 steps leave nothing to
    learn from, in either package."""
    V = get_config(arch.replace("-smoke", "")).vocab_size
    jcfg, tcfg = (replace(c, vocab_size=V)
                  for c in (jget_config(arch), get_config(arch)))
    jp = japi.init_params(jax.random.key(0), jcfg)
    ocfg = dict(lr=2e-3, total_steps=10, warmup_steps=2)
    jc, tc = jopt.AdamWConfig(**ocfg), opt.AdamWConfig(**ocfg)
    jckpt.CheckpointManager(str(tmp_path)).save(
        0, japi.TrainCarry(jp, jopt.init_opt_state(jp, jc), {}))
    loop = dict(steps=10, log_every=1, ckpt_every=1000,
                ckpt_dir=str(tmp_path))
    want = jtrain_loop.run(jcfg, jc, jtrain_loop.TrainLoopConfig(**loop),
                           jtoken_batches(jcfg, 2, 128))
    got = train_loop.run(tcfg, tc, train_loop.TrainLoopConfig(**loop),
                         token_batches(tcfg, 2, 128), device="cpu")
    wl = [r["loss"] for r in want["history"]]
    tl = [r["loss"] for r in got["history"]]
    assert len(tl) == len(wl) == 10
    np.testing.assert_allclose(tl, wl, rtol=5e-3)
    assert np.abs(np.asarray(wl) - np.log(V)).max() < 0.1


def test_lm_checkpoint_restores_bit_for_bit(tmp_path):
    """deepseek-v3-671b-smoke (MLA, MoE, the MTP head): 2 steps of
    ``train_loop.run`` checkpointed at step 2, restored into a zeroed
    carry: every leaf equal, dtype and all."""
    cfg = get_config("deepseek-v3-671b-smoke")
    oc = opt.AdamWConfig(lr=1e-3, total_steps=2)
    run = train_loop.run(cfg, oc, train_loop.TrainLoopConfig(
        steps=2, log_every=1, ckpt_every=2, ckpt_dir=str(tmp_path)),
        token_batches(cfg, 2, 16), device="cpu")
    carry = run["carry"]
    assert all(np.isfinite(r["loss"]) for r in run["history"])
    like = tree_map(torch.zeros_like, carry.params)
    step, restored = run["ckpt"].restore(api.TrainCarry(
        like, opt.init_opt_state(like, oc), {}))
    assert step == 2
    pairs = list(zip(leaf_items(restored), leaf_items(carry)))
    assert any("mtp" in k for (k, _), _ in pairs)
    for (k, a), (_, b) in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b), k
