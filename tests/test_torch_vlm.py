"""The vlm family (internvl2-1b-smoke: dense blocks over 8 projected
patch embeddings prepended to the tokens) and the last three dense
configs (chatglm3-6b, command-r-plus-104b, llama3-405b) in the port
against the JAX package, with what every LM config shares: the
registry's configs field by field, parameter counts from shapes, the
reference's prefill + decode == forward contract, the static path and
the token stream's frontend stubs.

The JAX init is bridged through numpy; fp32 throughout. On the CPU the
port's kernel wrappers run their plain versions, the JAX package its
XLA paths. Tolerances: values 1e-5 (fp32 on both sides; only the order
of fp32 sums differs, as in ``tests/test_torch_static.py``); the
decode contract 1e-4, the reference's own (``tests/test_decode.py``);
the loss 1e-5 relative, each gradient leaf within 1e-5 of the tree's
largest and one train step within ``tests/test_torch_training.py``'s
bounds. Tokens exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.config import get_config as jget_config
from repro.data.tokens import token_batches as jtoken_batches
from repro.models import api as japi
from repro.models.lm import encdec as jencdec
from repro.models.lm import transformer as jtfm
from repro.training import optimizer as jopt
from repro_torch.config import ASSIGNED_ARCHS, get_config
from repro_torch.data.tokens import token_batches
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models.lm import transformer as tfm
from repro_torch.training import optimizer as opt
from test_torch_training import _close_grads, _j, _jflat, _np, _t, _tflat

VLM = "internvl2-1b-smoke"
NEW = ["chatglm3-6b", "command-r-plus-104b", "llama3-405b", "internvl2-1b",
       "whisper-tiny"]
# the reference's count_params_analytic, worked out on the CPU
PARAMS = {"whisper-tiny": 36_439_680, "internvl2-1b": 494_583_808,
          "chatglm3-6b": 6_243_584_000,
          "command-r-plus-104b": 103_810_609_152,
          "llama3-405b": 405_853_388_800}


@functools.lru_cache(maxsize=None)
def models(arch):
    """(jax cfg, port cfg, jax params, port params), fp32."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jp = japi.init_params(jax.random.key(0), jcfg)
    return jcfg, tcfg, jp, _t(_np(jp))


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _batch(cfg, B=2, S=24, seed=0):
    """Tokens and labels (B, S - frontend_tokens for vlm) and the
    frontend stubs, numpy."""
    rs = np.random.RandomState(seed)
    P = cfg.frontend_tokens if cfg.family == "vlm" else 0
    b = {k: rs.randint(1, cfg.vocab_size, (B, S - P)).astype(np.int32)
         for k in ("tokens", "labels")}
    if cfg.family in ("vlm", "audio"):
        name = "patch_embeds" if cfg.family == "vlm" else "frames"
        b[name] = rs.randn(B, cfg.frontend_tokens,
                           cfg.d_model).astype(np.float32)
    return b


def _kw(params, b, cfg, enc):
    """The frontend keywords of forward/prefill on either side."""
    if cfg.family == "vlm":
        return {"patch_embeds": b["patch_embeds"]}
    if cfg.family == "audio":
        return {"enc_out": enc(params["encoder"], b["frames"], cfg)}
    return {}


# ---------------------------------------------------------------------------
# Configs and parameter counts


@pytest.mark.parametrize("arch", NEW)
def test_config_matches_reference_field_by_field(arch):
    assert arch in ASSIGNED_ARCHS
    for name in (arch, arch + "-smoke"):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jget_config(name))


def test_count_params_analytic_matches_reference_for_every_lm_arch():
    """All ten LM archs, from shapes alone on both sides (the port's
    init under FakeTensorMode, the reference's under ``eval_shape``),
    and active params (MoE: shared + top-k routed)."""
    assert len(ASSIGNED_ARCHS) == 10
    for arch in ASSIGNED_ARCHS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        want = japi.count_params_analytic(jcfg)
        assert api.count_params_analytic(cfg) == want, arch
        assert api.active_params(cfg) == japi.active_params(jcfg), arch
        if arch in PARAMS:
            assert want == PARAMS[arch], arch


# ---------------------------------------------------------------------------
# The vlm family


def test_vlm_forward_prefill_and_decode_match_reference():
    """Patches projected by ``vision_proj`` and prepended: the forward's
    hidden states, the prefill's logits and caches (patch positions
    included) and two decode steps from S + P, against the
    reference's; the API's prefill step takes the batch's patches."""
    jcfg, tcfg, jp, tp = models(VLM)
    b = _batch(tcfg)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jh, _ = jtfm.forward(jp, jnp.asarray(b["tokens"]), jcfg,
                         patch_embeds=jnp.asarray(b["patch_embeds"]))
    th, _ = tfm.forward(tp, tb["tokens"], tcfg,
                        patch_embeds=tb["patch_embeds"])
    assert th.shape == (2, 24, tcfg.d_model)
    _close(th, jh)
    jl, jc = jtfm.prefill(jp, jnp.asarray(b["tokens"][:, :-2]), jcfg,
                          cache_len=32,
                          patch_embeds=jnp.asarray(b["patch_embeds"]),
                          cache_dtype=jnp.float32)
    tl, tc = tfm.prefill(tp, tb["tokens"][:, :-2], tcfg, cache_len=32,
                         patch_embeds=tb["patch_embeds"],
                         cache_dtype=torch.float32)
    _close(tl, jl)
    for name, want in jc["g0_dense"].items():
        _close(tc["g0_dense"][name], want)
    for i in (-2, -1):
        t = 24 + i
        jl, jc = jtfm.decode_step(jp, jc, jnp.asarray(b["tokens"][:, [i]]),
                                  jnp.asarray(t, jnp.int32), jcfg)
        tl, tc = tfm.decode_step(tp, tc, tb["tokens"][:, [i]], t, tcfg)
        _close(tl, jl)
    sl, _ = api.make_prefill_step(tcfg)(tp, tb)
    want, _ = japi.make_prefill_step(jcfg)(jp, _j(b))
    _close(sl, want)


def test_vlm_loss_grads_and_train_step_match_reference():
    """The loss over the tokens alone (the patch positions cut off the
    hidden states), every gradient leaf (``vision_proj`` included) and
    one train step, at the bounds of ``tests/test_torch_training.py``."""
    jcfg, tcfg, jp, tp = models(VLM)
    b = _batch(tcfg, seed=1)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    (wl, _), wg = jax.jit(jax.value_and_grad(japi.make_loss_fn(jcfg),
                                             has_aux=True))(jp, {}, _j(b))
    (gl, (metrics, _)), gg = api.value_and_grad(api.make_loss_fn(tcfg), tp,
                                                {}, tb)
    assert float(gl) == pytest.approx(float(wl), rel=1e-5)
    _close_grads(gg, wg, 1e-5)
    assert np.abs(_tflat(gg)["vision_proj/kernel"]).max() > 0
    ocfg = dict(lr=5e-3, total_steps=20, warmup_steps=0)
    jc, tc = jopt.AdamWConfig(**ocfg), opt.AdamWConfig(**ocfg)
    jcarry, jm = jax.jit(japi.make_train_step(jcfg, jc))(
        japi.TrainCarry(jp, jopt.init_opt_state(jp, jc), {}), _j(b))
    tcarry, tm = api.make_train_step(tcfg, tc)(
        api.TrainCarry(tp, opt.init_opt_state(tp, tc), {}), tb)
    for k, rel in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6)):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rel)
    m = _jflat(jcarry.opt_state.m)
    scale = max(float(np.abs(v).max()) for v in m.values())
    got = _tflat(tcarry.params)
    for k, want in _jflat(jcarry.params).items():
        atol = np.where(np.abs(m[k]) < 1e-4 * scale, 2, 1e-3) * ocfg["lr"]
        assert (np.abs(got[k] - want) <= atol).all(), k


# ---------------------------------------------------------------------------
# Every new config: the reference's decode contract and the static path


@pytest.mark.parametrize("arch", NEW)
def test_prefill_decode_matches_forward(arch):
    """``tests/test_decode.py``'s contract on the port: prefill of S - 1
    tokens + one decode step equals the forward's last logits (1e-4).
    The forward itself is held against the reference's in
    ``test_vlm_forward_prefill_and_decode_match_reference`` (vlm),
    ``tests/test_torch_encdec.py`` (audio) and
    ``tests/test_torch_static.py`` (dense)."""
    cfg = get_config(arch + "-smoke")
    params = api.init_params(0, cfg, device="cpu")
    b = _batch(cfg, S=32, seed=2)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    from repro_torch.models.lm import encdec
    kw = _kw(params, tb, cfg, encdec.encode)
    h, _ = tfm.forward(params, tb["tokens"], cfg, **kw)
    if cfg.family == "vlm":
        h = h[:, cfg.frontend_tokens:]
    full = tfm.unembed(params, h[:, -1:], cfg)
    toks = tb["tokens"]
    _, caches = tfm.prefill(params, toks[:, :-1], cfg,
                            cache_len=32 + 4 + cfg.frontend_tokens,
                            cache_dtype=torch.float32, **kw)
    t = toks.shape[1] - 1 + (cfg.frontend_tokens if cfg.family == "vlm"
                             else 0)
    dec, _ = tfm.decode_step(params, caches, toks[:, -1:], t, cfg)
    assert float((dec - full).abs().max()) < 1e-4


@pytest.mark.parametrize("arch", [VLM, "whisper-tiny-smoke"])
def test_static_greedy_tokens_match_reference(arch):
    """The reference launcher's static loop (bf16 caches of prompt +
    tokens + frontend_tokens positions; the vlm decode from prompt +
    frontend_tokens, as its ``run_static`` starts it) and the port's
    ``static_generate`` on the same prompts and frontend stubs:
    identical greedy tokens."""
    jcfg, tcfg, jp, tp = models(arch)
    P, n_new = 16, 6
    b = _batch(tcfg, B=3, S=P, seed=3)
    kw = _kw(jp, _j(b), jcfg, jencdec.encode)
    cache_len = P + n_new + tcfg.frontend_tokens
    logits, caches = jtfm.prefill(jp, jnp.asarray(b["tokens"]), jcfg,
                                  cache_len=cache_len, **kw)
    start = P + (tcfg.frontend_tokens if tcfg.family == "vlm" else 0)
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [cur]
    step = jax.jit(lambda p, c, t, i: jtfm.decode_step(p, c, t, i, jcfg))
    for i in range(n_new - 1):
        logits, caches = step(jp, caches, cur,
                              jnp.asarray(start + i, jnp.int32))
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(cur)
    want = np.concatenate([np.asarray(w) for w in want], axis=1)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    r = serve.static_generate(tp, tcfg, tb["tokens"], n_new,
                              cache_len=cache_len,
                              patch_embeds=tb.get("patch_embeds"),
                              frames=tb.get("frames"))
    np.testing.assert_array_equal(r["tokens"].numpy(), want)
    assert r["launches_prefill"] == {} and r["launches_decode"] == {}


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-tiny",
                                  "chatglm3-6b"])
def test_static_cli_runs_the_new_configs_on_the_cpu(arch, capsys):
    """``--static --wbits 8`` for each frontend family and a dense
    config; the engine serves whisper and refuses internvl2, as the
    reference's registry does."""
    serve.main(["--arch", arch, "--smoke", "--static", "--device", "cpu",
                "--slots", "2", "--prompt-len", "12", "--tokens", "3",
                "--wbits", "8"])
    out = capsys.readouterr().out
    assert "prefill 2x12" in out and "decoded 4 tokens" in out
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--prompt-len", "6", "--tokens", "3", "--slots", "2"]
    if arch == "internvl2-1b":
        with pytest.raises(NotImplementedError, match="--static"):
            serve.main(argv)
        return
    serve.main(argv)
    out = capsys.readouterr().out
    assert "done: 3 requests" in out
    assert ("encoder buffer" in out) == (arch == "whisper-tiny")


def test_token_batches_carry_the_reference_frontend_stubs():
    """The token stream of each frontend family equals the reference's,
    its patch embeddings and frames included (drawn after the tokens
    from the same RandomState)."""
    for arch in (VLM, "whisper-tiny-smoke"):
        cfg, jcfg = get_config(arch), jget_config(arch)
        got, want = token_batches(cfg, 2, 16, 4), jtoken_batches(jcfg, 2,
                                                                 16, 4)
        for _ in range(2):
            a, w = next(got), next(want)
            assert set(a) == set(w)
            for k in a:
                assert a[k].dtype == np.asarray(w[k]).dtype
                np.testing.assert_array_equal(a[k], np.asarray(w[k]))
