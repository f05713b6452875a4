"""The port's static path (whole-prompt prefill + lockstep greedy decode,
``launch/serve.py --static``) against the JAX package's.

``qwen1.5-4b-smoke`` (dense: the flash-attention prefill) and
``mamba2-130m-smoke`` (ssm: the SSD-scan prefill) with the JAX init
bridged through numpy, fp32. On the CPU the port's kernel wrappers run
their plain versions; the JAX package runs its model's own XLA paths
(``blockwise_attn``, ``ssd_chunked``).

- ``prefill``: last-position logits and every cache leaf (fp32 caches)
  within 1e-5 of JAX ``tfm.prefill``; positions and windows exact.
- The static loop as the reference launcher runs it (bf16 KV cache,
  ``prompt + tokens`` capacity): greedy tokens identical.
- mamba2 through the port's engine serves the static path's greedy
  tokens.
- The staged static plans (``serve.StaticPlans``) run a second prompt
  batch as a fresh run does, exactly, and ``decode_step`` at a 0-d
  device position reads nothing on the host and matches an int one bit
  for bit (six block families, port-only smoke models).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.config import get_config as jget_config
from repro.models import api as japi
from repro.models.lm import transformer as jtfm
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models.lm import transformer as tfm

ARCHS = ["qwen1.5-4b-smoke", "mamba2-130m-smoke"]


@functools.lru_cache(maxsize=None)
def models(arch):
    """(jax cfg, port cfg, jax params, port params), fp32."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jp = japi.init_params(jax.random.key(0), jcfg)
    tp = bridge.from_numpy_tree(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(1, 256, (B, S)).astype(
        np.int32)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("S", [40, 33])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_jax(arch, S):
    """S = 33: neither the smoke SSD chunk (32) nor 128 divides it."""
    jcfg, tcfg, jp, tp = models(arch)
    tok = _tokens(2, S)
    jl, jc = jtfm.prefill(jp, jnp.asarray(tok), jcfg, cache_len=48,
                          cache_dtype=jnp.float32)
    tl, tc = tfm.prefill(tp, torch.from_numpy(tok), tcfg, cache_len=48,
                         cache_dtype=torch.float32)
    assert tuple(tl.shape) == jl.shape == (2, 1, tcfg.vocab_size)
    _close(tl, jl, 1e-5)
    # the API's prefill step (caches of S positions, the ring branch of
    # the cache fill) gives the same logits
    sl, _ = api.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(tok)})
    _close(sl, jl, 1e-5)
    assert set(tc) == set(jc)
    for g in jc:
        assert set(tc[g]) == set(jc[g]), g
        for name, want in jc[g].items():
            got = tc[g][name]
            assert tuple(got.shape) == want.shape, (g, name)
            if got.dtype in (torch.int32, torch.int64):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                _close(got, want, 1e-5)
    # the whole-sequence forward's hidden states too
    jh, _ = jtfm.forward(jp, jnp.asarray(tok), jcfg)
    th, _ = tfm.forward(tp, torch.from_numpy(tok), tcfg)
    _close(th, jh, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_greedy_tokens_match_jax(arch):
    """The reference launcher's ``run_static`` loop (bf16 KV cache of
    prompt + tokens positions, argmax, ``decode_step`` at positions P,
    P + 1, ...) and the port's ``serve.static_generate``: identical
    greedy tokens; the decode steps through ``api.make_decode_step``
    give the same logits as the loop's."""
    jcfg, tcfg, jp, tp = models(arch)
    P, n_new = 24, 10
    tok = _tokens(3, P, seed=1)
    logits, caches = jax.jit(
        lambda p, t: jtfm.prefill(p, t, jcfg, cache_len=P + n_new))(
            jp, jnp.asarray(tok))
    step = jax.jit(lambda p, c, t, i: jtfm.decode_step(p, c, t, i, jcfg))
    cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [cur]
    for i in range(n_new - 1):
        logits, caches = step(jp, caches, cur, jnp.asarray(P + i, jnp.int32))
        cur = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(cur)
    want = np.concatenate([np.asarray(w) for w in want], axis=1)
    r = serve.static_generate(tp, tcfg, torch.from_numpy(tok), n_new)
    np.testing.assert_array_equal(r["tokens"].numpy(), want)
    assert r["launches_prefill"] == {} and r["launches_decode"] == {}
    # one more step through the API's decode step, against JAX's
    dstep = api.make_decode_step(tcfg)
    tl, _ = dstep(tp, r["caches"], r["tokens"][:, -1:], P + n_new - 1)
    jl, _ = step(jp, caches, cur, jnp.asarray(P + n_new - 1, jnp.int32))
    _close(tl, jl, 2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_empty_caches_match_jax_layout(arch):
    """``init_caches`` (the empty static caches): the same groups, leaves,
    shapes, dtypes and contents as the reference's."""
    jcfg, tcfg, _, _ = models(arch)
    jc = jtfm.init_caches(jcfg, 3, 20)
    tc = tfm.init_caches(tcfg, 3, 20, device="cpu")
    assert set(tc) == set(jc)
    for g in jc:
        assert set(tc[g]) == set(jc[g])
        for name, want in jc[g].items():
            got = tc[g][name]
            assert tuple(got.shape) == want.shape, (g, name)
            assert str(got.dtype)[6:] == str(want.dtype), (g, name)
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))


def test_mamba2_has_no_slot_path_in_the_port():
    """mamba2-smoke's engine (the slot recurrence, prompts in chunks of
    4 beside decode rows) serves the static path's greedy tokens (the
    chunked SSD prefill and the one-token decode), fp32."""
    from repro_torch.serving.engine import Request
    from repro_torch.serving.sampling import SamplingParams
    _, tcfg, _, tp = models("mamba2-130m-smoke")
    assert tfm.supports_slot_serving(tcfg)
    eng = api.make_serving_engine(tp, tcfg, device="cpu", n_slots=2,
                                  cache_len=32, prefill_chunk=4,
                                  cache_dtype=torch.float32)
    tok = _tokens(3, 13, seed=2)
    for i, row in enumerate(tok):
        eng.submit(Request(rid=i, prompt=row.tolist(),
                           sampling=SamplingParams(max_new_tokens=9)))
    done = eng.run()
    want = serve.static_generate(tp, tcfg, torch.from_numpy(tok), 9,
                                 cache_dtype=torch.float32)["tokens"]
    assert [done[i].out_tokens for i in range(3)] == want.tolist()


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen1.5-4b"])
def test_static_cli_runs_on_the_cpu_and_refuses_without_a_card(
        arch, capsys, monkeypatch):
    serve.main(["--arch", arch, "--smoke", "--static", "--device", "cpu",
                "--slots", "2", "--prompt-len", "20", "--tokens", "4",
                "--wbits", "8"])
    out = capsys.readouterr().out
    assert "prefill 2x20" in out and "decoded 6 tokens" in out
    assert "dequantized once" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", arch, "--smoke", "--static"])


# ------------------------------------------------- the staged static plans

def _leaves(tree, path=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def _smoke(arch):
    """A port-only smoke model (``hymba-1.5b-smoke-ring``: 4 layers with
    hybrid_swa ones at window 8, so a prompt of 12 wraps the rings)."""
    from dataclasses import replace
    if arch == "hymba-1.5b-smoke-ring":
        cfg = replace(get_config("hymba-1.5b-smoke"), n_layers=4,
                      sliding_window=8)
    else:
        cfg = get_config(arch)
    return cfg, api.init_params(0, cfg, device="cpu")


RESET_ARCHS = ["qwen1.5-4b-smoke", "mamba2-130m-smoke",
               "hymba-1.5b-smoke-ring", "deepseek-v3-671b-smoke"]


@pytest.mark.parametrize("arch", RESET_ARCHS)
def test_static_plans_serve_a_second_batch_as_a_fresh_run(arch):
    """One set of staged plans (``serve.StaticPlans``) runs two prompt
    batches of one shape: the second's tokens and every cache leaf equal
    a fresh run's exactly, and the plans were not staged again. A prefill
    through the plans then leaves every position and SSM leaf, and the
    K/V rows it wrote, as a prefill into new caches (``init_caches``'
    layout and dtypes) does: nothing a decode step left is seen."""
    cfg, params = _smoke(arch)
    B, S, n_new = 2, 12, 6
    a, b = (torch.from_numpy(_tokens(B, S, seed)) for seed in (5, 6))
    plans = serve.StaticPlans(params, cfg, B, S, S + n_new)
    first = serve.static_generate(params, cfg, a, n_new, plans=plans)
    again = serve.static_generate(params, cfg, b, n_new, plans=plans)
    fresh = serve.static_generate(params, cfg, b, n_new)
    assert not torch.equal(first["tokens"], again["tokens"])
    assert torch.equal(again["tokens"], fresh["tokens"])
    assert torch.equal(again["logits"], fresh["logits"])
    got, want = dict(_leaves(again["caches"])), dict(_leaves(fresh["caches"]))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert torch.equal(got[path], leaf), path
    assert again["plans"]["retraces"] == 0
    assert again["plans"]["plans"] == 2 and again["plans"]["graphs"] == 0
    plans.prefill(b)
    with torch.no_grad():
        _, own = tfm.prefill(params, b, cfg, cache_len=S + n_new)
    got, want = dict(_leaves(plans.caches)), dict(_leaves(own))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        rows = (leaf if path.rsplit("/", 1)[-1] not in
                ("k", "v", "c", "k_rope") else leaf[:, :, :S])
        assert torch.equal(got[path][tuple(slice(n) for n in rows.shape)],
                           rows), path


class _NoHostRead(torch.utils._python_dispatch.TorchDispatchMode):
    """Raises where a tensor's value would be read on the host
    (``.item()``, ``int(t)``, ``bool(t)`` all reach this op)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a tensor was read on the host")
        return func(*args, **(kwargs or {}))


DEVICE_T_ARCHS = ["qwen1.5-4b-smoke", "mamba2-130m-smoke",
                  "hymba-1.5b-smoke-ring", "deepseek-v3-671b-smoke",
                  "whisper-tiny-smoke", "internvl2-1b-smoke"]


@pytest.mark.parametrize("arch", DEVICE_T_ARCHS)
def test_decode_step_at_a_device_position_reads_nothing_on_the_host(arch):
    """``decode_step`` with ``t`` a 0-d int32 tensor gives the logits and
    caches of an int ``t``, bit for bit, and neither form reads a tensor
    on the host (dense, ssm, hybrid with rings, mla + moe, xdec, vlm)."""
    cfg, params = _smoke(arch)
    B, S = 2, 12 + cfg.frontend_tokens
    batch = api.make_smoke_batch(3, cfg, B, S, device="cpu")
    t = S + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    with torch.no_grad():
        logits, caches = api.make_prefill_step(cfg)(params, batch)
        tok = logits.argmax(-1).to(torch.int32)
        twin = {g: {k: v.clone() for k, v in _leaves(c)}
                for g, c in caches.items()}
        out = []
        for pos in (t, torch.tensor(t, dtype=torch.int32)):
            for g, c in caches.items():
                for k, v in _leaves(c):
                    v.copy_(twin[g][k])
            with _NoHostRead():
                step, after = tfm.decode_step(params, caches, tok, pos, cfg)
            out.append((step, {(g, k): v.clone() for g, c in after.items()
                               for k, v in _leaves(c)}))
    (l_int, c_int), (l_dev, c_dev) = out
    assert torch.equal(l_int, l_dev)
    assert c_int.keys() == c_dev.keys()
    for key, leaf in c_int.items():
        assert torch.equal(c_dev[key], leaf), key


def test_static_plans_are_freed_without_the_cyclic_collector():
    """Dropping a ``StaticPlans`` frees its plan cache (on a card, its
    graphs) at once: its plans hold no reference back to it, so no
    cyclic collection, which may run inside another plan's capture, has
    to free them."""
    import gc
    import weakref
    cfg, params = _smoke("qwen1.5-4b-smoke")
    tok = torch.from_numpy(_tokens(2, 8, seed=7))
    collecting = gc.isenabled()
    gc.disable()
    try:
        plans = serve.StaticPlans(params, cfg, 2, 8, 12)
        serve.static_generate(params, cfg, tok, 3, plans=plans)
        cache = weakref.ref(plans.plans)
        del plans
        assert cache() is None
    finally:
        if collecting:
            gc.enable()
