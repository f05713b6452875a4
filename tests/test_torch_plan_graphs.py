"""The port's tick plans (``repro_torch.serving.plan``) against the
reference's plan contract, and the fixed-shape KV writes they rest on.

- ``PlanCache``: the twin of ``tests/test_dispatch.py``'s
  ``require_warm`` test; ``stats()`` carries the reference's keys plus
  ``graphs``; a warmed key staged again with inputs of another shape is
  a retrace; a staged plan's output of tick N is unchanged after tick
  N+1 (outputs never alias the static buffers); a capture's launches go
  to its tally and each replay counts them; MoE runners, like the
  others, give no reason to keep their plans eager.
- The tick's KV, int8-scale and position writes keep the fixed ``(B,
  C)`` shape and go through the drop route, and equal the reference's
  ``paged_indices`` + ``.at[wblk, off].set(..., mode="drop")`` exactly:
  pad tokens, unassigned (-1) blocks, a window ring that wraps, int8
  scales, MLA latent rows.
- The engine: sync and async dispatch serve the same tokens (bases for
  the basecaller) for the smoke families, every plan staged, no retrace;
  the launcher's ``retraces=`` gate.

On the CPU no plan is captured (``graphs`` is 0); ``tests/test_torch_cuda.py``
holds graph against eager on a card.
"""
import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.kernels import paged_attention as jpa
from repro.serving.plan import PlanCache as JPlanCache
from repro_torch.config import get_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import api
from repro_torch.serving.engine import Request
from repro_torch.serving.plan import PlanCache, PlanMissError
from repro_torch.serving.sampling import SamplingParams

KEY = ("decode", 1, "greedy")
# a reason of the tests' own for a cache to stay eager on a card
EAGER = "this program cannot be captured"


# ------------------------------------------------------------ PlanCache


def test_plan_cache_miss_is_hard_error_when_warm_required():
    plans = PlanCache()
    plans.register(KEY, lambda x: x)
    plans.require_warm = True
    with pytest.raises(PlanMissError):
        plans.lookup(KEY)                         # registered, not warmed
    with pytest.raises(PlanMissError):
        plans.lookup(("mixed", 2, "greedy"))      # not even registered
    plans.mark_warmed(KEY)
    plans.lookup(KEY)
    assert plans.stats()["bucket_hits"] == 1
    with pytest.raises(ValueError):
        plans.register(KEY, lambda x: x)          # duplicate


def test_warm_stages_and_marks_the_key():
    plans = PlanCache()
    plans.register(KEY, lambda x: x + 1)
    plans.require_warm = True
    out = plans.warm(KEY, np.arange(3, dtype=np.int32))
    np.testing.assert_array_equal(out.numpy(), [1, 2, 3])
    got = plans.lookup(KEY)(torch.tensor([5, 6, 7], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), [6, 7, 8])
    s = plans.stats()
    assert (s["warmed"], s["bucket_hits"], s["bucket_misses"],
            s["retraces"], s["graphs"]) == (1, 1, 0, 0, 0)


def test_stats_keys_are_the_reference_s_plus_graphs():
    want = set(JPlanCache().stats())
    assert set(PlanCache().stats()) == want | {"graphs"}
    eager = PlanCache("cuda", eager_reason=EAGER)
    assert set(eager.stats()) == want | {"graphs", "eager_reason"}
    assert eager.stats()["eager_reason"] == EAGER


@pytest.mark.parametrize("device,graphs,reason,graphed", [
    ("cpu", True, None, False), ("cuda", True, None, True),
    ("cuda", False, None, False), ("cuda", True, EAGER, False)])
def test_plans_capture_only_on_a_card(device, graphs, reason, graphed):
    """Building a cache touches no device: only a CUDA cache with graphs
    on and no stated reason captures."""
    assert PlanCache(device, graphs=graphs,
                     eager_reason=reason).graphed is graphed


def test_a_restaged_warmed_key_is_a_retrace():
    plans = PlanCache()
    plans.register(KEY, lambda x, d: x * 2 + d["b"])
    plans.warm(KEY, torch.ones(2, 3), {"b": np.zeros(3, np.float32)})
    plans.lookup(KEY)(torch.ones(2, 3), {"b": np.ones(3, np.float32)})
    assert plans.stats()["retraces"] == 0
    got = plans.lookup(KEY)(torch.ones(4, 3), {"b": np.ones(3, np.float32)})
    assert got.shape == (4, 3) and plans.stats()["retraces"] == 1
    plans.lookup(KEY)(torch.ones(4, 3, dtype=torch.float64),
                      {"b": np.ones(3, np.float32)})
    assert plans.stats()["retraces"] == 2


def test_tick_n_output_survives_tick_n_plus_1():
    """The identity plan returns its own staged buffer: the call's
    clone keeps tick N's output when tick N+1 restages the buffer."""
    plans = PlanCache()
    plans.register(KEY, lambda x: x)
    plans.warm(KEY, torch.zeros(4, dtype=torch.int32))
    tick = plans.lookup(KEY)
    n = tick(torch.arange(4, dtype=torch.int32))
    n1 = tick(torch.arange(4, 8, dtype=torch.int32))
    np.testing.assert_array_equal(n.numpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(n1.numpy(), [4, 5, 6, 7])


def test_capture_launches_go_to_the_tally_and_replays_count_them():
    def wrapper():
        pass
    wrapper.launches, wrapper.routes = 0, {"tensor_core": 0, "cuda_core": 0}
    seen = []
    saved, _build.ON_LAUNCH = _build.ON_LAUNCH, lambda k, r: seen.append(k)
    try:
        with _build.tally() as launched:
            _build.count_launch(wrapper, "w", "cuda_core")
            _build.count_launch(wrapper, "w", "cuda_core")
            _build.count_launch(wrapper, "w", "tensor_core")
        assert wrapper.launches == 0 and not seen
        for _ in range(3):
            _build.replay_launches(launched)
        _build.count_launch(wrapper, "w", "cuda_core")
    finally:
        _build.ON_LAUNCH = saved
    assert wrapper.launches == 10 and len(seen) == 10
    assert wrapper.routes == {"tensor_core": 3, "cuda_core": 7}


def test_moe_runners_say_why_their_plans_stay_eager():
    """They no longer do: a MoE block routes on the device at fixed
    shapes, so the MoE runners register their plans as the dense one
    does, with no reason to stay eager (on a card they capture:
    ``tests/test_torch_cuda.py``'s graph-against-eager drains)."""
    for arch in ("deepseek-v3-671b-smoke", "granite-moe-1b-a400m-smoke",
                 "qwen1.5-4b-smoke"):
        cfg = get_config(arch)
        eng = api.make_serving_engine(api.init_params(0, cfg, device="cpu"),
                                      cfg, device="cpu", n_slots=2,
                                      cache_len=16, prefill_chunk=4,
                                      block_len=4, cache_dtype=torch.float32)
        s = eng.runner.plan_stats()
        assert eng.runner.plans.eager_reason is None, arch
        assert "eager_reason" not in s and s["graphs"] == 0, arch


# ---------------------------------------------- fixed-shape drop writes

# (table, t) cases: pad tokens, unassigned blocks, a whole idle row, a
# ring of T * bl = 12 positions that wraps (positions 11..14 -> 11, 0..2)
TABLE = np.array([[3, -1, 5], [0, 1, -1], [-1, -1, -1], [2, 4, 6]],
                 np.int32)
WRITES = {
    "pad+unassigned": np.array([[1, 5, 9, -1], [2, 3, 4, 8],
                                [0, 1, -1, -1], [-1, -1, -1, -1]], np.int32),
    "ring-wraps": np.array([[11, 12, 13, 14], [-1, 5, 6, 7],
                            [3, -1, -1, -1], [10, 11, 12, 13]], np.int32),
    "decode": np.array([[9], [-1], [0], [14]], np.int32),
}
NB, BL = 8, 4


def _ref_writes(t, new, arena, pos):
    wblk, off, lw, _, _ = jpa.paged_indices(jnp.asarray(TABLE),
                                            jnp.asarray(t), NB, BL)
    B = t.shape[0]
    want_a = jnp.asarray(arena).at[wblk, off].set(jnp.asarray(new),
                                                  mode="drop")
    want_p = jnp.asarray(pos).at[jnp.arange(B)[:, None], lw].set(
        jnp.asarray(t), mode="drop")
    return np.asarray(want_a), np.asarray(want_p)


@pytest.mark.parametrize("case", sorted(WRITES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fixed_shape_writes_equal_the_reference_drop_scatter(case, dtype):
    t = WRITES[case]
    B, C = t.shape
    rs = np.random.RandomState(len(case))
    arena = rs.randn(NB, BL, 2, 8).astype(np.float32)
    pos = np.full((B, TABLE.shape[1] * BL), pa.EMPTY_POS, np.int32)
    new = rs.randn(B, C, 2, 8).astype(np.float32)
    if dtype == torch.bfloat16:                    # bf16-exact values
        arena, new = (torch.from_numpy(a).to(dtype).float().numpy()
                      for a in (arena, new))
    want_a, want_p = _ref_writes(t, new, arena, pos)
    w = pa.paged_writes(torch.from_numpy(TABLE), torch.from_numpy(t), NB, BL)
    assert all(a.shape == (B * C,) for a in w)
    got_a = torch.from_numpy(arena).to(dtype)
    got_p = torch.from_numpy(pos.copy())
    ops.scatter_rows(got_a, w.blk, w.off, torch.from_numpy(new).flatten(0, 1))
    ops.scatter_rows(got_p, w.b, w.lw, torch.from_numpy(t).reshape(-1))
    np.testing.assert_array_equal(got_a.float().numpy(), want_a)
    np.testing.assert_array_equal(got_p.numpy(), want_p)


@pytest.mark.parametrize("case", sorted(WRITES))
def test_int8_writes_and_scales_equal_the_reference(case):
    """int8 arena: bytes and per-token, per-head scales scattered at the
    same (wblk, off), in lockstep, as the reference's."""
    t = WRITES[case]
    B, C = t.shape
    rs = np.random.RandomState(7)
    arena = rs.randint(-127, 128, (NB, BL, 2, 8)).astype(np.int8)
    scale = rs.rand(NB, BL, 2).astype(np.float32)
    new = rs.randn(B, C, 2, 8).astype(np.float32)
    jq, js = jpa.quantize_kv(jnp.asarray(new))
    wblk, off, _, _, _ = jpa.paged_indices(jnp.asarray(TABLE),
                                           jnp.asarray(t), NB, BL)
    want_a = jnp.asarray(arena).at[wblk, off].set(jq, mode="drop")
    want_s = jnp.asarray(scale).at[wblk, off].set(js, mode="drop")
    w = pa.paged_writes(torch.from_numpy(TABLE), torch.from_numpy(t), NB, BL)
    q, s = pa.quantize_kv(torch.from_numpy(new).flatten(0, 1))
    got_a, got_s = torch.from_numpy(arena.copy()), torch.from_numpy(
        scale.copy())
    ops.scatter_rows(got_a, w.blk, w.off, q)
    ops.scatter_rows(got_s, w.blk, w.off, s)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("case", sorted(WRITES))
def test_mla_latent_writes_equal_the_reference(case):
    """The MLA latent arena (n_blocks, bl, kvr) and its rope keys: rows
    of one vector a token, dropped as the reference drops them."""
    t = WRITES[case]
    B, C = t.shape
    rs = np.random.RandomState(3)
    for width in (16, 3):                        # kvr, and an odd row
        arena = rs.randn(NB, BL, width).astype(np.float32)
        new = rs.randn(B, C, width).astype(np.float32)
        wblk, off, _, _, _ = jpa.paged_indices(jnp.asarray(TABLE),
                                               jnp.asarray(t), NB, BL)
        want = jnp.asarray(arena).at[wblk, off].set(jnp.asarray(new),
                                                    mode="drop")
        w = pa.paged_writes(torch.from_numpy(TABLE), torch.from_numpy(t),
                            NB, BL)
        got = torch.from_numpy(arena.copy())
        ops.scatter_rows(got, w.blk, w.off, torch.from_numpy(new).flatten(
            0, 1))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_drop_route_reads_nothing_on_the_host_for_a_device_tick():
    """The tick's writes are computed from the staged tensors alone:
    ``paged_writes`` has no filter, so its output shape is fixed by
    ``t``'s, whatever ``t`` holds."""
    shapes = {tuple(a.shape) for t in (WRITES["pad+unassigned"],
                                       np.full((4, 4), -1, np.int32))
              for a in pa.paged_writes(torch.from_numpy(TABLE),
                                       torch.from_numpy(t), NB, BL)}
    assert shapes == {(16,)}


# ------------------------------------------------------------- engines

LM_SMOKE = ["qwen1.5-4b-smoke", "mamba2-130m-smoke", "hymba-1.5b-smoke",
            "whisper-tiny-smoke", "deepseek-v3-671b-smoke"]
SPEC = [(6, 6), (9, 5), (3, 4)]                # (prompt length, max new)


def _lm_serve(arch, async_dispatch):
    cfg = get_config(arch)
    eng = api.make_serving_engine(
        api.init_params(0, cfg, device="cpu"), cfg, device="cpu",
        n_slots=2, cache_len=24, prefill_chunk=4, block_len=4,
        cache_dtype=torch.float32, async_dispatch=async_dispatch)
    eng.warmup()
    eng.runner.plans.require_warm = True
    rs = np.random.RandomState(0)
    for i, (pl, mn) in enumerate(SPEC):
        frames = (rs.randn(cfg.frontend_tokens, cfg.d_model).astype(
            np.float32) if cfg.family == "audio" else None)
        eng.submit(Request(rid=i, prompt=rs.randint(1, cfg.vocab_size,
                                                    pl).tolist(),
                           sampling=SamplingParams(max_new_tokens=mn),
                           frames=frames))
    done = eng.run()
    return ({i: (r.status, list(map(int, r.out_tokens)))
             for i, r in done.items()}, eng.metrics.summary())


@pytest.mark.parametrize("arch", LM_SMOKE)
def test_sync_and_async_engines_serve_the_same_tokens(arch):
    (sync, s0), (asyn, s1) = (_lm_serve(arch, a) for a in (False, True))
    assert sync == asyn
    assert all(st == "finished" for st, _ in sync.values())
    for s in (s0, s1):
        assert s["retraces"] == 0 and s["bucket_misses"] == 0
        assert s["plans_warmed"] == s["plans"] and s["graphs"] == 0


def test_basecaller_sync_and_async_serve_the_same_bases():
    """bonito-smoke: no activation quantizer, whose per-tensor scale sees
    the whole batch, so a read's bases do not depend on which windows
    share its tick (under rubicall's they do, in the reference too)."""
    from repro_torch.data.squiggle import (SquiggleConfig, normalize,
                                           pore_table, simulate_read)
    cfg = get_config("bonito-smoke")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    rs = np.random.RandomState(0)
    sim, table = SquiggleConfig(noise=0.1, drift=0.0), pore_table()
    reads = [normalize(simulate_read(rs, sim, table, int(n))[0])
             for n in (30, 55, 80)]
    out = []
    for async_dispatch in (False, True):
        eng = api.make_serving_engine(params, cfg, device="cpu", n_slots=2,
                                      chunk_samples=300,
                                      async_dispatch=async_dispatch)
        eng.warmup()
        eng.runner.plans.require_warm = True
        for i, sig in enumerate(reads):
            eng.submit(Request(rid=i, signal=sig))
        done = eng.run()
        out.append({i: (r.status, list(map(int, r.out_tokens)))
                    for i, r in done.items()})
        assert eng.metrics.summary()["retraces"] == 0
    assert out[0] == out[1]
    assert all(st == "finished" for st, _ in out[0].values())


def test_engine_without_warmup_misses_hard_when_warm_required():
    """The twin of the reference's mid-traffic retrace test: with
    ``require_warm`` and no warmup, the first tick raises."""
    cfg = get_config("qwen1.5-4b-smoke")
    eng = api.make_serving_engine(api.init_params(0, cfg, device="cpu"), cfg,
                                  device="cpu", n_slots=2, cache_len=16,
                                  prefill_chunk=4, block_len=4,
                                  cache_dtype=torch.float32)
    eng.runner.plans.require_warm = True
    eng.submit(Request(rid=0, prompt=[1, 2, 3],
                       sampling=SamplingParams(max_new_tokens=2)))
    with pytest.raises(PlanMissError):
        eng.run()


def test_launcher_gates_a_warmed_run_that_retraced(capsys):
    from repro_torch.launch.serve import print_tick_report
    s = {"tick_latency_p50_s": 0.001, "tick_latency_p99_s": 0.002,
         "idle_ticks": 0, "queue_depth_hwm": 1, "rejections": 0,
         "plans": 12, "plans_warmed": 12, "graphs": 12, "bucket_hits": 9,
         "bucket_misses": 0, "retraces": 0}
    args = argparse.Namespace(async_dispatch=False, warmup=True)
    print_tick_report(s, args)
    line = capsys.readouterr().out
    assert "12 graphs" in line and "retraces=0" in line
    with pytest.raises(SystemExit):
        print_tick_report({**s, "retraces": 1}, args)
    print_tick_report({**s, "retraces": 1},
                      argparse.Namespace(async_dispatch=True, warmup=False))


def test_trace_stability_flags_a_recaptured_plan():
    from repro_torch.analysis.rules.trace_stability import plan_retraces

    class Runner:
        plans = PlanCache()
    Runner.plans.register(KEY, lambda x: x)
    Runner.plans.warm(KEY, torch.zeros(2))
    assert plan_retraces(Runner, "seeded") == []
    Runner.plans.lookup(KEY)(torch.zeros(3))
    found = plan_retraces(Runner, "seeded")
    assert [f.where for f in found] == ["seeded::plan-retrace"]
