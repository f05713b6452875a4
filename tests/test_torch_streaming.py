"""Streaming and read-until parity: the port's StreamCursor, streaming
BasecallerRunner, engine and classifier (CPU) against the JAX package's,
on the same numpy inputs, the same append schedules and the same bridged
packed rubicall-smoke weights (every block int8, ``QuantPolicy(8, 8)``,
so the fused qconv1d route serves).

Exact wherever the reference is exact: stream works, tokens after every
append, statuses, ejections and their counters, emit-latency metrics
under a shared fake clock. The classifier's forward is held at 1e-5 and
its ``fit`` at 1e-4 relative (fp32 summation order; 20 SGD steps).

The reference's own end-to-end read-until test fails on this jax (its
trained classifier keeps the noise read), so these gates compare with
the verdicts the reference computes on the same weights, and test the
ejection mechanics with a forced verdict (threshold +-1e9), as the
reference's ``_force_eject_policy`` does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.models.basecaller import classifier as jrc
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving.stream import ReadUntil as JReadUntil
from repro.serving.stream import StreamCursor as JStreamCursor
from repro.serving.stream import StreamingRequest as JStreamingRequest
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.data.squiggle import (SquiggleConfig, normalize, pore_table,
                                       simulate_read)
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models.basecaller import blocks as bl
from repro_torch.models.basecaller import classifier as rc
from repro_torch.models.basecaller import model as bc
from repro_torch.serving.engine import Request
from repro_torch.serving.runner import make_runner
from repro_torch.serving.stream import (UNBOUNDED, ReadUntil, StreamCursor,
                                        StreamingRequest)
from test_torch_basecaller import models

CHUNK = 300
CLS_EXACT = 1e-5
FIT_RTOL = 1e-4


@pytest.fixture(scope="module")
def served():
    return models("rubicall-smoke", quant=(8, 8), packed=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _engine(served, port: bool, *, read_until=None, **kw):
    """The JAX (``port=False``) or the port's engine, 2 slots;
    ``read_until = (JAX classifier tree, eject_after_chunks,
    threshold)``, the tree bridged for the port."""
    jcfg, tcfg, jp, _, tp, _ = served
    if read_until is not None:
        params, k, thr = read_until
        if port:
            params = bridge.from_numpy_tree(_np(params), device="cpu")
        kw["read_until"] = (ReadUntil if port else JReadUntil)(
            params=params, eject_after_chunks=k, threshold=thr)
    if port:
        return api.make_serving_engine(tp, tcfg, device="cpu", n_slots=2,
                                       chunk_samples=CHUNK, **kw)
    return JServingEngine(jp, jcfg, n_slots=2, chunk_samples=CHUNK, **kw)


def _pair(served, **kw):
    """(JAX engine, port engine) with the same settings."""
    return _engine(served, False, **kw), _engine(served, True, **kw)


def _settle(eng):
    """Step until no slot makes progress (nothing coverable yet)."""
    for _ in range(400):
        if not eng.busy:
            return
        marker = (tuple(s.pos for s in eng.slots), len(eng.completed))
        eng.step()
        if (tuple(s.pos for s in eng.slots), len(eng.completed)) == marker:
            return
    raise AssertionError("engine failed to settle in 400 ticks")


def _random_chunks(sig, seed):
    rs = np.random.RandomState(seed)
    out, a = [], 0
    while a < len(sig):
        n = int(rs.randint(1, 220))
        out.append(sig[a:a + n])
        a += n
    return out


# the reference's schedules (tests/test_streaming.py)
SCHEDULES = {
    "dribble": lambda s: [s[i:i + 1] for i in range(len(s))],
    "exact_window": lambda s: [s[a:a + CHUNK]
                               for a in range(0, len(s), CHUNK)],
    "bursty": lambda s: _random_chunks(s, seed=7),
    "whole": lambda s: [s],
}
LENGTHS = {"dribble": 430, "exact_window": 901, "bursty": 700, "whole": 505}


def _pore_reads(n, seed, lo=60, hi=120):
    rs = np.random.RandomState(seed)
    sim, table = SquiggleConfig(noise=0.1, drift=0.0), pore_table()
    return [normalize(simulate_read(rs, sim, table,
                                    int(rs.randint(lo, hi)))[0])
            for _ in range(n)]


def _interleaved(sigs, seed):
    """One append schedule over several reads: (read index, samples)
    events, bursty, reads interleaved."""
    parts = [_random_chunks(s, seed + i) for i, s in enumerate(sigs)]
    rs = np.random.RandomState(seed)
    events = []
    while any(parts):
        i = int(rs.choice([j for j, p in enumerate(parts) if p]))
        events.append((i, parts[i].pop(0)))
    return events


def _drive(eng, request_cls, sigs, events, clock=None):
    """Submit one stream per read, replay ``events``, settle after each
    append, then finish every stream. Returns the tokens of every read
    after every append, and the requests."""
    kw = {} if clock is None else {"clock": clock}
    reqs = [request_cls(rid=i, **kw) for i in range(len(sigs))]
    for r in reqs:
        eng.submit(r)
    trail = []
    for i, chunk in events:
        if not reqs[i].done:
            reqs[i].append(chunk)
        _settle(eng)
        trail.append([list(map(int, r.out_tokens)) for r in reqs])
    for r in reqs:
        if not r.done:
            r.finish()
    _settle(eng)
    trail.append([list(map(int, r.out_tokens)) for r in reqs])
    return trail, reqs


def _summary(eng):
    s = eng.metrics.summary()
    return {k: s[k] for k in ("ejections", "samples_saved",
                              "ejected_consumed_samples", "emit_events",
                              "requests_done")}


# ---------------------------------------------------------------- (a)


def _works(cursor, req):
    out = []
    while True:
        w = cursor.next_work(req)
        if w is None:
            return out
        win, f_lo, f_hi, start, read_len, classify = w.payload
        out.append((np.asarray(win).tobytes(), win.shape, f_lo, f_hi, start,
                    read_len, classify, w.n_units, w.final, w.need,
                    w.needs_finish))


@pytest.mark.parametrize("qos", ["accuracy", "latency"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_cursor_issues_the_references_works(served, qos, schedule):
    """Window bytes, frame spans, mask bounds, classify flags, sample
    deltas and enabling needs equal the reference cursor's, after every
    append and at finish."""
    tcfg = served[1]
    stride, halo = bc.total_stride(tcfg), bc.chunk_halo(tcfg)
    sig = np.random.RandomState(len(schedule)).randn(
        LENGTHS[schedule]).astype(np.float32)
    cur = StreamCursor(CHUNK, halo, stride, qos=qos, classify_chunks=2)
    jcur = JStreamCursor(CHUNK, halo, stride, qos=qos, classify_chunks=2)
    req, jreq = StreamingRequest(rid=0), JStreamingRequest(rid=0)
    n = 0
    for chunk in SCHEDULES[schedule](sig):
        req.append(chunk)
        jreq.append(chunk)
        got, want = _works(cur, req), _works(jcur, jreq)
        assert got == want
        n += len(got)
    req.finish()
    jreq.finish()
    got, want = _works(cur, req), _works(jcur, jreq)
    assert got == want and got[-1][8]           # the final work came
    assert n + len(got) > 1 and cur.done and jcur.done


def test_unbounded_read_len_masks_nothing_at_full_width():
    """UNBOUNDED reaches the read-edge mask as an int32 ``read_len``; at
    full RUBICALL's geometry (start >= -3237, positions < 7500) the
    global sample index stays in int32 and only the left edge masks."""
    cfg = get_config("rubicall")
    halo = bc.chunk_halo(cfg)
    h = torch.ones((2, 7500, 1))
    start = torch.tensor([-halo, 5 * 1026 - halo], dtype=torch.int32)
    read_len = torch.full((2,), UNBOUNDED, dtype=torch.int32)
    got = bl._mask_outside(h, (start, read_len), 1)[..., 0]
    want = (np.arange(7500)[None, :] + start.numpy()[:, None]) >= 0
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


# ---------------------------------------------------------------- (b)


@pytest.mark.parametrize("async_dispatch", [False, True])
@pytest.mark.parametrize("qos", ["accuracy", "latency"])
def test_streamed_tokens_match_the_reference_after_every_append(
        served, qos, async_dispatch):
    sigs = _pore_reads(2, seed=3)
    events = _interleaved(sigs, seed=5)
    jeng, teng = _pair(served, qos=qos, async_dispatch=async_dispatch)
    want, jreqs = _drive(jeng, JStreamingRequest, sigs, events)
    got, reqs = _drive(teng, StreamingRequest, sigs, events)
    assert got == want
    assert [r.status for r in reqs] == [r.status for r in jreqs] \
        == ["finished"] * 2
    assert sum(map(len, got[-1])) > 0
    assert _summary(teng) == _summary(jeng)
    # the latency QoS emits before the streams finish
    if qos == "latency":
        assert sum(map(len, got[-2])) > 0


# ---------------------------------------------------------------- (c)


@pytest.mark.parametrize("eject", [False, True])
def test_preempt_and_resume_mid_stream(served, eject):
    """Preempt a live stream after its first window, append while it is
    evicted, finish: tokens, status and counters equal the reference's.
    With a forced eject after two windows the read-until accumulator
    crosses the preemption too (one window before, one after)."""
    policy = (jrc.init_params(jax.random.key(3)), 2, 1e9) if eject \
        else None
    sig = np.random.RandomState(21).randn(1300).astype(np.float32)
    out = []
    for eng, cls in zip(_pair(served, read_until=policy),
                        (JStreamingRequest, StreamingRequest)):
        req = cls(rid=0)
        eng.submit(req)
        req.append(sig[:700])              # covers window 0 (477 samples)
        _settle(eng)
        i = next(i for i, s in enumerate(eng.slots) if s.req is req)
        assert eng.slots[i].pos > 0
        eng._preempt(i)
        assert req.status == "preempted-pending" and not req.done
        req.append(sig[700:])
        req.finish()
        _settle(eng)
        out.append((req.status, list(map(int, req.out_tokens)),
                    _summary(eng), eng.metrics.preempts))
    assert out[1] == out[0]
    assert out[1][0] == ("ejected" if eject else "finished")
    assert out[1][3] == 1


# ---------------------------------------------------------------- (d)


@pytest.mark.parametrize("threshold", [1e9, -1e9])
@pytest.mark.parametrize("streamed", [False, True])
def test_forced_ejection_matches_the_reference(served, threshold, streamed):
    policy = (jrc.init_params(jax.random.key(3)), 2, threshold)
    sigs = _pore_reads(2, seed=6, lo=100, hi=140)   # >= 3 windows each
    out = []
    for eng, req_cls, sreq_cls in zip(_pair(served, read_until=policy),
                                      (JRequest, Request),
                                      (JStreamingRequest, StreamingRequest)):
        if streamed:
            trail, reqs = _drive(eng, sreq_cls, sigs, _interleaved(sigs, 9))
        else:
            reqs = [req_cls(rid=i, signal=s) for i, s in enumerate(sigs)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            trail = None
        status = "ejected" if threshold > 0 else "finished"
        drained = {k: (r.status, list(map(int, r.out_tokens)))
                   for k, r in eng.drain_completed(status=status).items()}
        out.append((trail, drained, eng.drain_completed(), _summary(eng)))
    assert out[1][0] == out[0][0] and out[1][1] == out[0][1]
    assert out[1][2] == out[0][2] == {}          # one kind of status only
    assert out[1][3] == out[0][3]
    s = out[1][3]
    assert len(out[1][1]) == 2
    if threshold > 0:
        assert s["ejections"] == 2 and s["samples_saved"] >= 0
        assert s["ejected_consumed_samples"] == 2 * 2 * CHUNK
        assert all(0 < len(t) for _, t in out[1][1].values())
    else:
        assert s["ejections"] == 0 and s["ejected_consumed_samples"] == 0


# ---------------------------------------------------------------- (e)


def test_classifier_training_set_forward_and_fit_match_the_reference():
    x, y = rc.make_training_set(np.random.RandomState(0), 640,
                                n_per_class=6)
    jx, jy = jrc.make_training_set(np.random.RandomState(0), 640,
                                   n_per_class=6)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    jp = jrc.init_params(jax.random.key(0))
    tp = bridge.from_numpy_tree(_np(jp), device="cpu")
    got = rc.forward(tp, torch.from_numpy(x)).numpy()
    want = np.asarray(jrc.forward(jp, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=CLS_EXACT, rtol=0)
    tfit, tloss = rc.fit(tp, x, y, steps=20, lr=0.1)
    jfit, jloss = jrc.fit(jp, jx, jy, steps=20, lr=0.1)
    assert tloss == pytest.approx(jloss, rel=FIT_RTOL)
    for k, v in _np(jfit).items():
        np.testing.assert_allclose(tfit[k].numpy(), v, rtol=FIT_RTOL,
                                   atol=FIT_RTOL * np.abs(v).max())
    # the port's own init draws the reference's tree of shapes
    own = rc.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in _np(jp).items()}
    assert float(own["conv0"].std()) == pytest.approx(0.2 * 0.88, rel=0.3)


def _watch_verdicts(eng):
    """Record each read's mean logit when its verdict is decided (the
    engine pops ejections right after the tick that decides)."""
    seen, runner = {}, eng.runner
    pop = runner.pop_ejections

    def watched():
        for i, s in enumerate(eng.slots):
            if s.req is not None and runner._cls_decided[i] \
                    and s.req.rid not in seen:
                seen[s.req.rid] = runner._cls_sum[i] / runner._cls_n[i]
        return pop()
    runner.pop_ejections = watched
    return seen


def test_streamed_verdicts_match_a_reference_trained_classifier(served):
    """A classifier fitted by the reference, bridged: the port ejects the
    same reads, with per-read mean logits within 1e-4 of the
    reference's."""
    tcfg = served[1]
    window = CHUNK + 2 * bc.chunk_halo(tcfg)
    x, y = jrc.make_training_set(np.random.RandomState(8), window,
                                 n_per_class=16)
    cls, _ = jrc.fit(jrc.init_params(jax.random.key(9)), x, y, steps=80,
                     lr=0.1)
    rs = np.random.RandomState(10)
    sigs = _pore_reads(2, seed=10, lo=100, hi=160) + [
        normalize(rs.randn(n).astype(np.float32)) for n in (1400, 1100)]
    jeng, teng = _pair(served, read_until=(cls, 2, 0.0))
    means = [_watch_verdicts(e) for e in (jeng, teng)]
    events = _interleaved(sigs, seed=11)
    want, jreqs = _drive(jeng, JStreamingRequest, sigs, events)
    got, reqs = _drive(teng, StreamingRequest, sigs, events)
    assert got == want
    assert [r.status for r in reqs] == [r.status for r in jreqs]
    assert _summary(teng) == _summary(jeng)
    assert sorted(means[1]) == sorted(means[0]) == [0, 1, 2, 3]
    for rid, m in means[0].items():
        assert means[1][rid] == pytest.approx(m, abs=FIT_RTOL)


# ---------------------------------------------------------------- (f)


def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]
    return clock


def test_emit_latency_metrics_match_under_a_fake_clock(served):
    sig = np.random.RandomState(12).randn(800).astype(np.float32)
    events = [(0, sig[a:a + 200]) for a in range(0, 800, 200)]
    out = []
    for qos in ("latency", "accuracy"):
        for k in range(2):
            clock = _fake_clock()
            eng = _engine(served, bool(k), qos=qos, clock=clock)
            cls = (JStreamingRequest, StreamingRequest)[k]
            _drive(eng, lambda rid, **kw: cls(rid=rid, clock=clock), [sig],
                   events)
            s = eng.metrics.summary()
            out.append((s["emit_events"], s["emit_latency_p50_s"],
                        s["emit_latency_p99_s"]))
    assert out[1] == out[0] and out[3] == out[2]
    assert out[1][0] > 0 and 0 <= out[1][1] <= out[1][2]


def test_idle_ticks_skip_the_runner_like_the_reference(served):
    """Slots waiting on unarrived samples: ``step()`` reaches neither
    runner's ``step`` nor ``dispatch`` (the reference's
    ``test_idle_ticks_skip_runner_calls``), and the idle-tick count and
    the bases after the stream resumes equal the reference's."""
    sig = _pore_reads(1, seed=13)[0]
    out = []
    for port, cls in ((False, JStreamingRequest), (True, StreamingRequest)):
        eng = _engine(served, port)
        calls = []
        for name in ("step", "dispatch"):
            fn = getattr(eng.runner, name)
            setattr(eng.runner, name, lambda *a, _fn=fn, **k: (
                calls.append(1), _fn(*a, **k))[1])
        req = cls(rid=0)
        eng.submit(req)
        for _ in range(6):
            eng.step()          # admitted, but no sample has arrived
        idle, n_idle_calls = eng.metrics.summary()["idle_ticks"], len(calls)
        req.append(sig)
        req.finish()
        done = eng.run()
        out.append((n_idle_calls, idle, done[0].status,
                    list(map(int, done[0].out_tokens)), len(calls) > 0))
    assert out[1] == out[0]
    assert out[1][0] == 0 and out[1][1] >= 4 and out[1][3]


# ---------------------------------------------------------------- (g)


def test_append_finish_contract_and_token_runners_refuse_streams(served):
    req = StreamingRequest(rid=0)
    with pytest.raises(ValueError, match="empty stream"):
        req.finish()
    assert req.append(np.ones(4, np.float32)) == 4
    req.finish()
    req.finish()                           # idempotent
    with pytest.raises(RuntimeError, match="after finish"):
        req.append(np.ones(1, np.float32))
    qcfg = get_config("qwen1.5-4b-smoke")
    qparams = api.init_params(0, qcfg, device="cpu")
    kw = dict(n_slots=1, cache_len=16, prefill_chunk=4,
              cache_dtype=torch.float32)
    eng = api.make_serving_engine(qparams, qcfg, device="cpu", **kw)
    with pytest.raises(ValueError, match="StreamingRequest"):
        eng.submit(StreamingRequest(rid=0))
    runner = make_runner(qparams, qcfg, device="cpu", **kw)
    with pytest.raises(ValueError, match="StreamingRequest"):
        runner.validate(StreamingRequest(rid=1))
    with pytest.raises(NotImplementedError, match="StreamingRequests"):
        runner.open_stream(StreamingRequest(rid=2))
    # the basecaller engine raises instead of spinning on an open stream
    teng = _engine(served, True)
    live = StreamingRequest(rid=3)
    teng.submit(live)
    live.append(np.ones(32, np.float32))
    with pytest.raises(RuntimeError, match="stalled"):
        teng.run()
    live.finish()
    _settle(teng)
    assert live.status == "finished"


# ---------------------------------------------------------------- (h)


def test_launcher_streams_with_read_until_on_the_cpu(capsys):
    serve.main(["--arch", "rubicall", "--smoke", "--wbits", "8", "--stream",
                "--read-until", "--qos", "latency", "--device", "cpu",
                "--read-bases", "40", "--requests", "4", "--rate", "50",
                "--warmup"])
    out = capsys.readouterr().out
    assert "classifier trained on cpu" in out
    assert "LIVE reads" in out and "qos=latency" in out
    assert "[serve] streamed: 4 reads" in out and "emit latency p50" in out
    assert "[serve] read-until: " in out and "samples saved" in out
    serve.main(["--arch", "rubicall", "--smoke", "--read-until", "--device",
                "cpu", "--read-bases", "40", "--requests", "2", "--rate",
                "50"])
    assert "[serve] read-until: 0 ejections | samples saved" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit, match="not a basecaller"):
        serve.main(["--arch", "qwen1.5-4b", "--smoke", "--stream",
                    "--device", "cpu"])


def test_launcher_stream_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "rubicall", "--smoke", "--stream",
                    "--read-until", "--requests", "1"])


def test_read_until_params_follow_the_runner_device(served):
    """The runner moves the classifier to its own device (a CPU runner
    here takes the tree as is; the card's case is a gpu test)."""
    jcfg, tcfg, _, _, tp, _ = served
    cp = rc.init_params(torch.Generator().manual_seed(1))
    eng = api.make_serving_engine(
        tp, tcfg, device="cpu", n_slots=2, chunk_samples=CHUNK,
        read_until=ReadUntil(params=cp), qos="latency")
    r = eng.runner
    assert r.qos == "latency" and r.supports_streaming
    assert all(v.device.type == "cpu" for v in r.read_until.params.values())
    assert isinstance(r.open_stream(StreamingRequest(rid=0)), StreamCursor)
    chunk = r.make_chunks(Request(rid=0, signal=np.ones(700, np.float32)))
    assert [c.payload[5] for c in chunk] == [1, 1, 0]

