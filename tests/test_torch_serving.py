"""Serving parity: the port's ServingEngine + BasecallerRunner (CPU)
against the JAX package's, on the same simulated reads, the same bridged
packed rubicall-smoke weights (every block int8, so the fused qconv1d
route serves), 2 slots and the same arrival order, synchronous and
async-dispatched. Greedy CTC is exact, so request statuses and served
bases must be identical."""
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.models.basecaller import model as jbc
from repro.models.basecaller.ctc import greedy_decode as jgreedy_decode
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.data.squiggle import (SquiggleConfig, normalize, pore_table,
                                       simulate_read)
from repro_torch.models import api
from repro_torch.models.basecaller import model as bc
from repro_torch.models.basecaller.ctc import greedy_decode
from repro_torch.serving.engine import Request, ServingEngine
from test_torch_basecaller import models

CHUNK = 300


@pytest.fixture(scope="module")
def served():
    return models("rubicall-smoke", quant=(8, 8), packed=True)


def _reads(n=5, seed=0):
    rs = np.random.RandomState(seed)
    sim, table = SquiggleConfig(noise=0.1, drift=0.0), pore_table()
    return [normalize(simulate_read(rs, sim, table,
                                    int(rs.randint(20, 90)))[0])
            for _ in range(n)]


def _serve(engine, request_cls, reads):
    for i, sig in enumerate(reads):
        engine.submit(request_cls(rid=i, signal=sig))
    done = engine.run()
    return {rid: (r.status, list(map(int, r.out_tokens)))
            for rid, r in done.items()}


@pytest.mark.parametrize("async_dispatch", [False, True])
def test_port_serves_like_the_reference(served, async_dispatch):
    jcfg, tcfg, jp, js, tp, ts = served
    reads = _reads()
    want = _serve(JServingEngine(jp, jcfg, n_slots=2, chunk_samples=CHUNK,
                                 async_dispatch=async_dispatch),
                  JRequest, reads)
    eng = api.make_serving_engine(tp, tcfg, device="cpu", n_slots=2,
                                  chunk_samples=CHUNK,
                                  async_dispatch=async_dispatch)
    got = _serve(eng, Request, reads)
    assert got == want
    assert all(s == "finished" for s, _ in got.values())
    assert sum(len(t) for _, t in got.values()) > 0
    s = eng.metrics.summary()
    assert s["requests_done"] == len(reads) and s["retraces"] == 0


def test_served_bases_equal_offline_greedy():
    """The port's served reads equal its own offline whole-read greedy
    basecall (and the reference's offline call on the same weights).
    Activation quantizers are off here: with them on, a window's scale
    sees the window rather than the read, so chunked serving is only
    near-exact (in both packages); packed int8 weights still take the
    fused qconv1d route."""
    jcfg, tcfg, jp, js, tp, ts = models("rubicall-smoke", quant=(8, 0),
                                        packed=True)
    reads = _reads(4, seed=1)
    eng = ServingEngine(tp, tcfg, n_slots=2, chunk_samples=CHUNK)
    got = _serve(eng, Request, reads)
    for i, sig in enumerate(reads):
        lp, _ = bc.forward(tp, ts, torch.from_numpy(sig[None, :, None]),
                           tcfg, train=False)
        want = [int(v) for v in greedy_decode(lp.numpy())[0]]
        jlp, _ = jbc.forward(jp, js, sig[None, :, None], jcfg, train=False)
        assert [int(v) for v in jgreedy_decode(jlp)[0]] == want
        assert got[i] == ("finished", want), i
