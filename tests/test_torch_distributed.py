"""Data-parallel training across processes (``training/train_loop.run``
with ``mesh=``, ``launch/train.py --coordinator``) against the
one-process run on the same global batch, and the pieces that make the
two equal: BatchNorm's statistics and activation fake-quant's amax over
the data group, the gradient average before the int8 round trip, and
the MoE aux loss's mean over per-row groups.

A rank's rows are its share of every microbatch, so two microbatches
over two ranks are the one-process run's two contiguous halves. Two
ranks of a gloo group over a ``FileStore`` (no socket) run every
case in one pair of processes started once for the module; the launcher
case rendezvouses over ``tcp://127.0.0.1``. Tolerance: where nothing
rounds to a grid (the activation quantizers off, fp32 gradients),
losses within 1e-6 relative and parameters after 3 steps within 1e-6
absolute (fp32: the two runs sum the same terms in other orders).
rubicall-smoke's own policy fake-quantizes activations, and the int8
round trip rounds the gradients: there an activation or a gradient a
few ulps from a grid boundary could land on the other side in one of
the runs, so those cases hold losses within 2e-5 relative and
parameters within 2e-5 absolute (observed at most 1.0e-7 and 1.1e-6;
an amax taken over each rank's own rows parts the runs by 5.1e-5 and
2.0e-4).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_threads import SUBPROCESS_ENV
import torch.distributed as dist

from repro_torch.config import QuantPolicy, get_config
from repro_torch.launch.train import data_for
from repro_torch.models.lm import moe
from repro_torch.training import train_loop
from repro_torch.training.optimizer import AdamWConfig

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
FP32, GRID = 1e-6, 2e-5
# case: (arch, global batch, sequence, activation quantizers as the
#        config has them, int8 gradient round trip, batch statistics:
#        True over the data group, "local" each rank's own, "local-amax"
#        BatchNorm's over the group and the activation amax each rank's;
#        microbatches)
CASES = {
    "rubicall": ("rubicall-smoke", 4, 600, True, False, True, 1),
    "rubicall-float": ("rubicall-smoke", 4, 600, False, False, True, 1),
    "rubicall-float-micro2": ("rubicall-smoke", 4, 600, False, False, True,
                              2),
    "rubicall-int8": ("rubicall-smoke", 4, 600, True, True, True, 1),
    "rubicall-float-local-bn": ("rubicall-smoke", 4, 600, False, False,
                                "local", 1),
    "rubicall-local-amax": ("rubicall-smoke", 4, 600, True, False,
                            "local-amax", 1),
    "granite-moe": ("granite-moe-1b-a400m-smoke", 4, 32, True, False, True,
                    1),
    "granite-moe-int8": ("granite-moe-1b-a400m-smoke", 4, 32, True, True,
                         True, 1),
}
TOL = {"rubicall": GRID, "rubicall-float": FP32,
       "rubicall-float-micro2": FP32, "rubicall-int8": GRID,
       "granite-moe": FP32, "granite-moe-int8": GRID}


def _cfg(arch, quant):
    cfg = get_config(arch)
    return cfg if quant else dataclasses.replace(cfg, quant=QuantPolicy())


RANK_PROGRAM = r"""
import contextlib, dataclasses, json, sys
import torch, torch.distributed as dist
from repro_torch.config import QuantPolicy, get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import data_for
from repro_torch.parallel import data_parallel
from repro_torch.training import train_loop
from repro_torch.training.optimizer import AdamWConfig

rank, world, store, out, cases = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4],
                                  json.loads(sys.argv[5]))
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
mesh = make_host_mesh(1)
sync = data_parallel.batch_stats_over
amax = data_parallel.all_max_
for name, (arch, batch, seq, quant, int8, stats, micro) in cases.items():
    data_parallel.batch_stats_over = (
        lambda group: contextlib.nullcontext()) if stats == "local" else sync
    data_parallel.all_max_ = (
        lambda t: t) if stats == "local-amax" else amax
    cfg = get_config(arch)
    if not quant:
        cfg = dataclasses.replace(cfg, quant=QuantPolicy())
    run = train_loop.run(
        cfg, AdamWConfig(lr=2e-3, total_steps=%(steps)d),
        train_loop.TrainLoopConfig(steps=%(steps)d, log_every=1,
                                   ckpt_every=2,
                                   ckpt_dir=f"{out}/ckpt-{name}",
                                   n_micro=micro,
                                   grad_compress_bits=8 if int8 else 0),
        data_for(cfg, batch, seq), device="cpu", mesh=mesh)
    torch.save({"loss": [r["loss"] for r in run["history"]],
                "params": run["carry"].params},
               f"{out}/{name}-rank{rank}.pt")
dist.destroy_process_group()
""" % {"steps": STEPS}


def _env():
    return dict(os.environ, **SUBPROCESS_ENV, PYTHONPATH=str(ROOT / "src"),
                CUDA_VISIBLE_DEVICES="")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case of :data:`CASES` trained by two gloo ranks; returns
    the directory of their results."""
    out = tmp_path_factory.mktemp("dp")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_PROGRAM, str(r), "2",
         str(out / "store"), str(out), json.dumps(CASES)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    errs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, errs):
        assert p.returncode == 0, o + e
    return out


def _one_process(name, tmp_path):
    arch, batch, seq, quant, int8, _, micro = CASES[name]
    cfg = _cfg(arch, quant)
    run = train_loop.run(
        cfg, AdamWConfig(lr=2e-3, total_steps=STEPS),
        train_loop.TrainLoopConfig(steps=STEPS, log_every=1, ckpt_every=2,
                                   ckpt_dir=str(tmp_path / "ckpt"),
                                   n_micro=micro,
                                   grad_compress_bits=8 if int8 else 0),
        data_for(cfg, batch, seq), device="cpu")
    return [r["loss"] for r in run["history"]], run["carry"].params


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", list(TOL))
def test_two_ranks_equal_one_process_on_the_global_batch(two_ranks, name,
                                                         tmp_path):
    """Losses at every step and every parameter after 3 steps, with and
    without the int8 gradient round trip, at the module's tolerances;
    both ranks hold the same parameters bit for bit, and rank 0 alone
    wrote the checkpoint."""
    tol = TOL[name]
    r0, r1 = (torch.load(two_ranks / f"{name}-rank{r}.pt")
              for r in range(2))
    want_loss, want_params = _one_process(name, tmp_path)
    np.testing.assert_allclose(r0["loss"], want_loss, rtol=tol, atol=0)
    assert r0["loss"] == r1["loss"]
    got = dict(_leaves(r0["params"]))
    other = dict(_leaves(r1["params"]))
    for path, w in _leaves(want_params):
        torch.testing.assert_close(got[path], w, rtol=0, atol=tol, msg=path)
        assert torch.equal(got[path], other[path]), path
    assert sorted(p.name for p in (two_ranks / f"ckpt-{name}").iterdir()) \
        == ["step_0000000002"]


@pytest.mark.parametrize("name,ref,steps", [
    ("rubicall-float-local-bn", "rubicall-float", STEPS),
    ("rubicall-local-amax", "rubicall", 1)])
def test_batch_statistics_need_the_data_group(two_ranks, name, ref, steps,
                                              tmp_path):
    """With BatchNorm's statistics taken over each rank's own rows (the
    activation quantizers off), or the activation amax (BatchNorm over
    the group), the two-rank run parts from the one-process run by more
    than 10x the fp32 tolerance: at every step, or at the first, before
    any update. The collectives are what make the runs equal."""
    r0 = torch.load(two_ranks / f"{name}-rank0.pt")
    want_loss, _ = _one_process(ref, tmp_path)
    rel = [abs(a - b) / abs(b) for a, b in zip(r0["loss"], want_loss)]
    assert min(rel[:steps]) > 10 * FP32


def test_moe_aux_loss_is_the_mean_over_an_even_split():
    """The aux loss averages per-row GShard groups, so the mean of two
    halves' aux losses is the whole batch's."""
    cfg = get_config("granite-moe-1b-a400m-smoke")
    gen = torch.Generator().manual_seed(0)
    p = moe.make_moe_params(gen, cfg)
    x = torch.randn(4, 16, cfg.d_model, generator=gen)
    _, whole = moe.moe_ffn(p, x, cfg)
    halves = [moe.moe_ffn(p, h, cfg)[1] for h in x.split(2)]
    torch.testing.assert_close(whole, sum(halves) / 2, rtol=1e-6, atol=0)


def test_one_rank_group_equals_the_plain_loop_bit_for_bit(tmp_path):
    """On a one-rank group every reduction is the identity, and the
    data-parallel step takes the same formulas as the plain one
    (BatchNorm's sums, the gradient leaves the optimizer reads), so 8
    steps of rubicall-smoke with its quantizers give the same losses and
    parameters bit for bit."""
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config("rubicall-smoke")

    def one(mesh, name):
        run = train_loop.run(
            cfg, AdamWConfig(lr=2e-3, total_steps=8),
            train_loop.TrainLoopConfig(steps=8, log_every=1, ckpt_every=8,
                                       ckpt_dir=str(tmp_path / name)),
            data_for(cfg, 4, 600), device="cpu", mesh=mesh)
        return [r["loss"] for r in run["history"]], run["carry"].params
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        got_loss, got = one(make_host_mesh(1), "dp")
    finally:
        dist.destroy_process_group()
    want_loss, want = one(None, "plain")
    assert got_loss == want_loss
    got = dict(_leaves(got))
    for path, w in _leaves(want):
        assert torch.equal(got[path], w), path


def test_only_activation_amax_reduces_over_the_group(monkeypatch):
    """In a data-parallel step the activation quantizers take the
    group's maximum amax; weight leaves, the same on every rank, are
    quantized per tensor with no collective."""
    from repro_torch.core.quant.fake_quant import quant_dequant_params
    from repro_torch.models.basecaller import blocks
    from repro_torch.parallel import data_parallel
    calls = []
    monkeypatch.setattr(dist, "all_reduce",
                        lambda t, op=None, group=None: calls.append(op))
    cfg = get_config("rubicall-smoke")
    w, x = torch.randn(3, 4, 8), torch.randn(2, 6, 4)
    with data_parallel.batch_stats_over(object()):
        quant_dequant_params({"w": w}, 8, per_channel=False)
        assert calls == []
        blocks._maybe_quant(w, x, cfg, "conv0")
        assert calls == [dist.ReduceOp.MAX]
    blocks._maybe_quant(w, x, cfg, "conv0")
    assert len(calls) == 1


def test_rows_split_the_global_batch_or_raise():
    """A rank's rows are its share of each microbatch: the global
    microbatches are the one-process step's contiguous ones."""
    batch = {"x": np.arange(12).reshape(6, 2)}
    assert train_loop._rows(batch, 1, 3)["x"].tolist() == [[4, 5], [6, 7]]
    micro = {"x": torch.arange(8)}
    assert [train_loop._rows(micro, r, 2, 2)["x"].tolist()
            for r in range(2)] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    with pytest.raises(ValueError, match="over 4 data-parallel ranks"):
        train_loop._rows(batch, 0, 4)
    with pytest.raises(ValueError, match="into 2 microbatches over 2"):
        train_loop._rows(batch, 0, 2, 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp_path, *extra, arch="rubicall"):
    port = _free_port()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           arch, "--smoke", "--device", "cpu", "--steps", "2",
           "--batch", "4", "--seq", "600", "--ckpt-dir",
           str(tmp_path / "ckpt"), "--coordinator", f"127.0.0.1:{port}",
           "--num-hosts", "2", *extra]
    procs = [subprocess.Popen(cmd + ["--host-id", str(r)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        outs.append((p.returncode, out, err))
    return outs


def test_launcher_trains_over_two_processes(tmp_path):
    """``--coordinator --num-hosts 2 --host-id i``: both processes print
    the same losses; ``--model-parallel 3`` does not divide 2 and falls
    back to a model axis of 1, as the reference's."""
    outs = _launch(tmp_path, "--model-parallel", "3")
    for rc, out, err in outs:
        assert rc == 0, out + err
    rows = [[json.loads(line) for line in out.splitlines()]
            for _, out, _ in outs]
    assert [r["step"] for r in rows[0]] == [2]
    assert [r["loss"] for r in rows[0]] == [r["loss"] for r in rows[1]]


def test_launcher_refuses_a_model_axis(tmp_path):
    """``--model-parallel 2`` over 2 ranks gives a model axis of 2, which
    tensor parallelism now splits the SSM kind over (mamba2-130m-smoke:
    its 8 heads, 4 a rank, B and C whole): the launcher trains it, both
    processes printing the same losses, and refuses nothing."""
    outs = _launch(tmp_path, "--model-parallel", "2", "--seq", "32",
                   arch="mamba2-130m")
    for rc, out, err in outs:
        assert rc == 0, out + err
        assert "NotImplementedError" not in err
    rows = [[json.loads(line) for line in out.splitlines()]
            for _, out, _ in outs]
    assert [r["step"] for r in rows[0]] == [2]
    assert np.isfinite(rows[0][0]["loss"])
    assert [r["loss"] for r in rows[0]] == [r["loss"] for r in rows[1]]
    assert not dist.is_initialized()


def test_a_train_run_asked_for_the_card_raises_without_one(monkeypatch,
                                                           tmp_path):
    """No fallback hides the device: without a card, the launcher's
    default ``cuda`` raises before any process group starts, and so does
    the loop on a mesh-less run that asks for no device."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "rubicall", "--smoke", "--steps", "1",
                    "--coordinator", f"127.0.0.1:{_free_port()}",
                    "--num-hosts", "2", "--host-id", "0",
                    "--ckpt-dir", str(tmp_path)])
    assert not dist.is_initialized()
    cfg = get_config("rubicall-smoke")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop.run(cfg, AdamWConfig(), train_loop.TrainLoopConfig(
            steps=1, ckpt_dir=str(tmp_path)), data_for(cfg, 2, 600))
