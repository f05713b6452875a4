"""Training infrastructure parity: gradient compression, checkpoints
(the reference's on-disk layout, both ways), the training loop's resume,
the launcher, and the identity harness on a model the reference trained
(smoke size, CPU).

Exact wherever the reference is exact: int8 gradient codes, restored
checkpoints (bit for bit), a resumed run against an uninterrupted one,
greedy calls and read identity of a bridged reference-trained model.
Gradient compression's scales and round trip: 1e-7 (one fp32 division
and product on the same values).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import SUBPROCESS_ENV

from repro.config import QuantPolicy as JQuantPolicy
from repro.config import get_config as jget_config
from repro.core.quant.policy import quantize_tree as jquantize_tree
from repro.data.align import identity as jidentity
from repro.models import api as japi
from repro.models.basecaller import model as jbc
from repro.models.basecaller.ctc import greedy_decode as jgreedy_decode
from repro.training import checkpoint as jckpt
from repro.training import grad_compress as jgc
from repro.training import optimizer as jopt
from repro_torch import bridge
from repro_torch.config import QuantPolicy, get_config
from repro_torch.core.quant.policy import quantize_tree, tree_items, tree_map
from repro_torch.data.squiggle import SquiggleConfig, batches
from repro_torch.kernels import ops
from repro_torch.models import api
from repro_torch.training import checkpoint, evaluate, grad_compress
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop
from test_torch_training import (_close_tree, _j, _jflat, _np, _rand_tree,
                                 _t, _tflat)

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# Gradient compression


def test_grad_compress_roundtrip_matches_reference():
    rs = np.random.RandomState(3)
    g, e = _rand_tree(rs), _rand_tree(rs, scale=1e-3)
    wq, ws, we = jgc.compress_tree(_j(g), _j(e))
    tq, ts, te = grad_compress.compress_tree(_t(g), _t(e))
    for k, w in _jflat(wq).items():
        assert _tflat(tq)[k].dtype == np.int8
        np.testing.assert_array_equal(_tflat(tq)[k], w, err_msg=k)
    _close_tree(ts, ws, 1e-7, 0)
    _close_tree(te, we, 0, 1e-7)
    wd, _ = jgc.roundtrip_tree(_j(g), _j(e))
    td, _ = grad_compress.roundtrip_tree(_t(g), _t(e))
    _close_tree(td, wd, 1e-7, 0)


# ---------------------------------------------------------------------------
# Checkpoints


def _carry(cfg, state_bits=0, zero=False):
    """A carry after one AdamW update (non-zero moments), or (``zero``)
    one of the same structure holding zeros, to restore into."""
    p = api.init_params(torch.Generator().manual_seed(0), cfg)
    oc = opt.AdamWConfig(state_bits=state_bits)
    st = opt.init_opt_state(p, oc)
    if zero:
        return api.TrainCarry(tree_map(torch.zeros_like, p), st,
                              tree_map(torch.zeros_like,
                                       api.init_model_state(cfg)))
    g = tree_map(lambda t: torch.randn(t.shape, generator=torch.Generator()
                                       .manual_seed(t.numel())), p)
    p, st, _ = opt.adamw_update(p, g, st, oc)
    return api.TrainCarry(p, st, api.init_model_state(cfg))


def _equal(a, b):
    ia, ib = tree_items(a), tree_items(b)
    assert [k for k, _ in ia] == [k for k, _ in ib]
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for (_, x), (_, y) in zip(ia, ib))


def _carry_items(carry):
    return [("params", carry.params), ("m", carry.opt_state.m),
            ("v", carry.opt_state.v), ("state", carry.model_state)]


@pytest.mark.parametrize("state_bits", [0, 8])
def test_checkpoint_round_trip_keep_and_corrupt(tmp_path, state_bits):
    cfg = get_config("rubicall-smoke")
    carry = _carry(cfg, state_bits)
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        bumped = carry._replace(opt_state=carry.opt_state._replace(
            step=torch.tensor(step, dtype=torch.int32)))
        mgr.save_async(step, bumped)
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_0000000002", "step_0000000003"]
    like = _carry(cfg, state_bits, zero=True)
    step, got = mgr.restore(like)
    assert step == 3 and int(got.opt_state.step) == 3
    assert got.opt_state.step.dtype == torch.int32
    for (_, a), (_, b) in zip(_carry_items(got), _carry_items(carry)):
        assert _equal(a, b)
    if state_bits == 8:
        assert _equal(got.opt_state.m_scale, carry.opt_state.m_scale)
    # flip a byte of a leaf of the newest: it is skipped for step 2
    newest = tmp_path / "step_0000000003"
    leaf = sorted(newest.glob("*.npy"))[0]
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    assert mgr.latest_valid() == (2, tmp_path / "step_0000000002")
    assert mgr.restore(like)[0] == 2
    (tmp_path / "step_0000000002" / "manifest.json").unlink()
    assert mgr.latest_valid() is None


def test_checkpoint_written_by_the_reference_restores_bit_exact(tmp_path):
    """The JAX package's CheckpointManager writes a TrainCarry of
    rubicall-smoke params (with int8 AdamW state and the BN state); the
    port restores it into its own carry: same keys, every leaf equal,
    dtypes kept. And the port's checkpoint of the bridged carry has the
    reference's manifest keys."""
    jcfg = jget_config("rubicall-smoke")
    jp = jbc.init_params(jax.random.key(2), jcfg)
    joc = jopt.AdamWConfig(state_bits=8)
    jp2, js2, _ = jopt.adamw_update(jp, jax.tree.map(jnp.ones_like, jp),
                                    jopt.init_opt_state(jp, joc), joc)
    jcarry = japi.TrainCarry(jp2, js2, jbc.init_state(jcfg))
    jckpt.CheckpointManager(str(tmp_path / "jax")).save(7, jcarry)
    want = json.loads((tmp_path / "jax" / "step_0000000007" /
                       "manifest.json").read_text())["leaves"]
    mgr = checkpoint.CheckpointManager(str(tmp_path / "jax"))
    step, got = mgr.restore(_carry(get_config("rubicall-smoke"), 8,
                                   zero=True))
    assert step == 7
    flat = dict(checkpoint.leaf_items(got))
    assert sorted(flat) == sorted(want)
    for k, v in _jflat(jcarry).items():
        assert flat[k].dtype == bridge._tensor(v, "cpu").dtype
        np.testing.assert_array_equal(flat[k].numpy(), v, err_msg=k)
    checkpoint.CheckpointManager(str(tmp_path / "port")).save(7, got)
    mine = json.loads((tmp_path / "port" / "step_0000000007" /
                       "manifest.json").read_text())["leaves"]
    assert mine == want


# ---------------------------------------------------------------------------
# The loop and the launcher


def _loop(tmp_path, steps, resume=True, **kw):
    cfg = get_config("rubicall-smoke")
    data = batches(SquiggleConfig(chunk_len=256, seed=5), 2)
    return train_loop.run(
        cfg, opt.AdamWConfig(lr=3e-3, total_steps=6, warmup_steps=1),
        train_loop.TrainLoopConfig(steps=steps, log_every=1, ckpt_every=3,
                                   ckpt_dir=str(tmp_path), resume=resume,
                                   **kw),
        data, torch.Generator().manual_seed(4), device="cpu"), data


@pytest.mark.parametrize("compress", [0, 8])
def test_train_loop_resume_equals_an_uninterrupted_run(tmp_path, compress):
    """6 steps in one run == 3 steps, a restart from the step-3
    checkpoint (the data iterator resumes where it stopped), then 3
    more; bit for bit. Under int8 gradient compression the error
    feedback state restarts at zero, so there only the first run's rows
    and the restored carry are compared."""
    full, _ = _loop(tmp_path / "a", 6, grad_compress_bits=compress)
    first, data = _loop(tmp_path / "b", 3, grad_compress_bits=compress)
    assert [r["step"] for r in full["history"]] == list(range(1, 7))
    assert set(full["history"][0]) == {"loss", "grad_norm", "lr", "step",
                                       "wall_s"}
    for a, b in zip(first["history"], full["history"]):
        assert {k: a[k] for k in ("loss", "grad_norm", "lr")} == \
            {k: b[k] for k in ("loss", "grad_norm", "lr")}
    cfg = get_config("rubicall-smoke")
    second = train_loop.run(
        cfg, opt.AdamWConfig(lr=3e-3, total_steps=6, warmup_steps=1),
        train_loop.TrainLoopConfig(steps=6, log_every=1, ckpt_every=3,
                                   ckpt_dir=str(tmp_path / "b"),
                                   grad_compress_bits=compress),
        data, torch.Generator().manual_seed(99), device="cpu")
    assert [r["step"] for r in second["history"]] == [4, 5, 6]
    if compress:
        return
    for a, b in zip(second["history"], full["history"][3:]):
        assert {k: a[k] for k in ("loss", "grad_norm", "lr")} == \
            {k: b[k] for k in ("loss", "grad_norm", "lr")}
    assert _equal(second["carry"].params, full["carry"].params)
    assert _equal(second["carry"].model_state, full["carry"].model_state)


def test_train_launcher_prints_history_rows(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "rubicall", "--smoke", "--steps", "4", "--batch", "2", "--seq",
         "256", "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, **SUBPROCESS_ENV,
             "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert rows[-1]["step"] == 4 and np.isfinite(rows[-1]["loss"])


def test_train_launcher_trains_an_lm(tmp_path, capsys):
    """``--arch qwen1.5-4b --smoke --device cpu``: the LM branch of
    ``data_for`` (the token stream) through the loop, a row a logged
    step, finite losses and a checkpoint at the last step."""
    from repro_torch.launch import train
    train.main(["--arch", "qwen1.5-4b", "--smoke", "--steps", "4",
                "--batch", "2", "--seq", "32", "--ckpt-every", "4",
                "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in rows] == [4]
    assert np.isfinite(rows[-1]["loss"]) and rows[-1]["loss"] > 0
    assert (tmp_path / "step_0000000004" / "manifest.json").exists()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_launcher_refuses_what_is_not_ported(multi_pod, tmp_path):
    """The production meshes (model axis 16, on stand-in ranks): every
    block kind takes a model axis, and the unit rule at 16 keeps
    mamba2-130m-smoke's 8 SSM heads whole (every leaf of its blocks on
    every rank) while its vocabulary of 256 splits; the single-pod mesh
    gives the loop its model group of 16. The multi-pod mesh, whose
    ``pod`` axis the loop does not train over, is refused before a
    parameter is drawn."""
    import torch
    import torch.distributed as dist

    from repro_torch.compat import FakeTensorMode
    from repro_torch.core.quant.policy import tree_items
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import api
    from repro_torch.parallel import tensor_parallel as tp
    cfg = get_config("mamba2-130m-smoke")
    with FakeTensorMode():
        params = api.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu", dtype=torch.float32)
    dims = dict(tree_items(tp.split_dims(params, cfg, 16)))
    assert all(d is None for k, d in dims.items() if "/ssm/" in k)
    assert dims["embed"] == 0
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        if multi_pod:
            with pytest.raises(NotImplementedError,
                               match="trains on a \\(data, model\\) mesh"):
                train_loop.run(cfg, opt.AdamWConfig(),
                               train_loop.TrainLoopConfig(
                                   steps=1, ckpt_dir=str(tmp_path)),
                               iter(()), device="cpu", mesh=mesh)
        else:
            got = train_loop._mesh_group(mesh, cfg)
            assert got[3] is not None and got[5] == 16
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Identity harness


@pytest.fixture(scope="module")
def ref_trained():
    """rubicall-smoke under QuantPolicy(8, 8), trained by the reference
    harness's ``train_model`` for 300 steps: the reference's identity
    test's setting (its model reaches identity ~0.018 there, so some
    calls hold bases)."""
    sys.path.insert(0, str(ROOT))
    from benchmarks.common import train_model
    jcfg = dataclasses.replace(jget_config("rubicall-smoke"),
                               quant=JQuantPolicy(8, 8))
    tcfg = dataclasses.replace(get_config("rubicall-smoke"),
                               quant=QuantPolicy(8, 8))
    jp, js, _ = train_model(jcfg, steps=300)
    return jcfg, tcfg, jp, js


def _ref_calls(jcfg, jp, js, n_batches):
    it = evaluate.data_iter(77)
    out = []
    for _ in range(n_batches):
        b = next(it)
        lp, _ = jbc.forward(jp, js, jnp.asarray(b["signal"]), jcfg,
                            train=False)
        out += [np.asarray(c) for c in jgreedy_decode(np.asarray(lp))]
    return out


@pytest.mark.parametrize("packed", [False, True])
def test_reference_trained_model_basecalls_identically(ref_trained, packed,
                                                       monkeypatch):
    """A model the reference trained, bridged: the same greedy calls
    read for read and the same identity, float and packed int8 (every
    conv, min_size=1, as the reference's identity test packs; the port's
    packed forward goes through qconv1d_block's plain version on the
    three fused blocks)."""
    jcfg, tcfg, jp, js = ref_trained
    tp, ts = _t(_np(jp)), _t(_np(js))
    if packed:
        jp = jquantize_tree(jp, JQuantPolicy(8, 0), min_size=1)
        tp = quantize_tree(tp, QuantPolicy(8, 0), min_size=1)
    fused = []
    real = ops.qconv1d_block

    def spy(x, *a, **k):
        fused.append(x.device.type)
        return real(x, *a, **k)
    monkeypatch.setattr(ops, "qconv1d_block", spy)
    calls = evaluate.basecall(tcfg, tp, ts, n_batches=2)
    # blocks 01-03 fuse when packed: 3 a forward, on the CPU tensors
    assert fused == (["cpu"] * 6 if packed else [])
    want = _ref_calls(jcfg, jp, js, n_batches=2)
    assert [list(c) for c, _ in calls] == [list(c) for c in want]
    assert sum(len(c) for c in want) > 0
    truth = [t for _, t in calls]
    assert evaluate.eval_identity(tcfg, tp, ts, n_batches=2) == \
        pytest.approx(float(np.mean([jidentity(c, t) for c, t in
                                     zip(want, truth)])), abs=1e-12)


def test_training_entry_points_refuse_to_run_without_cuda(monkeypatch):
    """Without a card and without ``device="cpu"`` (``--device cpu``)
    the training entry points raise instead of training on the CPU."""
    from repro_torch.core.qabas.search import QABASConfig, run_search
    from repro_torch.core.qabas.space import TINY_SPACE
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("rubicall-smoke")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "rubicall", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop.run(cfg, opt.AdamWConfig(), train_loop.TrainLoopConfig(
            steps=1), iter(()))
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.train_model(cfg, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_search(None, TINY_SPACE, QABASConfig(steps=1), iter(()))
