"""Tensor-parallel training (``training/train_loop.run`` on a ``(data,
model)`` mesh with a model axis above 1, ``parallel/tensor_parallel``)
against the one-process run on the same global batch and seed, and
against the reference's GSPMD run on two XLA host devices.

Ranks are gloo processes over a ``FileStore`` (no socket): one launch of
two ranks runs every ``(1, 2)`` case, one launch of four ranks every
``(2, 2)`` and ``(1, 4)`` case, both started once for the module
beside the reference's subprocess. Each case checks 3 steps' losses,
step 1's gradients gathered to whole leaves and the final parameters.

Tolerances (as ``tests/test_torch_distributed.py``): where nothing
rounds to a grid, losses within 1e-6 relative and parameters after 3
steps within 1e-6 absolute (fp32: a row-parallel product and the
cross-entropy's terms are summed in another order); with activation
fake-quant or the int8 gradient round trip, 2e-5, since a value a few
ulps from a grid boundary may land on the other side in one run.
Gradients: each leaf within 1e-5 of its largest |gradient|. Against
the reference: step 1 within 1e-5 relative, steps 2-3 within 5e-3
(``tests/test_torch_lm_training.py``'s 20-step bound: both packages'
fp32 sums differ in order, and AdamW's first steps amplify that).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_threads import SUBPROCESS_ENV

from repro_torch.compat import FakeTensorMode
from repro_torch.config import QuantPolicy, get_config
from repro_torch.core.quant.policy import tree_items
from repro_torch.launch.train import data_for
from repro_torch.models import api
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.training import elastic, train_loop
from repro_torch.training.checkpoint import CheckpointManager, leaf_items
from repro_torch.training.optimizer import AdamWConfig, init_opt_state

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
FP32, GRID = 1e-6, 2e-5
OPT = dict(lr=2e-3, total_steps=STEPS)
REF_OPT = dict(lr=3e-3, total_steps=STEPS, warmup_steps=1)
REF_ARCHS = ("qwen1.5-4b-smoke", "granite-moe-1b-a400m-smoke")

# case: arch, model axis, world, quantizers ("8x8": QuantPolicy(8, 8);
# None: the config's own), int8 gradient round trip, vocabulary override,
# batch rows, sequence, tolerance
CASES = {
    "qwen": ("qwen1.5-4b-smoke", 2, 2, None, False, 0, 4, 32, FP32),
    "internvl2": ("internvl2-1b-smoke", 2, 2, None, False, 0, 4, 32, FP32),
    "granite-quant": ("granite-moe-1b-a400m-smoke", 2, 2, "8x8", False, 0,
                      4, 32, GRID),
    "granite-quant-int8": ("granite-moe-1b-a400m-smoke", 2, 2, "8x8", True,
                           0, 4, 32, GRID),
    "granite-v255": ("granite-moe-1b-a400m-smoke", 2, 2, None, False, 255,
                     4, 32, FP32),
    "rubicall": ("rubicall-smoke", 2, 2, None, False, 0, 4, 600, GRID),
    "qwen-2x2": ("qwen1.5-4b-smoke", 2, 4, None, False, 0, 4, 32, FP32),
    "granite-quant-2x2": ("granite-moe-1b-a400m-smoke", 2, 4, "8x8", False,
                          0, 4, 32, GRID),
    "qwen-1x4": ("qwen1.5-4b-smoke", 4, 4, None, False, 0, 4, 32, FP32),
    "granite-1x4": ("granite-moe-1b-a400m-smoke", 4, 4, None, False, 0, 4,
                    32, FP32),
}


def _cfg(arch, quant, vocab, cut=None):
    cfg = get_config(arch)
    if quant == "8x8":
        cfg = dataclasses.replace(cfg, quant=QuantPolicy(8, 8))
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return dataclasses.replace(cfg, **cut) if cut else cfg


RANK_PROGRAM = r"""
import dataclasses, json, sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.config import QuantPolicy, ShapeConfig, get_config
from repro_torch.core.quant.policy import tree_items
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import data_for
from repro_torch.models import api
from repro_torch.parallel import sharding as shd, tensor_parallel as tp
from repro_torch.training import train_loop
from repro_torch.training.checkpoint import snapshot
from repro_torch.training.optimizer import AdamWConfig

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
jobs = json.loads(sys.argv[5])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)


def gather(tree, dims, group):
    return {k: tp.whole(t, d, group) for (k, t), (_, d) in zip(
        tree_items(tree), tree_items(dims))}


for name, job in jobs.items():
    cfg = get_config(job["arch"])
    if job["quant"] == "8x8":
        cfg = dataclasses.replace(cfg, quant=QuantPolicy(8, 8))
    if job["vocab"]:
        cfg = dataclasses.replace(cfg, vocab_size=job["vocab"])
    if job.get("cut"):
        cfg = dataclasses.replace(cfg, **job["cut"])
    mesh = make_host_mesh(job["model"])
    mgroup, dgroup = mesh.get_group("model"), mesh.get_group("data")
    mrank, m = shd.model_coordinate(mesh)
    drank, n = mesh.get_local_rank("data"), shd.axis_sizes(mesh)["data"]
    whole = api.init_params(torch.Generator().manual_seed(0), cfg,
                            dtype=torch.float32)
    dims = tp.split_dims(whole, cfg, m)
    res = {"mesh": list(mesh.shape)}
    if job["grads"]:
        shards = tp.shard_tree(whole, dims, mrank, m)
        res["local_bytes"] = {k: t.numel() * t.element_size()
                              for k, t in tree_items(shards)}
        psh = shd.param_shardings(whole, cfg, mesh)
        spec_bytes = []
        shd.zip_map(lambda t, sh: spec_bytes.append(sh.local_bytes(t)),
                    whole, psh)
        res["spec_bytes"] = dict(zip(res["local_bytes"], spec_bytes))
        res["per_device_bytes"] = shd.per_device_bytes(whole, psh)
        batch = next(data_for(cfg, job["batch"], job["seq"]))
        rows = {k: torch.as_tensor(v) for k, v in
                train_loop._rows(batch, drank, n).items()}
        lm = cfg.family != "basecaller"
        tp.reset_counts()
        with tp.over_model(mgroup if lm else None):
            g, _, _ = train_loop.step_grads(
                api.make_loss_fn(cfg), shards, api.init_model_state(cfg),
                rows, 1, dgroup)
        res["step_allreduce"] = dict(tp.COUNTS)
        res["grads"] = gather(g, dims, mgroup)
        res["dryrun"] = dryrun.cell_collectives(
            cfg, ShapeConfig("tp", job["seq"], job["batch"], "train"),
            shd.axis_sizes(mesh),
            dryrun._param_leaves(whole, psh), 1)
    run = train_loop.run(
        cfg, AdamWConfig(**job["opt"]),
        train_loop.TrainLoopConfig(
            steps=job["steps"], log_every=1, ckpt_every=job["ckpt_every"],
            ckpt_dir=job["ckpt_dir"],
            grad_compress_bits=8 if job["int8"] else 0),
        data_for(cfg, job["batch"], job["seq"]), device="cpu", mesh=mesh)
    res["loss"] = [r["loss"] for r in run["history"]]
    local = snapshot(run["carry"])
    key_dim = tp.carry_key_dims(dims)
    res["local"] = local
    res["carry"] = {k: tp.whole(t, key_dim(k), mgroup)
                    for k, t in local.items()}
    torch.save(res, f"{out}/{name}-rank{rank}.pt")
dist.destroy_process_group()
"""

REFERENCE_PROGRAM = r"""
import json, sys
from repro.config import get_config
from repro.data.tokens import token_batches
from repro.launch.mesh import make_host_mesh
from repro.training import optimizer, train_loop

jobs, opt, steps = json.loads(sys.argv[1]), json.loads(sys.argv[2]), int(
    sys.argv[3])
mesh = make_host_mesh(2)
assert dict(mesh.shape) == {"data": 1, "model": 2}, mesh.shape
out = {}
for arch, ckpt_dir in jobs.items():
    cfg = get_config(arch)
    run = train_loop.run(
        cfg, optimizer.AdamWConfig(**opt),
        train_loop.TrainLoopConfig(steps=steps, log_every=1,
                                   ckpt_every=1000, ckpt_dir=ckpt_dir),
        token_batches(cfg, 4, 32), mesh=mesh)
    out[arch] = [r["loss"] for r in run["history"]]
print(json.dumps(out))
"""


def _env(**extra):
    return dict(os.environ, **SUBPROCESS_ENV, PYTHONPATH=str(ROOT / "src"),
                CUDA_VISIBLE_DEVICES="", **extra)


def _job(name, out, cases=None, **kw):
    arch, model, _, quant, int8, vocab, batch, seq, _ = (cases or CASES)[name]
    job = dict(arch=arch, model=model, quant=quant, int8=int8, vocab=vocab,
               batch=batch, seq=seq, grads=True, opt=OPT, steps=STEPS,
               ckpt_every=STEPS, ckpt_dir=str(out / f"ckpt-{name}"))
    job.update(kw)
    return job


def _reference_checkpoints(out, archs=REF_ARCHS):
    """One step-0 checkpoint of the reference's init per arch of
    ``archs``, written as ``test_torch_lm_training`` writes it."""
    import jax

    from repro.config import get_config as jget_config
    from repro.models import api as japi
    from repro.training import checkpoint as jckpt
    from repro.training import optimizer as jopt
    dirs = {}
    for arch in archs:
        jcfg = jget_config(arch)
        jp = japi.init_params(jax.random.key(2), jcfg)
        d = out / f"ref-{arch}"
        jckpt.CheckpointManager(str(d)).save(0, japi.TrainCarry(
            jp, jopt.init_opt_state(jp, jopt.AdamWConfig(**REF_OPT)), {}))
        dirs[arch] = d
    return dirs


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case trained by its ranks, the reference's GSPMD losses and
    the one-process checkpoint the ``ckpt-load`` case restores; returns
    the results' directory and the reference's losses."""
    out = tmp_path_factory.mktemp("tp")
    ref = _reference_checkpoints(out)
    # a one-process checkpoint at step 2, restored by two ranks
    cfg = get_config("qwen1.5-4b-smoke")
    train_loop.run(cfg, AdamWConfig(**OPT), train_loop.TrainLoopConfig(
        steps=2, log_every=1, ckpt_every=2, ckpt_dir=str(out / "one")),
        data_for(cfg, 4, 32), device="cpu")
    jobs = {2: {}, 4: {}}
    for name, case in CASES.items():
        jobs[case[2]][name] = _job(name, out)
    jobs[2]["ckpt-load"] = _job("qwen", out, grads=False, steps=2,
                                ckpt_dir=_copy(out / "one",
                                               out / "ckpt-load"))
    for arch in REF_ARCHS:
        jobs[2][f"ref-{arch}"] = dict(
            _job("qwen", out), arch=arch, grads=False, opt=REF_OPT,
            ckpt_every=1000, ckpt_dir=_copy(ref[arch], out / f"port-{arch}"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE_PROGRAM, json.dumps(
            {a: _copy(d, out / f"jax-{a}") for a, d in ref.items()}),
         json.dumps(REF_OPT), str(STEPS)],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    for world, js in jobs.items():
        procs += [subprocess.Popen(
            [sys.executable, "-c", RANK_PROGRAM, str(r), str(world),
             str(out / f"store{world}"), str(out), json.dumps(js)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, o + e
    return out, json.loads(outs[0][0].splitlines()[-1])


def _ranks(out, name, cases=None):
    cases = cases or CASES
    world = cases[name][2] if name in cases else 2
    return [torch.load(out / f"{name}-rank{r}.pt") for r in range(world)]


def _one_process(name, tmp_path, cases=None, cut=None):
    """(losses, whole carry snapshot, step 1's gradients) of the
    one-process run of a case (``cut``: fields of its config replaced)."""
    arch, _, _, quant, int8, vocab, batch, seq, _ = (cases or CASES)[name]
    cfg = _cfg(arch, quant, vocab, cut)
    run = train_loop.run(
        cfg, AdamWConfig(**OPT), train_loop.TrainLoopConfig(
            steps=STEPS, log_every=1, ckpt_every=1000,
            ckpt_dir=str(tmp_path / "ckpt"),
            grad_compress_bits=8 if int8 else 0),
        data_for(cfg, batch, seq), device="cpu")
    params = api.init_params(torch.Generator().manual_seed(0), cfg,
                             dtype=torch.float32)
    b = {k: torch.as_tensor(v) for k, v in
         next(data_for(cfg, batch, seq)).items()}
    g, _, _ = train_loop.step_grads(api.make_loss_fn(cfg), params,
                                    api.init_model_state(cfg), b, 1)
    return ([r["loss"] for r in run["history"]],
            dict(leaf_items(run["carry"])), dict(tree_items(g)))


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_parallel_step_equals_one_process(runs, name, tmp_path):
    """3 steps' losses, step 1's gradients (gathered whole, each leaf
    within 1e-5 of its largest |gradient|) and the final parameters and
    AdamW moments (gathered whole) against the one-process run; every
    rank logs the same losses and gathers the same whole carry bit for
    bit. Under the int8 round trip the moments are left out: a gradient
    that lands one int8 step away in one run moves its ``m`` by 0.1 of
    that step (observed 3.0e-5), its parameter by far less (1.3e-6)."""
    out, _ = runs
    _holds_one_process(_ranks(out, name), _one_process(name, tmp_path),
                       CASES[name][-1], CASES[name][4])


def _holds_one_process(ranks, one, tol, int8=False, noise_reach=0.0):
    """The ranks' results against the one-process run's ``one``
    (:func:`_one_process`) under
    :func:`test_tensor_parallel_step_equals_one_process`'s contract.
    ``noise_reach``: the bound of a parameter whose step-1 gradient is
    rounding noise (at most 1e-6 of its leaf's largest |gradient|), for
    which AdamW's normalised step ``m / (sqrt(v) + eps)`` takes any value
    in (-1, 1) in either run (0: held as every other)."""
    want_loss, want_carry, want_grads = one
    np.testing.assert_allclose(ranks[0]["loss"], want_loss, rtol=tol, atol=0)
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        for k, t in r["carry"].items():
            assert torch.equal(t, ranks[0]["carry"][k]), k
    for k, w in want_grads.items():
        got = ranks[0]["grads"][k]
        assert got.shape == w.shape, k
        scale = max(float(w.abs().max()), 1e-30)
        assert float((got - w).abs().max()) <= 1e-5 * scale, k
    assert set(ranks[0]["carry"]) == set(want_carry)
    for k, w in want_carry.items():
        if int8 and k.startswith((".opt_state/.m/", ".opt_state/.v/")):
            continue
        got = ranks[0]["carry"][k]
        assert got.shape == w.shape, k
        g = want_grads.get(k[len(".params/"):]) if noise_reach else None
        if g is not None:
            noise = g.abs() <= 1e-6 * float(g.abs().max())
            d = (got - w)[noise].abs()
            assert not d.numel() or float(d.max()) <= noise_reach, k
            got, w = got[~noise], w[~noise]
        torch.testing.assert_close(got, w, rtol=0, atol=tol, msg=k)


# the leaves where the unit rule and the dry run's flat-dim filter part:
# at a model axis of 4 with 2 KV heads the rule keeps the attention
# whole, where ``_filter_axes`` cuts wk/wv's 32 columns into half-heads
# (and wq, wo by their flat dims); internvl2's vision_proj stays whole,
# its output being the replicated residual
UNIT_RULE_DIFFERS = {
    "qwen-1x4": {f"groups/g0_dense/attn/{w}/{k}" for w in ("wq", "wk", "wv")
                 for k in ("kernel", "bias")}
    | {"groups/g0_dense/attn/wo/kernel"},
    "granite-1x4": {f"groups/g0_moe/attn/{w}/kernel"
                    for w in ("wq", "wk", "wv", "wo")},
    "internvl2": {"vision_proj/kernel"},
}


@pytest.mark.parametrize("name", ["qwen", "internvl2", "granite-v255",
                                  "rubicall", "qwen-2x2", "qwen-1x4",
                                  "granite-1x4"])
def test_rank_bytes_are_the_per_device_bytes_of_the_mesh(runs, name):
    """Each rank's parameter bytes equal ``sharding.per_device_bytes`` on
    the same host mesh, leaf by leaf, wherever the unit rule and
    ``_filter_axes`` agree; the leaves where they part are named
    (:data:`UNIT_RULE_DIFFERS`) and hold the whole leaf. Over a data
    axis of 2 the parameters are replicated."""
    out, _ = runs
    if name == "qwen-2x2":
        # the data axis replicates the parameters (the reference's specs
        # shard d_model dims over it, FSDP): each rank holds what a rank
        # of the (1, 2) mesh holds
        want = _ranks(out, "qwen")[0]["local_bytes"]
        assert all(r["local_bytes"] == want for r in _ranks(out, name))
        return
    for r in _ranks(out, name):
        differ = {k for k, b in r["local_bytes"].items()
                  if b != r["spec_bytes"][k]}
        assert differ == UNIT_RULE_DIFFERS.get(name, set()), differ
        if not differ:
            assert sum(r["local_bytes"].values()) == r["per_device_bytes"]
    if name == "granite-v255":        # the odd vocabulary stays whole
        assert r["local_bytes"]["embed"] == 255 * 64 * 4


def _restore_whole(path):
    """(step, {key: leaf}) of the newest checkpoint in ``path``, restored
    in one process into qwen1.5-4b-smoke's whole carry."""
    cfg = get_config("qwen1.5-4b-smoke")
    like = api.init_params(torch.Generator().manual_seed(1), cfg,
                           dtype=torch.float32)
    step, carry = CheckpointManager(str(path)).restore(
        api.TrainCarry(like, init_opt_state(like, AdamWConfig(**OPT)), {}))
    return step, dict(leaf_items(carry))


def test_a_checkpoint_saved_at_model_2_restores_in_one_process(runs):
    """Rank 0 of the ``(1, 2)`` qwen run wrote whole leaves at step 3;
    one process restores them bit for bit: the whole carry both ranks
    gathered, every leaf of it."""
    out, _ = runs
    r0 = _ranks(out, "qwen")[0]
    step, got = _restore_whole(out / "ckpt-qwen")
    assert step == STEPS
    assert set(got) == set(r0["carry"])
    for k, t in r0["carry"].items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


def test_a_one_process_checkpoint_restores_at_model_2(runs):
    """A one-process step-2 checkpoint, restored by two ranks: each
    rank's leaf is its part of the whole leaf (a split dim's half, or
    the whole leaf) bit for bit, and the two parts gather back to it."""
    out, _ = runs
    step, want = _restore_whole(out / "one")
    assert step == 2
    cfg = get_config("qwen1.5-4b-smoke")
    with FakeTensorMode():
        dims = tp.split_dims(api.init_params(
            torch.Generator().manual_seed(0), cfg, device="cpu"), cfg, 2)
    key_dim = tp.carry_key_dims(dims)
    split = 0
    for r, res in enumerate(_ranks(out, "ckpt-load")):
        assert res["loss"] == []
        for k, w in want.items():
            assert torch.equal(res["carry"][k], w), k
            d = key_dim(k)
            part = w if d is None else w.chunk(2, d)[r]
            split += d is not None
            assert torch.equal(res["local"][k], part), k
    assert split == 2 * 3 * 12          # params, m, v: 12 split leaves


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_model_axis_follows_the_reference_gspmd_run(runs, arch):
    """The reference's ``train_loop.run`` on two XLA host devices at
    ``(data=1, model=2)`` and the port's two gloo ranks at ``(1, 2)``,
    both resumed from one step-0 checkpoint of the reference's init, 3
    steps on their token streams: step 1 within 1e-5 relative, steps
    2-3 within 5e-3."""
    out, want = runs
    got = _ranks(out, f"ref-{arch}")[0]["loss"]
    assert len(got) == len(want[arch]) == STEPS
    np.testing.assert_allclose(got[:1], want[arch][:1], rtol=1e-5)
    np.testing.assert_allclose(got, want[arch], rtol=5e-3)


def test_step_all_reduce_bytes_match_the_dry_run_s_accounting(runs):
    """One qwen1.5-4b-smoke step's model-group all-reduce bytes at
    ``(1, 2)`` (remat off): the dry run's all-reduce count for the same
    cell (the vocab-split embedding's and each row-parallel ``wo``'s
    output, forward and backward) plus the cross-entropy's three fp32
    values a token. granite-moe-smoke's step sums its MoE combine (the
    experts' fp32 output forward; the input's and the combine weights'
    gradients backward) by all-reduce where the dry run counts
    all-to-alls: the step's bytes are the dry run's all-reduce plus
    those, by name."""
    out, _ = runs
    r = _ranks(out, "qwen")[0]
    cfg = get_config("qwen1.5-4b-smoke")
    tokens = 4 * 32
    ce = 3 * tokens * 4
    assert r["step_allreduce"]["bytes"] == r["dryrun"]["all-reduce"] + ce
    # the embedding, then each layer's attention and MLP, forward and
    # backward, and the cross-entropy's three
    assert r["step_allreduce"]["calls"] == 2 * (1 + 2 * cfg.n_layers) + 3
    # granite at vocabulary 255: the vocabulary whole (no embedding or
    # cross-entropy reduction), the attention and the experts split
    g = _ranks(out, "granite-v255")[0]
    cfg = get_config("granite-moe-1b-a400m-smoke")
    d, L, E = cfg.d_model, cfg.n_layers, cfg.n_experts
    moe = L * tokens * 4 * (d + d + E)
    assert g["step_allreduce"]["bytes"] == g["dryrun"]["all-reduce"] + moe
    assert g["dryrun"]["all-to-all"] > 0


def test_outside_over_model_every_function_is_the_identity(monkeypatch):
    """No group, no collective: the Megatron pair, the helper and the
    cross-entropy are the local ones."""
    from repro_torch.models.lm.common import cross_entropy

    def boom(*a, **k):
        raise AssertionError("a collective was issued")
    monkeypatch.setattr(torch.distributed, "all_reduce", boom)
    x = torch.randn(3, 5, requires_grad=True)
    assert tp.copy_to_model(x) is x and tp.reduce_from_model(x) is x
    assert tp.all_reduce_(x) is x and tp.size() == 1 and tp.rank() == 0
    labels = torch.tensor([1, -1, 4])
    got = cross_entropy(x, labels, vocab_size=5)
    lse = torch.logsumexp(x, -1)
    want = ((lse - x[torch.arange(3), labels.clamp(min=0)])
            * (labels >= 0)).sum()
    torch.testing.assert_close(got[0], want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch,model,whole", [
    ("granite-moe-1b-a400m", 2, {"embed"}),
    ("qwen1.5-4b", 8, {"attn"}),
    ("qwen1.5-4b-smoke", 4, {"attn"}),
])
def test_the_unit_rule_s_worked_cases(arch, model, whole):
    """granite-moe's published vocabulary of 49155 stays whole at 2;
    qwen1.5-4b's 20 heads stay whole at 8; the smoke configs' 4 query
    and 2 KV heads stay whole at 4 while their MLP splits. Every other
    unit splits where ``model`` divides it."""
    cfg = get_config(arch)
    with FakeTensorMode():
        params = api.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu", dtype=torch.float32)
    items = tree_items(tp.split_dims(params, cfg, model))
    kept = {k for k, d in items if d is None}
    for unit in whole:
        assert all(k in kept for k, _ in items if unit in k.split("/")), unit
    assert any(d is not None for k, d in items if "ffn" in k)


def test_local_shard_and_reshard_cut_whole_leaves():
    """``local_shard`` (one leaf, from its path) and ``elastic.reshard``
    with a model size (a tree) give rank ``i`` part ``i`` of each split
    dim, whole leaves whole, the same on both routes."""
    cfg = get_config("qwen1.5-4b-smoke")
    whole = api.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu", dtype=torch.float32)

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (1, 2)

        def __init__(self, r):
            self.r = r

        def get_local_rank(self, axis):
            return self.r
    for r in range(2):
        cut = dict(tree_items(elastic.reshard(whole, cfg=cfg, model=2,
                                                 index=r)))
        for k, t in tree_items(whole):
            assert torch.equal(tp.local_shard(t, k, cfg, Mesh(r)), cut[k])
        assert cut["embed"].shape == (128, 64)
        assert torch.equal(cut["embed"], whole["embed"][128 * r:][:128])
        assert cut["final_norm/scale"].shape == (64,)


@pytest.mark.parametrize("arch,kind", [
    ("mamba2-130m-smoke", "ssm"), ("deepseek-v3-671b-smoke", "mla_dense"),
    ("hymba-1.5b-smoke", "hybrid_full"), ("whisper-tiny-smoke", "xdec")])
def test_a_model_axis_on_an_unsplit_kind_raises(arch, kind):
    """No block kind is left unsplit: the MLA, SSM, hybrid and
    encoder-decoder kinds get a model group on a model axis of 2, and
    the unit rule splits a leaf of that kind's mixer at 2 (MLA's
    ``wuq``, the SSM's ``in_proj`` in segments, the hybrid's attention
    and SSM, the cross-attention's ``wq``); the basecaller replicates
    over the axis (no model group)."""
    from repro_torch.parallel.sharding import Segments

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (1, 2)

        def get_local_rank(self, axis):
            return 0

        def get_group(self, axis):
            return axis
    cfg = get_config(arch)
    got = train_loop._mesh_group(Mesh(), cfg)
    assert got[3] == "model" and got[4:] == (0, 2)
    assert train_loop._mesh_group(Mesh(), get_config("rubicall-smoke"))[
        3] is None
    with FakeTensorMode():
        params = api.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu", dtype=torch.float32)
    dims = dict(tree_items(tp.split_dims(params, cfg, 2)))
    g = f"groups/g0_{kind}/"
    want = {"ssm": {g + "ssm/in_proj/kernel"},
            "mla_dense": {g + "attn/wuq/kernel", g + "attn/wo/kernel"},
            "hybrid_full": {g + "attn/wq/kernel", g + "ssm/conv_w"},
            "xdec": {g + "xattn/wq/kernel", g + "xattn/wo/kernel"}}[kind]
    assert all(dims[k] is not None for k in want), dims
    if kind == "ssm":
        assert isinstance(dims[g + "ssm/in_proj/kernel"], Segments)


def test_launcher_trains_with_a_model_axis(tmp_path):
    """``--arch qwen1.5-4b --smoke --model-parallel 2`` over 2 processes:
    both print the same losses."""
    from test_torch_distributed import _launch
    outs = _launch(tmp_path, "--model-parallel", "2", "--seq", "32",
                   arch="qwen1.5-4b")
    for rc, out, err in outs:
        assert rc == 0, out + err
    rows = [[json.loads(line) for line in out.splitlines()]
            for _, out, _ in outs]
    assert [r["step"] for r in rows[0]] == [2]
    assert [r["loss"] for r in rows[0]] == [r["loss"] for r in rows[1]]
