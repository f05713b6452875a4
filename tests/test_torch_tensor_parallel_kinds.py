"""Tensor-parallel training of the MLA, SSM, hybrid and encoder-decoder
block kinds (``training/train_loop.run`` on a ``(data, model)`` mesh
with a model axis above 1) against the one-process run on the same
global batch and seed, and against the reference's GSPMD run on two
XLA host devices.

The helpers, the ranks' program and the contract are
``tests/test_torch_tensor_parallel.py``'s: gloo processes over a
``FileStore``, one launch of two ranks for every ``(1, 2)`` case and one
of four for the ``(2, 2)`` and ``(1, 4)`` cases, started once for the
module beside the reference's subprocess and a pair of ranks that take
the global norm of a hand-built gradient tree. Each case checks 3
steps' losses (1e-6 relative; 2e-5 where a grid rounds), step 1's
gradients gathered whole (each leaf within 1e-5 of its largest
|gradient|), the final carry gathered whole, and every rank equal bit
for bit. Against the reference: step 1 within 1e-5 relative, steps 2-3
within 5e-3. A weight whose step-1 gradient is rounding noise is held
within AdamW's reach over the steps instead (:data:`NOISE_REACH`).

The cases: deepseek-v3-671b-smoke (an ``mla_dense`` and an ``mla_moe``
layer and the ``mtp`` block), mamba2-130m-smoke (``ssm``: ``in_proj``
and the conv split in segments, B and C whole), hymba-1.5b-smoke cut to
4 layers with window 8 (a ``hybrid_swa`` layer in the plan) and
whisper-tiny-smoke (``xdec`` over the encoder) at ``(1, 2)``; hymba at
``(1, 4)``, where its 2 KV heads keep the attention whole while its 8
SSM heads split (the hybrid's mixed case); deepseek at ``(1, 4)``,
where MLA's ``wo`` splits by its 4 query heads though ``n_kv_heads`` is
2; mamba2 at ``(2, 2)``.
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_threads import SUBPROCESS_ENV  # noqa: F401  (one thread)
from test_torch_tensor_parallel import (FP32, GRID, OPT, RANK_PROGRAM,
                                        REF_OPT, REFERENCE_PROGRAM, STEPS,
                                        _copy, _env, _holds_one_process,
                                        _job, _one_process, _ranks,
                                        _reference_checkpoints)

from repro_torch.compat import FakeTensorMode
from repro_torch.config import get_config
from repro_torch.core.quant.policy import tree_items
from repro_torch.launch.train import data_for
from repro_torch.models import api
from repro_torch.models.lm import transformer as tfm
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import Segments
from repro_torch.training import train_loop
from repro_torch.training.checkpoint import CheckpointManager, leaf_items
from repro_torch.training.optimizer import (AdamWConfig, clip_by_global_norm,
                                            init_opt_state, schedule_lr)

MAMBA, HYMBA = "mamba2-130m-smoke", "hymba-1.5b-smoke"
DEEPSEEK, WHISPER = "deepseek-v3-671b-smoke", "whisper-tiny-smoke"
REF_ARCHS = (DEEPSEEK, MAMBA, HYMBA, WHISPER)
HYMBA_CUT = dict(n_layers=4, sliding_window=8)

# case: as test_torch_tensor_parallel.CASES (arch, model axis, world,
# quantizers, int8 gradient round trip, vocabulary override, batch rows,
# sequence, tolerance)
CASES = {
    "deepseek": (DEEPSEEK, 2, 2, None, False, 0, 4, 32, FP32),
    "mamba2": (MAMBA, 2, 2, None, False, 0, 4, 32, FP32),
    "mamba2-quant-int8": (MAMBA, 2, 2, "8x8", True, 0, 4, 32, GRID),
    "hymba": (HYMBA, 2, 2, None, False, 0, 4, 32, FP32),
    "whisper": (WHISPER, 2, 2, None, False, 0, 4, 32, FP32),
    "hymba-1x4": (HYMBA, 4, 4, None, False, 0, 4, 32, FP32),
    "deepseek-1x4": (DEEPSEEK, 4, 4, None, False, 0, 4, 32, FP32),
    "mamba2-2x2": (MAMBA, 2, 4, None, False, 0, 4, 32, FP32),
}
CUTS = {"hymba": HYMBA_CUT, "hymba-1x4": HYMBA_CUT}
# where a step-1 gradient is rounding noise (a deep stack's cancellations:
# hymba's 4 layers gave 3.5e-10 against 1.1e-9 in one process, of a leaf
# whose largest is 3.3e-3), AdamW's normalised step takes any value in
# (-1, 1) in either run: such a weight may part by 2 lr a step, summed
# over the steps (the warmup's lr: 2e-5, 4e-5, 6e-5)
NOISE_REACH = 2 * sum(float(schedule_lr(AdamWConfig(**OPT), torch.tensor(s)))
                      for s in range(1, STEPS + 1))

# two ranks take the global norm of one hand-built gradient tree of
# mamba2-130m-smoke, each holding its shards; rank 0 saves the norm
NORM_PROGRAM = r"""
import sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.config import get_config
from repro_torch.models import api
from repro_torch.models.lm import transformer as tfm
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.training.optimizer import clip_by_global_norm

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
cfg = get_config("mamba2-130m-smoke")
g = api.init_params(torch.Generator().manual_seed(7), cfg,
                    dtype=torch.float32)
dims = tp.split_dims(g, cfg, 2)
with tp.over_model(dist.group.WORLD):
    _, norm = clip_by_global_norm(tp.shard_tree(g, dims, rank, 2), 1e-3,
                                  dims)
if rank == 0:
    torch.save(norm, out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case trained by its ranks, the one-process checkpoint the
    ``ckpt-load`` job restores at a model axis of 2, the reference's
    GSPMD losses of :data:`REF_ARCHS` and the two ranks' norm; returns
    the results' directory and the reference's losses."""
    out = tmp_path_factory.mktemp("tpk")
    ref = _reference_checkpoints(out, REF_ARCHS)
    cfg = get_config(MAMBA)
    train_loop.run(cfg, AdamWConfig(**OPT), train_loop.TrainLoopConfig(
        steps=2, log_every=1, ckpt_every=2, ckpt_dir=str(out / "one")),
        data_for(cfg, 4, 32), device="cpu")
    jobs = {2: {}, 4: {}}
    for name, case in CASES.items():
        jobs[case[2]][name] = _job(name, out, CASES, cut=CUTS.get(name))
    jobs[2]["ckpt-load"] = _job("mamba2", out, CASES, grads=False, steps=2,
                                ckpt_dir=_copy(out / "one",
                                               out / "ckpt-load"))
    for arch in REF_ARCHS:
        jobs[2][f"ref-{arch}"] = dict(
            _job("mamba2", out, CASES), arch=arch, grads=False, opt=REF_OPT,
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
    procs += [subprocess.Popen(
        [sys.executable, "-c", NORM_PROGRAM, str(r), str(out / "store-norm"),
         str(out / "norm.pt")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, o + e
    return out, json.loads(outs[0][0].splitlines()[-1])


@pytest.mark.parametrize("name", list(CASES))
def test_every_block_kind_s_step_equals_one_process(runs, name, tmp_path):
    """3 steps' losses, step 1's gradients and the final carry (gathered
    whole) against the one-process run, every rank bit for bit equal
    (``tests/test_torch_tensor_parallel.py``'s contract)."""
    out, _ = runs
    _holds_one_process(_ranks(out, name, CASES),
                       _one_process(name, tmp_path, CASES, CUTS.get(name)),
                       CASES[name][-1], CASES[name][4], NOISE_REACH)


# the leaves where the unit rule and the dry run's flat-dim filter part:
# MLA's down-projections and the mtp head's projection stay whole, the
# SSM's per-head vectors split by heads where the specs keep them whole,
# and in_proj's and the conv's B and C stay whole inside their split
# leaves; at a model axis of 4 hymba's attention (2 KV heads) stays whole
HYMBA_GROUPS = [g for g, _, _ in tfm.group_names(
    dataclasses.replace(get_config(HYMBA), **HYMBA_CUT))]
_SSM_DIFFERS = ("ssm/in_proj/kernel", "ssm/conv_w", "ssm/conv_b",
                "ssm/A_log", "ssm/D", "ssm/dt_bias")
UNIT_RULE_DIFFERS = {
    "deepseek": {f"groups/g{i}/attn/{w}/kernel"
                 for i in ("0_mla_dense", "1_mla_moe")
                 for w in ("wdq", "wdkv")}
    | {"mtp/block/attn/wdq/kernel", "mtp/block/attn/wdkv/kernel",
       "mtp/proj/kernel"},
    "mamba2": {f"groups/g0_ssm/{k}" for k in _SSM_DIFFERS},
    "hymba": {f"groups/{g}/{k}" for g in HYMBA_GROUPS for k in _SSM_DIFFERS},
    "whisper": set(),
}
UNIT_RULE_DIFFERS["hymba-1x4"] = UNIT_RULE_DIFFERS["hymba"] | {
    f"groups/{g}/attn/{w}/kernel" for g in HYMBA_GROUPS
    for w in ("wq", "wk", "wv", "wo")}


@pytest.mark.parametrize("name", list(UNIT_RULE_DIFFERS))
def test_rank_bytes_are_the_per_device_bytes_where_the_rules_agree(runs,
                                                                   name):
    """Each rank's parameter bytes equal ``sharding.per_device_bytes``'s
    leaf by leaf wherever the unit rule and ``_filter_axes`` agree; the
    leaves where they part are named (:data:`UNIT_RULE_DIFFERS`). The
    encoder's attention and MLP split under the attention and MLP rules
    (whisper: nothing parts)."""
    out, _ = runs
    for r in _ranks(out, name, CASES):
        differ = {k for k, b in r["local_bytes"].items()
                  if b != r["spec_bytes"][k]}
        assert differ == UNIT_RULE_DIFFERS[name], differ
        if not differ:
            assert sum(r["local_bytes"].values()) == r["per_device_bytes"]
    if name == "whisper":
        whole = _whole(WHISPER)
        for k in ("encoder/blocks/attn/wq/kernel",
                  "encoder/blocks/ffn/wi/kernel",
                  "groups/g0_xdec/xattn/wk/kernel",
                  "groups/g0_xdec/xattn/wo/kernel"):
            assert 2 * r["local_bytes"][k] == whole[k].numel() * 4, k


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_model_axis_follows_the_reference_gspmd_run(runs, arch):
    """The reference's ``train_loop.run`` on two XLA host devices at
    ``(data=1, model=2)`` and the port's two gloo ranks at ``(1, 2)``,
    both resumed from one step-0 checkpoint of the reference's init, 3
    steps on their token streams: step 1 within 1e-5 relative, steps
    2-3 within 5e-3."""
    out, want = runs
    got = _ranks(out, f"ref-{arch}", CASES)[0]["loss"]
    assert len(got) == len(want[arch]) == STEPS
    np.testing.assert_allclose(got[:1], want[arch][:1], rtol=1e-5)
    np.testing.assert_allclose(got, want[arch], rtol=5e-3)


def _restore_whole(path):
    """(step, {key: leaf}) of the newest checkpoint in ``path``, restored
    in one process into mamba2-130m-smoke's whole carry."""
    cfg = get_config(MAMBA)
    like = api.init_params(torch.Generator().manual_seed(1), cfg,
                           dtype=torch.float32)
    step, carry = CheckpointManager(str(path)).restore(
        api.TrainCarry(like, init_opt_state(like, AdamWConfig(**OPT)), {}))
    return step, dict(leaf_items(carry))


PARTLY_SPLIT = ("in_proj/kernel", "conv_w", "conv_b")


def test_a_partly_split_leaf_round_trips_through_a_checkpoint(runs):
    """mamba2-130m-smoke at a model axis of 2: rank 0's step-3
    checkpoint of whole leaves restores in one process bit for bit, the
    segmented ``in_proj``, ``conv_w`` and ``conv_b`` (params, m and v)
    among them; and a one-process step-2 checkpoint restored by two
    ranks gives each rank its z, x and dt columns (its conv's x
    channels) and all of B's and C's, bit for bit, which gather back to
    the whole leaf."""
    out, _ = runs
    r0 = _ranks(out, "mamba2", CASES)[0]
    step, got = _restore_whole(out / "ckpt-mamba2")
    assert step == STEPS and set(got) == set(r0["carry"])
    for k, t in r0["carry"].items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    assert sum(k.endswith(PARTLY_SPLIT) for k in got) == 3 * 3

    step, want = _restore_whole(out / "one")
    assert step == 2
    cfg = get_config(MAMBA)
    d_in, N, nh = 128, cfg.ssm_state, 8
    seen = 0
    for r, res in enumerate(_ranks(out, "ckpt-load", CASES)):
        assert res["loss"] == []
        for k, w in want.items():
            assert torch.equal(res["carry"][k], w), k
            if not k.endswith(PARTLY_SPLIT):
                continue
            half = d_in // 2
            x = w[..., r * half:(r + 1) * half]
            if k.endswith("in_proj/kernel"):
                z = w[..., r * half:(r + 1) * half]
                x = w[..., d_in + r * half:d_in + (r + 1) * half]
                bc = w[..., 2 * d_in:2 * d_in + 2 * N]
                dt = w[..., 2 * d_in + 2 * N + r * nh // 2:][..., :nh // 2]
                part = torch.cat([z, x, bc, dt], dim=-1)
            else:
                part = torch.cat([x, w[..., d_in:]], dim=-1)
            assert torch.equal(res["local"][k], part), k
            seen += 1
    assert seen == 2 * 3 * 3


def test_the_norm_counts_a_replicated_segment_once(runs):
    """Two ranks' global norm of a hand-built gradient tree of
    mamba2-130m-smoke (each holding its shards, B's and C's segments on
    both) against the one-process norm of the whole tree, to 1e-6; the
    B/C segments counted on both ranks would part them."""
    out, _ = runs
    cfg = get_config(MAMBA)
    g = api.init_params(torch.Generator().manual_seed(7), cfg,
                        dtype=torch.float32)
    _, want = clip_by_global_norm(g, 1e-3)
    got = torch.load(out / "norm.pt")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    d_in, N = 128, cfg.ssm_state
    ssm = g["groups"]["g0_ssm"]["ssm"]
    bc = (ssm["in_proj"]["kernel"][..., 2 * d_in:2 * d_in + 2 * N]
          .square().sum() + ssm["conv_w"][..., d_in:].square().sum()
          + ssm["conv_b"][..., d_in:].square().sum())
    twice = float(want ** 2 + bc) ** 0.5
    assert abs(twice - float(want)) > 1e-4 * float(want)


def _cfg(arch, cut=None):
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **cut) if cut else cfg


def _whole(arch, cut=None):
    """{path: leaf} of ``arch``'s whole parameter tree, shapes only."""
    with FakeTensorMode():
        return dict(tree_items(api.init_params(
            torch.Generator().manual_seed(0), _cfg(arch, cut), device="cpu",
            dtype=torch.float32)))


def _dims(arch, model, cut=None):
    """{path: split} at a model axis of ``model``."""
    cfg = _cfg(arch, cut)
    with FakeTensorMode():
        params = api.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu", dtype=torch.float32)
    return dict(tree_items(tp.split_dims(params, cfg, model)))


def test_the_unit_rule_s_worked_cases_for_the_four_kinds():
    """MLA by query heads (deepseek-v3-671b-smoke at 4: ``wuq``,
    ``wukv`` columns and ``wo`` rows split by its 4 heads, though its
    ``n_kv_heads`` of 2 does not divide by 4; the down-projections,
    norms and ``mtp/proj`` whole); the SSM by heads in segments
    (mamba2-130m: at 2, z, x and dt by heads, B and C whole; at 16 its 24
    heads stay whole); the hybrid's branches each by its own counts
    (hymba-1.5b at 2: 25/5 attention heads whole, 50 SSM heads split,
    the odd vocabulary whole); the cross-attention by heads
    (whisper-tiny at 2: 6 heads, the encoder's attention and MLP too)."""
    ds = _dims(DEEPSEEK, 4)
    for g in ("groups/g0_mla_dense/attn/", "groups/g1_mla_moe/attn/",
              "mtp/block/attn/"):
        assert ds[g + "wuq/kernel"] == ds[g + "wukv/kernel"] == \
            ds[g + "wo/kernel"] + 1, g
        for w in ("wdq/kernel", "wdkv/kernel", "q_norm/scale",
                  "kv_norm/scale"):
            assert ds[g + w] is None, g + w
    assert ds["mtp/proj/kernel"] is None
    assert ds["groups/g1_mla_moe/ffn/wi"] is not None   # 4 experts

    full = _dims("deepseek-v3-671b", 16)
    assert full["groups/g0_mla_dense/attn/wo/kernel"] == 1

    m2 = _dims("mamba2-130m", 2)
    g = "groups/g0_ssm/ssm/"
    assert m2[g + "in_proj/kernel"] == Segments(
        2, ((1536, True), (1536, True), (256, False), (24, True)))
    assert m2[g + "conv_w"] == Segments(2, ((1536, True), (256, False)))
    assert m2[g + "conv_b"] == Segments(1, ((1536, True), (256, False)))
    assert m2[g + "A_log"] == m2[g + "D"] == m2[g + "dt_bias"] == 1
    assert m2[g + "out_proj/kernel"] == 1
    assert all(d is None for k, d in _dims("mamba2-130m", 16).items()
               if "/ssm/" in k)

    hy = _dims("hymba-1.5b", 2)
    for g in ("groups/g0_hybrid_full/", "groups/g1_hybrid_swa/"):
        assert all(hy[g + f"attn/{w}/kernel"] is None
                   for w in ("wq", "wk", "wv", "wo")), g
        assert isinstance(hy[g + "ssm/in_proj/kernel"], Segments)
        assert hy[g + "ffn/wi/kernel"] == 2
    assert hy["embed"] is None

    wh = _dims("whisper-tiny", 2)
    for k in ("groups/g0_xdec/xattn/wq/kernel",
              "groups/g0_xdec/xattn/wk/kernel",
              "encoder/blocks/attn/wq/kernel",
              "encoder/blocks/ffn/wi/kernel"):
        assert wh[k] == 2, k
    assert wh["groups/g0_xdec/xattn/wo/kernel"] == 1
    assert wh["embed"] is None

    mixed = _dims(HYMBA, 4, HYMBA_CUT)
    assert mixed["groups/g1_hybrid_swa/attn/wq/kernel"] is None
    assert isinstance(mixed["groups/g1_hybrid_swa/ssm/in_proj/kernel"],
                      Segments)


@pytest.mark.parametrize("split", [
    1, Segments(1, ((4, True), (4, True), (4, False), (2, True)))])
def test_shard_and_whole_invert_each_other(split, monkeypatch):
    """``shard`` of a whole leaf on each of two ranks and ``whole`` of
    the parts give back the leaf bit for bit, a signed zero in a
    replicated segment too (written by rank 0 alone; rank 1's buffer
    holds -0.0 there)."""
    import torch.distributed as dist
    w = torch.randn(3, 14)
    w[0, 9] = -0.0
    parts = [tp.shard(w, split, r, 2) for r in range(2)]
    if isinstance(split, Segments):
        assert parts[0].shape == (3, 2 + 2 + 4 + 1)
        assert torch.equal(parts[0][:, 4:8], w[:, 8:12])
    # each rank's buffer, summed here as the group's all-reduce would
    bufs, rank = [], [0]
    monkeypatch.setattr(dist, "get_world_size", lambda g: 2)
    monkeypatch.setattr(dist, "get_rank", lambda g: rank[0])
    monkeypatch.setattr(dist, "get_backend", lambda g: "gloo")
    monkeypatch.setattr(tp, "all_reduce_", lambda t, op="sum", group=None:
                        bufs.append(t.clone()) or t)
    for r in range(2):
        rank[0] = r
        tp.whole(parts[r], split, object())
    got = bufs[0] + bufs[1]
    assert torch.equal(got, w)
    assert torch.equal(torch.signbit(got), torch.signbit(w))


def test_step_all_reduce_bytes_match_the_dry_run_s_accounting(runs):
    """One step's model-group all-reduce bytes at ``(1, 2)`` (remat off)
    against the dry run's all-reduce count of the same cell, beside the
    cross-entropy's three fp32 values a token. mamba2-130m-smoke: each
    SSM layer also sums B's and C's gradient (tokens x 2N fp32), which
    the dry run does not count. hymba (4 layers): each layer's mean is
    one forward reduce where the dry run counts two (``wo`` and
    ``out_proj``), and its backward sums the attention's input, the
    SSM's input and B/C's gradient."""
    out, _ = runs
    tokens, ce = 4 * 32, 3 * 4 * 32 * 4
    cfg = get_config(MAMBA)
    r = _ranks(out, "mamba2", CASES)[0]
    bc = cfg.n_layers * tokens * 2 * cfg.ssm_state * 4
    assert r["step_allreduce"]["bytes"] == r["dryrun"]["all-reduce"] + ce + bc
    # the embedding, each layer's out_proj forward and its two input
    # sums backward, the unembedding's input backward, the cross-entropy's
    assert r["step_allreduce"]["calls"] == 1 + 3 * cfg.n_layers + 1 + 3
    h = _ranks(out, "hymba", CASES)[0]
    hcfg = _cfg(HYMBA, HYMBA_CUT)
    hb = hcfg.n_layers * tokens * (2 * hcfg.ssm_state - hcfg.d_model) * 4
    assert h["step_allreduce"]["bytes"] == h["dryrun"]["all-reduce"] + ce + hb


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "hymba-1.5b",
                                  "whisper-tiny"])
def test_launcher_trains_every_kind_with_a_model_axis(arch, tmp_path):
    """``--smoke --model-parallel 2`` over 2 processes trains the MLA,
    hybrid and encoder-decoder archs (the SSM's:
    ``tests/test_torch_distributed.py``): both print the same finite
    losses."""
    from test_torch_distributed import _launch
    outs = _launch(tmp_path, "--model-parallel", "2", "--seq", "32",
                   arch=arch)
    for rc, out, err in outs:
        assert rc == 0, out + err
    rows = [[json.loads(line) for line in out.splitlines()]
            for _, out, _ in outs]
    assert [r["step"] for r in rows[0]] == [2]
    assert np.isfinite(rows[0][0]["loss"])
    assert [r["loss"] for r in rows[0]] == [r["loss"] for r in rows[1]]
