"""The port's dry run and its scale-out substrate against the JAX package's.

``config`` shapes, ``launch/mesh.py``, ``parallel/sharding.py``,
``training/elastic.py``, ``api.batch_struct`` and ``launch/dryrun.py``.
Specs are compared entry for entry with the reference's
``PartitionSpec``s on the full configs, from shapes alone (the port's
trees under ``FakeTensorMode``, the reference's under
``jax.eval_shape``). A production mesh stands on a ``fake`` process
group of 256 or 512 ranks, torn down after each test that makes one.
The attention knobs and schedule are held against the reference's
``blockwise_attn``, the full grid's count against the triangle's by the
reference's block pairs, and the MoE all-to-all against arithmetic over
the reference's specs; ``analysis/report.py`` renders a CLI record.
"""
import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import SUBPROCESS_ENV
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import config as jconfig
from repro.analysis.roofline import roofline_terms as jroofline_terms
from repro.models import api as japi
from repro.models.lm import transformer as jtfm
from repro.parallel import sharding as jshd
from repro.training import elastic as jelastic
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import init_opt_state as jinit_opt_state
from repro_torch import config
from repro_torch.analysis import hlo
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import api
from repro_torch.models.basecaller import ctc
from repro_torch.models.lm import moe, transformer as tfm
from repro_torch.parallel import sharding as shd
from repro_torch.training import elastic
from repro_torch.training.optimizer import AdamWConfig, init_opt_state

ROOT = Path(__file__).resolve().parents[1]
SPEC_ARCHS = ["llama3-405b", "granite-moe-1b-a400m", "deepseek-v3-671b",
              "hymba-1.5b", "whisper-tiny", "internvl2-1b", "rubicall"]
# every key of the reference's record (repro/launch/dryrun.py)
REFERENCE_KEYS = (
    "cell", "arch", "shape", "variant", "args_memory_s", "n_chips",
    "params_total", "params_active", "tokens_per_step", "memory_analysis",
    "bytes_per_device", "xla_flops_1iter", "hlo", "roofline",
    "model_flops_global", "model_flops_per_chip", "useful_flops_ratio",
    "lower_s", "compile_s")
MEM_KEYS = ("generated_code_size_in_bytes", "argument_size_in_bytes",
            "output_size_in_bytes", "alias_size_in_bytes",
            "temp_size_in_bytes")


@pytest.fixture
def world():
    """Tears down whatever process group a test made, and gives back
    the attention knobs and schedule that a cell's ``build_cell`` set."""
    with dryrun.restored_knobs():
        yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _jpaths(tree):
    """{path: leaf} of a JAX tree (PartitionSpecs as leaves)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): leaf for p, leaf in flat}


def _tpaths(tree):
    out = {}
    shd._map_with_path(lambda p, leaf: out.__setitem__(p, leaf), tree)
    return out


def _port_params(cfg):
    with FakeTensorMode():
        return dryrun._params(cfg, "")


# ---------------------------------------------------------------------------
# config


def test_shapes_archs_and_applicability_match_the_reference():
    assert config.ASSIGNED_ARCHS == jconfig.ASSIGNED_ARCHS
    assert config.PAPER_ARCHS == jconfig.PAPER_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in config.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}
    assert set(config.all_configs()) == set(jconfig.all_configs())
    for arch in config.ASSIGNED_ARCHS + config.PAPER_ARCHS:
        cfg, jcfg = config.get_config(arch), jconfig.get_config(arch)
        assert cfg.supports_long_context == jcfg.supports_long_context
        for name in config.SHAPES:
            assert config.shape_applicable(cfg, config.SHAPES[name]) == \
                jconfig.shape_applicable(jcfg, jconfig.SHAPES[name]), \
                (arch, name)
            assert config.SHAPES[name].is_decode == \
                jconfig.SHAPES[name].is_decode


# ---------------------------------------------------------------------------
# sharding: specs entry for entry


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_param_cache_and_opt_specs_match_the_reference(arch):
    cfg, jcfg = config.get_config(arch), jconfig.get_config(arch)
    jstruct = jax.eval_shape(lambda: japi.init_params(jax.random.key(0),
                                                      jcfg))
    want = _jpaths(jshd.param_specs(jstruct, jcfg))
    params = _port_params(cfg)
    got = _tpaths(shd.param_specs(params, cfg))
    assert set(got) == set(want)
    for path, spec in want.items():
        assert tuple(got[path]) == tuple(spec), path
    # the trees' leaves themselves: shapes and dtypes
    jleaves, tleaves = _jpaths(jstruct), _tpaths(params)
    for path, leaf in jleaves.items():
        assert tuple(tleaves[path].shape) == leaf.shape, path
        assert str(tleaves[path].dtype)[6:] == str(leaf.dtype), path
    if cfg.family == "basecaller":
        return
    jc = _jpaths(jshd.cache_spec_tree(jcfg))
    tc = _tpaths(shd.cache_spec_tree(cfg))
    assert {p: tuple(s) for p, s in tc.items()} == \
        {p: tuple(s) for p, s in jc.items()}
    # the spec tree is shaped as the caches the step builds
    with FakeTensorMode():
        caches = tfm.init_caches(cfg, 2, 16, device="cpu")
    assert set(_tpaths(caches)) == set(tc)
    if arch == "granite-moe-1b-a400m":
        for bits in (0, 8):
            jopt = jax.eval_shape(lambda: jinit_opt_state(
                jstruct, JAdamWConfig(state_bits=bits)))
            with FakeTensorMode():
                opt = init_opt_state(params, AdamWConfig(state_bits=bits))
            js = jshd.opt_state_specs(jopt, jstruct, jcfg)
            ts = shd.opt_state_specs(opt, params, cfg)
            assert tuple(ts.step) == tuple(js.step)
            for field in ("m", "v", "m_scale", "v_scale"):
                jf, tf = getattr(js, field), getattr(ts, field)
                if jf is None:
                    assert tf is None
                    continue
                assert {p: tuple(s) for p, s in _tpaths(tf).items()} == \
                    {p: tuple(s) for p, s in _jpaths(jf).items()}, field


def _jmesh(shape, names):
    """A stand-in for the reference's Mesh: its ``_filter_axes`` reads
    the axis names and the device grid's shape only."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def test_filter_axes_matches_the_reference_on_vocab_51865(world):
    """whisper-tiny's vocab (51865, odd) cannot shard: the axes that do
    not divide a dim drop, the largest dividing prefix of a dim's axes
    stays."""
    for multi, (shape, names) in ((False, ((16, 16), ("data", "model"))),
                                  (True, ((2, 16, 16),
                                          ("pod", "data", "model")))):
        mesh = tmesh.make_production_mesh(multi_pod=multi)
        assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
        assert tmesh.mesh_devices(mesh) == int(np.prod(shape))
        jm = _jmesh(shape, names)
        for spec, dims in ((("model", "data"), (51865, 384)),
                           (("data", "model"), (384, 51865)),
                           ((("pod", "data"), None), (48, 7)),
                           ((("pod", "data"), "model"), (51865, 32)),
                           ((("pod", "data"), "model"), (64, 1))):
            want = jshd._filter_axes(P(*spec), jm, dims)
            got = shd._filter_axes(shd.Spec(*spec), mesh, dims)
            assert tuple(got) == tuple(want), (spec, dims)
            assert tuple(shd._filter_axes(shd.Spec(*spec), mesh)) == \
                tuple(jshd._filter_axes(P(*spec), jm))


def test_shardings_place_each_leaf_as_the_spec_says(world):
    """Placements per mesh axis and one device's shard: a (16384, 53248)
    leaf over (pod, data) x model on the multi-pod mesh; the
    DTensor's own local shard under FakeTensorMode agrees."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = tmesh.make_production_mesh(multi_pod=True)
    sh = shd.to_shardings(shd.Spec(("pod", "data"), "model"), mesh)
    assert sh.placements == (Shard(0), Shard(0), Shard(1))
    assert sh.local_shape((16384, 53248)) == (512, 3328)
    with FakeTensorMode():
        x = torch.empty(16384, 53248, dtype=torch.bfloat16)
        d = distribute_tensor(x, mesh, list(sh.placements))
        assert tuple(d.to_local().shape) == (512, 3328)
    rep = shd.to_shardings(shd.Spec(None, "data"), mesh)
    assert rep.placements == (Replicate(), Shard(1), Replicate())
    # param_shardings filters each leaf against its shape
    cfg = config.get_config("whisper-tiny")
    psh = shd.param_shardings(_port_params(cfg), cfg, mesh)
    assert tuple(psh["embed"].spec) == (None, "data")
    assert psh["embed"].placements == (Replicate(), Shard(1), Replicate())


# ---------------------------------------------------------------------------
# batch shapes


@pytest.mark.parametrize("shape_name", list(config.SHAPES))
def test_batch_struct_and_specs_match_the_reference(shape_name):
    for arch in config.ASSIGNED_ARCHS + config.PAPER_ARCHS:
        cfg, jcfg = config.get_config(arch), jconfig.get_config(arch)
        shape, jshape = config.SHAPES[shape_name], jconfig.SHAPES[shape_name]
        want = japi.batch_struct(jcfg, jshape)
        got = api.batch_struct(cfg, shape)
        assert set(got) == set(want), arch
        for k, leaf in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == leaf.shape, (arch, k)
            assert str(got[k].dtype)[6:] == str(leaf.dtype), (arch, k)
        for axes in (("data", "model"), ("pod", "data", "model")):
            ws = japi.batch_specs(jcfg, jshape, axes)
            gs = api.batch_specs(cfg, shape, axes)
            assert {k: tuple(v) for k, v in gs.items()} == \
                {k: tuple(v) for k, v in ws.items()}, (arch, axes)


# ---------------------------------------------------------------------------
# per-device argument bytes


def _ref_bytes(struct, spec_tree, jm) -> int:
    """One device's bytes of ``struct`` under the reference's specs,
    filtered as its dry run filters them, summed with numpy."""
    leaves = jax.tree.leaves(struct)
    specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(specs)
    sizes = dict(zip(jm.axis_names, jm.devices.shape))
    total = 0
    for leaf, spec in zip(leaves, specs):
        spec = jshd._filter_axes(spec, jm, leaf.shape)
        local = np.array(leaf.shape, np.int64)
        for i, e in enumerate(spec):
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                local[i] = -(-local[i] // sizes[a])
        total += int(np.prod(local)) * np.dtype(leaf.dtype).itemsize
    return total


def _ref_cell_bytes(arch, shape_name, multi_pod):
    """The reference dry run's argument structs and shardings for a cell,
    as its ``build_cell`` makes them."""
    jcfg, jshape = jconfig.get_config(arch), jconfig.SHAPES[shape_name]
    shape = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    jm = _jmesh(*shape)
    ps = jax.eval_shape(lambda: japi.init_params(jax.random.key(0), jcfg))
    total = _ref_bytes(ps, jshd.param_specs(ps, jcfg), jm)
    bstruct = japi.batch_struct(jcfg, jshape)
    if jshape.kind == "train":
        opt = jax.eval_shape(lambda: jinit_opt_state(ps, JAdamWConfig()))
        total += _ref_bytes(opt, jshd.opt_state_specs(opt, ps, jcfg), jm)
        total += _ref_bytes(bstruct, japi.batch_specs(jcfg, jshape,
                                                      shape[1]), jm)
    elif jshape.kind == "prefill":
        total += _ref_bytes(bstruct, japi.batch_specs(jcfg, jshape,
                                                      shape[1]), jm)
    else:
        cs = jax.eval_shape(lambda: jtfm.init_caches(
            jcfg, jshape.global_batch, jshape.seq_len))
        total += _ref_bytes(cs, jshd.cache_spec_tree(jcfg), jm)
        total += _ref_bytes(
            jax.ShapeDtypeStruct((jshape.global_batch, 1), jnp.int32),
            P(("pod", "data"), None), jm) + 4
    return total


@pytest.mark.parametrize("arch,shape_name,multi_pod", [
    ("qwen1.5-4b", "decode_32k", False),
    ("granite-moe-1b-a400m", "train_4k", False),
    ("deepseek-v3-671b", "prefill_32k", True),
    ("hymba-1.5b", "long_500k", True)])
def test_cell_argument_bytes_equal_the_reference_specs_sum(
        arch, shape_name, multi_pod, world):
    cfg, shape = config.get_config(arch), config.SHAPES[shape_name]
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    with FakeTensorMode():
        cell = dryrun.build_cell(cfg, shape, mesh)
        got = sum(shd.per_device_bytes(a, s)
                  for a, s in zip(cell["args"], cell["arg_shardings"]))
    assert got == _ref_cell_bytes(arch, shape_name, multi_pod)


# ---------------------------------------------------------------------------
# elastic


def test_best_mesh_shape_preserves_tp():
    for fn in (elastic.best_mesh_shape, jelastic.best_mesh_shape):
        assert fn(256, 16) == (16, 16)
        assert fn(255, 16) == (15, 16)
        with pytest.raises(ValueError):
            fn(8, 16)


def test_rebuild_and_reshard_single_device(world, tmp_path):
    """One-rank gloo group (a file store: no socket): the rebuilt mesh
    and a tree moved onto it, bit for bit."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    mesh = elastic.rebuild_mesh([0], model_parallel=1)
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    host = tmesh.make_host_mesh(1)
    assert tuple(host.shape) == (1, 1)
    tree = {"w": np.arange(16, dtype=np.float32).reshape(4, 4),
            "b": torch.ones(3, dtype=torch.bfloat16)}
    specs = {"w": shd.Spec("data", "model"), "b": shd.Spec(None)}
    out = elastic.reshard(tree, shd.to_shardings(specs, mesh, tree))
    assert out["w"].shape == (4, 4)
    np.testing.assert_array_equal(out["w"].to_local().numpy(), tree["w"])
    assert torch.equal(out["b"].to_local(), tree["b"])


def test_watchdog_flags_stragglers():
    for cls in (elastic.Watchdog, jelastic.Watchdog):
        wd = cls(n_hosts=4, patience=2)
        for s in range(5):
            wd.advance(s)
            for h in (0, 1, 2):
                wd.beat(h, s)
            if s <= 1:
                wd.beat(3, s)
        assert wd.suspects() == [3]


# ---------------------------------------------------------------------------
# the counter


def test_counter_counts_matmul_flops_and_operand_bytes():
    """A matmul: 2 M N K flops, operands + result bytes; a view moves
    nothing; an indexed read counts the rows it reads."""
    with FakeTensorMode():
        a, b = torch.empty(8, 16), torch.empty(16, 32)
        emb, idx = torch.empty(1000, 64), torch.zeros(5, dtype=torch.long)

        def f(a, b, emb, idx):
            return (a @ b).reshape(256), emb[idx]
        _, table = hlo.count_ops(f, a, b, emb, idx)
    assert table["mm"] == {"calls": 1, "flops": 2 * 8 * 16 * 32,
                           "bytes": 4 * (8 * 16 + 16 * 32 + 8 * 32)}
    assert "view" not in table and "_unsafe_view" not in table
    assert table["index"]["bytes"] == 2 * 5 * 64 * 4 + 5 * 8
    assert hlo.totals(table)["flops"] == 2 * 8 * 16 * 32


def test_collectives_follow_the_fsdp_pattern():
    """A (4, 64, 32) stacked wo over data x model (data 2, model 4):
    gathers per forward and backward pass, a reduce-scatter per
    microbatch, an all-reduce of each layer's output per pass; a
    replicated norm's gradient all-reduced once."""
    sizes = {"data": 2, "model": 4}
    leaves = [("groups/g0/attn/wo/kernel", (4, 64, 32), 2,
               shd.Spec(None, "model", "data")),
              ("groups/g0/ln1/scale", (4, 32), 2, shd.Spec(None, None))]
    c = hlo.collective_bytes(leaves, sizes, n_micro=3, train=True,
                             tokens=10, frames=1, act_bytes=2)
    gathered = 4 * 64 * 32 * 2 / 4
    assert c["all-gather"] == 6 * gathered
    assert c["reduce-scatter"] == 3 * gathered
    assert c["all-reduce"] == 4 * 32 * 2 + 6 * 4 * 10 * 32 * 2
    c = hlo.collective_bytes(leaves, {"data": 1, "model": 1}, n_micro=1,
                             train=True, tokens=10, frames=1, act_bytes=2)
    assert sum(c.values()) == 0


def test_layer_cuts_give_the_direct_count():
    """The count solved from shallow cuts equals the count of the whole
    stack, op for op: two MLA kinds (deepseek-smoke at 5 layers, 2 dense)
    and two hybrid kinds (hymba-smoke at 6)."""
    shape = config.SHAPES["decode_32k"]
    for cfg in (dataclasses.replace(
            config.get_config("deepseek-v3-671b-smoke"), n_layers=5,
            n_dense_layers=2),
            dataclasses.replace(config.get_config("hymba-1.5b-smoke"),
                                n_layers=6)):
        table, cuts = dryrun.count_step(cfg, shape)
        assert sum(L for L, _ in cuts) < cfg.n_layers + 2
        with FakeTensorMode():
            want = dryrun._count(cfg, shape, "", 1)
        assert table == want


def test_fake_tensors_take_the_static_moe_and_ctc_forms():
    """On real tensors the capacity-padded MoE form (the dry run's)
    equals the gathered one within fp32 rounding."""
    cfg = config.get_config("granite-moe-1b-a400m-smoke")
    gen = torch.Generator().manual_seed(0)
    p = moe.make_moe_params(gen, cfg)
    x = torch.randn(2, 12, cfg.d_model, generator=gen)
    gates = torch.softmax(torch.randn(2, 12, cfg.n_experts, generator=gen),
                          -1)
    dispatch, combine, _ = moe._top_k_dispatch(gates, cfg.experts_per_tok, 4)
    torch.testing.assert_close(moe._routed_dense(p, x, dispatch, combine),
                               moe._routed(p, x, dispatch, combine,
                                           k=cfg.experts_per_tok),
                               rtol=1e-5, atol=1e-5)
    # F.ctc_loss's shapes depend on the lengths' values: a fake batch
    # takes the plain twin, whose value on real tensors is the same
    lp = torch.randn(2, 30, 5, generator=gen).log_softmax(-1)
    lab = torch.randint(1, 5, (2, 4), generator=gen)
    lens = torch.tensor([4, 3])
    torch.testing.assert_close(ctc.ctc_loss(lp, lab, lens),
                               ctc.ctc_loss_ref(lp, lab, lens),
                               rtol=1e-5, atol=1e-5)
    with FakeTensorMode() as mode:
        out = ctc.ctc_loss(*(mode.from_tensor(t) for t in (lp, lab, lens)))
        assert out.shape == ()


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def cli_results(tmp_path_factory):
    """One dry-run cell written by the CLI: (its directory, its stdout)."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, **SUBPROCESS_ENV, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-4b-smoke", "--shape", "decode_32k", "--save-hlo",
         "--results", str(out)], env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return out, r.stdout


def test_dryrun_cli_writes_a_record_with_every_reference_key(cli_results):
    tmp_path, stdout = cli_results
    assert "[ok]   qwen1.5-4b-smoke__decode_32k__pod1" in stdout
    rec = json.loads((tmp_path /
                      "qwen1.5-4b-smoke__decode_32k__pod1.json").read_text())
    assert set(REFERENCE_KEYS) <= set(rec)
    assert set(rec["memory_analysis"]) == set(MEM_KEYS)
    for key in ("generated_code_size_in_bytes", "temp_size_in_bytes"):
        assert rec["memory_analysis"][key] is None
    assert rec["compile_s"] is None and rec["xla_flops_1iter"] is None
    assert rec["n_chips"] == 256 and rec["cuda_initialized"] is False
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        _ref_cell_bytes("qwen1.5-4b-smoke", "decode_32k", False)
    assert rec["hlo"]["flops"] > 0 and rec["roofline"]["bottleneck"]
    assert set(rec["roofline"]) == set(jroofline_terms(
        {"flops": 1.0, "hbm_bytes": 1.0, "collective_bytes": 1.0}))
    ops = json.loads((tmp_path / "qwen1.5-4b-smoke__decode_32k__pod1"
                      ".ops.json").read_text())
    assert ops["mm"]["flops"] > 0


def test_cells_and_variants_are_the_reference_s():
    """Read from the reference's source: importing its dry run would set
    its host-device count for the whole process."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    variants = next(n.value for n in ast.walk(ast.parse(src))
                    if isinstance(n, ast.Assign)
                    and getattr(n.targets[0], "id", "") == "VARIANTS")
    assert dryrun.VARIANTS == ast.literal_eval(variants)
    assert list(dryrun.all_cells()) == [
        (a, s) for a in jconfig.ASSIGNED_ARCHS for s in jconfig.SHAPES] + [
        ("rubicall", "train_4k"), ("bonito", "train_4k")]
    # every variant counts: ``tri`` (once refused) walks the triangle
    assert not getattr(dryrun, "_NOT_PORTED", ())
    shape = config.ShapeConfig("prefill_2k", 2048, 1, "prefill")
    calls = {}
    with dryrun.restored_knobs():
        for variant in ("", "tri"):
            dryrun._set_knobs(variant)
            table, _ = dryrun.count_step(
                config.get_config("qwen1.5-4b-smoke"), shape,
                variant=variant)
            calls[variant] = table["bmm"]["calls"]
    # 4 query chunks of 512 x 2 KV chunks of 1024: 8 pairs, 6 in the
    # triangle; two matmuls a pair, two layers
    assert calls == {"": 8 * 2 * 2, "tri": 6 * 2 * 2}


# ---------------------------------------------------------------------------
# attention knobs and the causal schedule (the reference's blockwise_attn)

_ENV_KNOBS = ("REPRO_ATTN_BF16", "REPRO_ATTN_QCHUNK", "REPRO_ATTN_TRI")


@pytest.mark.parametrize("env,reference_schedule,kw,tol", [
    ({"REPRO_ATTN_BF16": "1"}, False, dict(q_chunk=16, kv_chunk=32), 2e-2),
    ({"REPRO_ATTN_BF16": "1"}, True, dict(q_chunk=16, kv_chunk=32), 2e-2),
    ({"REPRO_ATTN_BF16": "1"}, False, dict(q_chunk=16, window=24), 2e-2),
    ({"REPRO_ATTN_QCHUNK": "1024"}, False, {}, 1e-5),
    ({}, True, dict(q_chunk=16, kv_chunk=32), 1e-5),
    ({"REPRO_ATTN_TRI": "1"}, True, dict(q_chunk=16, kv_chunk=32), 1e-5),
    ({}, True, dict(q_chunk=16, kv_chunk=32, causal=False), 1e-5),
], ids=["bf16", "bf16-grid", "bf16-window", "qchunk1024", "grid", "tri",
        "grid-noncausal"])
def test_blockwise_attn_knobs_match_the_reference(
        env, reference_schedule, kw, tol, monkeypatch):
    """The port's ``blockwise_attn`` under the reference's knobs, read at
    call time, and under the dry run's schedule, against the reference's
    under the same settings; the full grid and the triangle give the
    eager default's outputs bit for bit (past the diagonal p is 0)."""
    from repro.models.lm import attention as jattn
    from repro_torch.models.lm import attention as attn
    for var in _ENV_KNOBS:
        monkeypatch.delenv(var, raising=False)
    S = 2048 if "REPRO_ATTN_QCHUNK" in env else 64
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(1, S, h, 16).astype(np.float32) for h in (4, 2, 2))
    default = attn.blockwise_attn(*map(torch.from_numpy, (q, k, v)), **kw)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(attn, "REFERENCE_SCHEDULE", reference_schedule)
    want = np.asarray(jattn.blockwise_attn(*map(jnp.asarray, (q, k, v)),
                                           **kw))
    got = attn.blockwise_attn(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    if "REPRO_ATTN_BF16" not in env:
        assert torch.equal(got, default)


def test_reference_schedule_refuses_an_input_on_the_card(monkeypatch):
    """The dry run's schedule is for its fake CPU tensors: on the CPU a
    whole prompt runs; set with an input on the card (fake CUDA tensors
    here) it raises, in ``blockwise_attn`` and in the whole prompt's
    attention, where it would take the prompt past
    ``ops.flash_attention``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.lm import attention as attn
    monkeypatch.setattr(attn, "REFERENCE_SCHEDULE", True)
    cfg = config.get_config("qwen1.5-4b-smoke")
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    with FakeTensorMode():
        p = attn.make_attn_params(torch.Generator().manual_seed(0), cfg)
        x = torch.zeros(1, 8, cfg.d_model)
        pos = torch.arange(8)[None]
        assert attn.attn_forward(p, x, pos, cfg)[0].shape == x.shape
        q = torch.zeros(1, 8, H, hd, device="cuda")
        with pytest.raises(RuntimeError, match="REFERENCE_SCHEDULE"):
            attn.blockwise_attn(q, q, q, causal=True)
        monkeypatch.setattr(attn, "_project_qkv", lambda *a: (q, q, q))
        with pytest.raises(RuntimeError, match="REFERENCE_SCHEDULE"):
            attn.attn_forward(p, x, pos, cfg)


@pytest.fixture(scope="module")
def prefill_counts():
    """qwen1.5-4b-smoke's prefill of one 4096-token row, counted under
    each attention variant: {variant: the ``bmm`` row of its table}."""
    shape = config.ShapeConfig("prefill_4k", 4096, 1, "prefill")
    out = {}
    with dryrun.restored_knobs():
        for variant in ("", "tri", "qc1024", "bf16attn"):
            dryrun._set_knobs(variant)
            table, _ = dryrun.count_step(
                config.get_config("qwen1.5-4b-smoke"), shape,
                variant=variant)
            out[variant] = table["bmm"]
    return out


def test_grid_to_triangle_flops_are_the_reference_s(prefill_counts):
    """Queue 3's gate: the ``""`` count of attention matmul flops is to
    the ``tri`` count as the reference's full grid is to its triangle,
    the block-pair lists of its ``blockwise_attn`` (the full scan of
    ``Tq x Tk`` chunk pairs, and ``_blockwise_tri``'s ``pairs``)."""
    from repro.models.lm import attention as jattn
    S, q_offset = 4096, 0
    Qc, Kc = jattn._chunk(S, 512), jattn._chunk(S, 1024)
    Tq, Tk = S // Qc, S // Kc
    grid = [(i, j) for i in range(Tq) for j in range(Tk)]
    tri = [(i, j) for i in range(Tq) for j in range(Tk)
           if j * Kc <= q_offset + i * Qc + Qc - 1]
    assert (len(grid), len(tri)) == (32, 20)
    full, half = prefill_counts[""], prefill_counts["tri"]
    assert full["flops"] * len(tri) == half["flops"] * len(grid)
    assert full["calls"] * len(tri) == half["calls"] * len(grid)


def test_bf16attn_and_qc1024_change_what_the_reference_s_change(
        prefill_counts):
    """bf16 scores: the same matmul flops over fewer bytes; 1024-query
    chunks: the same flops in half the chunk pairs."""
    base = prefill_counts[""]
    bf16, qc = prefill_counts["bf16attn"], prefill_counts["qc1024"]
    assert bf16["flops"] == base["flops"] == qc["flops"]
    assert bf16["bytes"] < 0.6 * base["bytes"]
    assert 2 * qc["calls"] == base["calls"]


@pytest.mark.parametrize("variant", ["bf16attn", "qc1024", "tri"])
def test_every_attention_variant_gives_a_record(variant, tmp_path, world):
    """The variants that once raised write their records, and the
    caller's knobs come back afterwards."""
    rec = dryrun.run_cell("qwen1.5-4b-smoke", "decode_32k", False,
                          variant=variant, results=tmp_path)
    assert rec["variant"] == variant
    assert rec["cell"] == f"qwen1.5-4b-smoke__decode_32k__pod1__{variant}"
    assert rec["hlo"]["flops"] > 0
    assert (tmp_path / f"{rec['cell']}.json").exists()
    assert all(os.environ.get(v) is None for v in _ENV_KNOBS)
    from repro_torch.models.lm import attention as attn
    assert attn.REFERENCE_SCHEDULE is False


# ---------------------------------------------------------------------------
# the MoE all-to-all and the report


def test_moe_all_to_all_of_granite_train_4k_is_the_specs_arithmetic(world):
    """granite-moe-1b-a400m x train_4k on 16 x 16: the dispatch and the
    combine each move the device's share of the (E, G, capacity, d)
    dispatch tensor, per MoE layer and pass; the combine adds no
    all-reduce of its own. The arithmetic reads the reference's specs
    and config."""
    cfg, shape = config.get_config("granite-moe-1b-a400m"), \
        config.SHAPES["train_4k"]
    mesh = tmesh.make_production_mesh()
    with FakeTensorMode():
        cell = dryrun.build_cell(cfg, shape, mesh)
        leaves = dryrun._param_leaves(cell["args"][0].params,
                                      cell["arg_shardings"][0].params)
    sizes = shd.axis_sizes(mesh)
    coll = dryrun.cell_collectives(cfg, shape, sizes, leaves,
                                   cell["n_micro"])

    jcfg = jconfig.get_config("granite-moe-1b-a400m")
    jstruct = jax.eval_shape(lambda: japi.init_params(jax.random.key(0),
                                                      jcfg))
    specs, leaves_j = _jpaths(jshd.param_specs(jstruct, jcfg)), \
        _jpaths(jstruct)
    wo = [p for p in specs if p.endswith("ffn/wo")]
    assert len(wo) == 1 and tuple(specs[wo[0]]) == (None, "model", None,
                                                    "data")
    L, E, _, d = leaves_j[wo[0]].shape
    dp, mp = 16, 16
    n_micro = japi.n_microbatches(jcfg, shape.global_batch, shape.seq_len,
                                  dp=dp)
    assert n_micro == cell["n_micro"]
    groups = shape.global_batch // n_micro // dp        # rows a shard
    cap = max(math.ceil(shape.seq_len * jcfg.experts_per_tok / E * 1.25), 4)
    passes = 2 * n_micro                                # forward, backward
    want = passes * L * 2 * (E // mp) * groups * cap * d * 2   # bf16
    assert coll["all-to-all"] == want == 8053063680
    assert coll["collective-permute"] == 0
    assert set(coll) == set(hlo.COLLECTIVE_KINDS) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    rest = [lf for lf in leaves if not lf[0].endswith("ffn/wo")]
    assert dryrun.cell_collectives(cfg, shape, sizes, rest, n_micro)[
        "all-reduce"] == coll["all-reduce"]


def test_report_renders_the_cli_s_record(cli_results, capsys):
    from repro_torch.analysis import report
    out_dir, _ = cli_results
    report.main(["--results", str(out_dir)])
    text = capsys.readouterr().out
    rec = json.loads((out_dir / "qwen1.5-4b-smoke__decode_32k__pod1.json")
                     .read_text())
    t = rec["roofline"]
    assert (f"| qwen1.5-4b-smoke | decode_32k | pod1 | "
            f"{t['compute_s']:.3f} | {t['memory_s']:.3f} | "
            f"{t['collective_s']:.3f} | {t['bottleneck'][:-2]} |") in text
    assert "## Hillclimb variants" in text
    assert "ops" not in "".join(report.load(out_dir))
