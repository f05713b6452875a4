"""The port's dry run and its scale-out substrate against the JAX package's.

``config`` shapes, ``launch/mesh.py``, ``parallel/sharding.py``,
``training/elastic.py``, ``api.batch_struct`` and ``launch/dryrun.py``.
Specs are compared entry for entry with the reference's
``PartitionSpec``s on the full configs, from shapes alone (the port's
trees under ``FakeTensorMode``, the reference's under
``jax.eval_shape``). A production mesh stands on a ``fake`` process
group of 256 or 512 ranks, torn down after each test that makes one.
"""
import ast
import dataclasses
import json
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
    """Tears down whatever process group a test made."""
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
                               moe._routed(p, x, dispatch, combine),
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


def test_dryrun_cli_writes_a_record_with_every_reference_key(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-4b-smoke", "--shape", "decode_32k", "--save-hlo",
         "--results", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[ok]   qwen1.5-4b-smoke__decode_32k__pod1" in r.stdout
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
    with pytest.raises(NotImplementedError, match="blockwise"):
        dryrun.build_cell(config.get_config("qwen1.5-4b-smoke"),
                          config.SHAPES["train_4k"], None, variant="tri")
