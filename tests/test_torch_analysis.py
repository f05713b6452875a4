"""repro_torch.analysis — the port's serving-invariant analyzer, held
against the reference's (``repro.analysis``).

Each rule gets a seeded violation (a deliberately-broken program or
source snippet) asserting the finding fires WITH correct provenance,
plus the clean cases that must not fire — the twins of
``tests/test_analysis.py``. Parity with the reference: the registry's
ids and kinds, the findings helpers on the same inputs, the AST rules
on the reference's seeded snippets (the same ``rule`` and ``where``),
the smoke pools' arena signatures, the view-sized gathers of the
``gather`` backend's tick against the reference's ``xla`` tick, and
the TokenRunner plan keys. The whole gate runs on the port's tree on
the CPU (``--device cpu``); a ``gpu`` case runs it on the card.
"""
import textwrap

import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro_torch.analysis import findings as tfind
from repro_torch.analysis.cli import main, run_rules
from repro_torch.analysis.context import AnalysisContext
from repro_torch.analysis.findings import (Finding, apply_allowlist,
                                           inline_allowed, is_allowed)
from repro_torch.analysis.jaxpr_walk import gather_sizes, iter_eqns, record
from repro_torch.analysis.rules import all_rules
from repro_torch.analysis.targets import TraceTarget
from repro_torch.kernels import _build, ref

SMOKE_FAMILIES = ("qwen1.5-4b-smoke", "hymba-1.5b-smoke",
                  "deepseek-v3-671b-smoke")


# ------------------------------------------------------------- registry


def test_registry_has_the_five_rules():
    ids = [r.id for r in all_rules()]
    assert ids == sorted(["no-materialization", "precision", "compat",
                          "host-sync", "trace-stability"])


def test_registry_rejects_unknown_rule():
    with pytest.raises(ValueError, match="unknown rules"):
        all_rules(["no-such-rule"])


def test_registry_ids_and_kinds_are_the_reference_s():
    from repro.analysis.rules import all_rules as jall_rules
    assert ([(r.id, r.kind) for r in all_rules()]
            == [(r.id, r.kind) for r in jall_rules()])


# ---------------------------------------------------------------- walker


def test_walker_records_plain_version_ops_with_path_and_source():
    """The recorder sees the aten ops inside a kernel's plain version,
    with that plain version as their path and the port's line as their
    provenance; composites that inference mode hands over whole are
    recorded as the ops they run."""
    k = torch.zeros((10, 4, 2, 16))
    q = torch.zeros((2, 2, 1, 16))
    pos = torch.zeros((2, 16), dtype=torch.int32)
    t = torch.zeros((2,), dtype=torch.int32)
    table = torch.zeros((2, 4), dtype=torch.int32)
    with torch.inference_mode():
        _, trace = record(ref.gqa_paged_ref, q, k, k, pos, t, table)
    sites = list(iter_eqns(trace))
    gathers = [s for s in sites if s.eqn.name == "index"]
    assert len(gathers) == 2 * 4                 # K and V, per table column
    g = gathers[0]
    assert g.path == ("gqa_paged_ref",)
    assert g.path_str == "gqa_paged_ref/index"
    assert g.eqn.source.startswith("src/repro_torch/kernels/")
    assert g.eqn.in_shapes[0] == (10, 4, 2, 16)
    assert gather_sizes(trace) == [2 * 4 * 2 * 16] * 8
    names = {s.eqn.name for s in sites}
    assert "bmm" in names or "mm" in names       # q @ k^T, decomposed
    assert "matmul" not in names and "to" not in names


def test_walker_records_kernel_launches_through_the_counter_hook():
    """A launch is a site of its own (the ctypes call is invisible to
    the dispatcher); the hook is None again once recording ends."""
    def fake_launch():
        _build.ON_LAUNCH("gqa_paged", "tensor_core")
        return torch.zeros(2) + 1
    _, trace = record(fake_launch)
    assert trace.launches() == {"gqa_paged": {"tensor_core": 1}}
    assert trace.ops[0].name == "kernel:gqa_paged"
    assert _build.ON_LAUNCH is None


# ------------------------------------------------- rule: materialization


def _seeded_target(fn, args, backend, name="seeded", **kw):
    meta = dict(kind="attn-op", quantized=False, n_slots=2, block_len=4,
                arena_sigs={(10, 4): 4})
    meta.update(kw)
    with torch.inference_mode():
        _, trace = record(fn, *args)
    return TraceTarget(name=name, jaxpr=trace, backend=backend, **meta)


def _take(k, i):
    return torch.index_select(k, 0, i)


def test_materialization_flags_arena_gather_on_cuda():
    from repro_torch.analysis.rules.materialization import check_target
    k = torch.zeros((10, 4, 2, 16))          # arena-shaped (Nb, bl, ...)
    idx = torch.zeros((8,), dtype=torch.long)  # B*T rows -> full view

    (f,) = check_target(_seeded_target(_take, (k, idx), "cuda"))
    assert f.rule == "no-materialization"
    assert f.where.startswith("seeded::") and "index_select" in f.where
    assert "logical KV view" in f.message
    # same program on the gather backend IS the oracle: no finding
    assert check_target(_seeded_target(_take, (k, idx), "gather")) == []


def test_materialization_flags_a_view_sized_arena_copy_on_cuda():
    """On the card the recorded ops are the glue around the launches: an
    arena copied whole (``.clone()``, a flattening ``reshape``) is the
    copy the kernels exist to avoid."""
    from repro_torch.analysis.rules.materialization import check_target
    k = torch.zeros((10, 4, 2, 16))
    (f,) = check_target(_seeded_target(lambda k: k.clone(), (k,), "cuda"))
    assert "clone" in f.where
    (f,) = check_target(_seeded_target(lambda k: k.reshape(40, 32), (k,),
                                       "cuda"))
    assert f.where == "seeded::view"
    # a dtype view flattens nothing
    assert check_target(_seeded_target(lambda k: k.view(torch.int32),
                                       (k,), "cuda")) == []


def test_materialization_flags_oracle_drift_on_gather():
    from repro_torch.analysis.rules.materialization import check_target
    k = torch.zeros((10, 4, 2, 16))
    (f,) = check_target(_seeded_target(lambda k: k * 2.0, (k,), "gather"))
    assert f.where == "seeded::oracle" and "oracle" in f.message


def test_materialization_ignores_non_arena_gathers():
    from repro_torch.analysis.rules.materialization import check_target
    emb = torch.zeros((256, 64))              # embedding table, not arena
    idx = torch.zeros((2, 4), dtype=torch.long)
    assert check_target(_seeded_target(
        torch.nn.functional.embedding, (idx, emb), "cuda")) == []


# ------------------------------------------------------- rule: precision


def test_precision_flags_bf16_accumulator_attention():
    from repro_torch.analysis.rules.precision import check_target
    q = torch.zeros((2, 8, 16), dtype=torch.bfloat16)

    def bad_attn(q, k):                       # bf16 product, bf16 out
        return q @ k.transpose(1, 2)

    (f,) = check_target(_seeded_target(bad_attn, (q, q), "gather",
                                       arena_sigs={}))
    assert f.rule == "precision"
    assert "low-precision accumulator" in f.message
    assert "bmm" in f.where


def test_precision_flags_bf16_softmax_stats():
    from repro_torch.analysis.rules.precision import check_target
    s = torch.zeros((2, 16), dtype=torch.bfloat16)

    def manual_softmax(s):                    # online-softmax stats in bf16
        p = torch.exp(s - s.amax(-1, keepdim=True))
        return p / p.sum(-1, keepdim=True)
    found = check_target(_seeded_target(manual_softmax, (s,), "gather",
                                        arena_sigs={}))
    assert {f.rule for f in found} == {"precision"}
    assert any("exp over bfloat16" in f.message for f in found)
    assert any("amax over bfloat16" in f.message for f in found)
    found = check_target(_seeded_target(lambda s: torch.softmax(s, -1),
                                        (s,), "gather", arena_sigs={}))
    assert any("_softmax over bfloat16" in f.message for f in found)


def test_precision_flags_laundering_downcast_on_quantized_path():
    from repro_torch.analysis.rules.precision import check_target
    s = torch.zeros((2, 16))

    def launder(s):                           # fp32 stats -> bf16 exp
        return torch.exp(s.to(torch.bfloat16))

    found = check_target(_seeded_target(launder, (s,), "gather",
                                        quantized=True, arena_sigs={}))
    assert any("downcast" in f.message for f in found)
    # the same downcast is fine when nothing stats-like consumes it
    # (that IS the dequant contract's shape)
    assert check_target(_seeded_target(
        lambda s: s.to(torch.bfloat16) * 2, (s,), "gather",
        quantized=True, arena_sigs={})) == []


def test_precision_accepts_the_dequant_contract():
    from repro_torch.analysis.rules.precision import check_target
    from repro_torch.kernels.paged_attention import dequantize_kv
    q = torch.zeros((10, 4, 16), dtype=torch.int8)
    sc = torch.zeros((10, 4))
    w = torch.zeros((16, 16), dtype=torch.bfloat16)

    def contract(q, sc, w):                   # dequant -> fp32-acc product
        x = dequantize_kv(q, sc)
        return torch.einsum("nbd,de->nbe", x.float(), w.float())

    assert check_target(_seeded_target(contract, (q, sc, w), "gather",
                                       quantized=True, arena_sigs={})) == []


# ---------------------------------------------------------- rule: compat

# the reference's snippets (tests/test_analysis.py), rewritten for the
# port's gated torch names line for line
_COMPAT_BAD = "import jax\nmesh = jax.sharding.get_abstract_mesh()\n"
_TCOMPAT_BAD = "import torch\nmesh = torch.distributed.tensor.Shard(0)\n"
_COMPAT_PAIRS = [
    (("launch/mesh.py", _COMPAT_BAD), ("launch/mesh.py", _TCOMPAT_BAD)),
    (("models/x.py", "from jax.sharding import AxisType\n"),
     ("models/x.py", "from torch.distributed.tensor import Replicate\n")),
    (("models/y.py", "import jax\n"
      "g = getattr(jax.sharding, 'get_abstract_mesh', None)\n"),
     ("models/y.py", "import torch\n"
      "g = getattr(torch.distributed, 'distribute_tensor', None)\n")),
    (("models/z.py", "from jax.sharding import AxisType\n"),
     ("models/z.py",
      "from torch._subclasses.fake_tensor import FakeTensorMode\n")),
]


@pytest.mark.parametrize("ref_case,port_case", _COMPAT_PAIRS,
                         ids=lambda c: c[0])
def test_compat_flags_what_the_reference_flags(ref_case, port_case):
    """Each seeded snippet: one finding, with the reference's ``rule``
    and ``where`` (provenance: the exact line)."""
    from repro.analysis.rules.compat_gate import check_source as jcheck
    from repro_torch.analysis.rules.compat_gate import check_source
    (want,) = jcheck(*ref_case)
    (got,) = check_source(*port_case)
    assert (got.rule, got.where) == (want.rule, want.where)


def test_compat_flags_raw_api_outside_compat_py():
    from repro_torch.analysis.rules.compat_gate import check_source
    (f,) = check_source("launch/mesh.py", _TCOMPAT_BAD)
    assert f.rule == "compat"
    assert f.where == "launch/mesh.py:2"      # provenance: exact line
    assert "torch.distributed.tensor" in f.message
    (f2,) = check_source(
        "models/x.py", "from torch._subclasses.fake_tensor import is_fake\n")
    assert f2.where == "models/x.py:1" and "is_fake" in f2.message
    (f3,) = check_source(
        "models/y.py",
        "import torch\ng = getattr(torch.distributed, 'DTensor', None)\n")
    assert "getattr" in f3.message
    (f4,) = check_source("parallel/s.py",
                         "import torch.distributed._tensor as dt\n")
    assert f4.where == "parallel/s.py:1"
    # the shims themselves, imported from the port, are the fix
    assert check_source("parallel/s.py", "from repro_torch.compat import "
                        "Replicate, Shard, is_fake\n") == []


def test_compat_exempts_compat_py_and_inline_allow():
    from repro_torch.analysis.rules.compat_gate import check_source
    assert check_source("compat.py", _TCOMPAT_BAD) == []
    allowed = ("import torch\n"
               "m = torch.distributed.tensor.Shard(0)  "
               "# repro-allow: compat\n")
    assert check_source("launch/mesh.py", allowed) == []


# ------------------------------------------------------- rule: host-sync


# the reference's snippet, as it stands in tests/test_analysis.py
_SYNC_SNIPPET = textwrap.dedent("""\
    import numpy as np

    class R:
        def _step_decode_only(self, works):
            toks = self._prog()
            toks = np.asarray(toks){marker}
            return toks

        def helper(self):
            return np.asarray(self.x)     # not a tick function: fine
""")


def test_host_sync_flags_unannotated_tick_sync():
    from repro_torch.analysis.rules.host_sync import check_source
    (f,) = check_source("serving/runner.py",
                        _SYNC_SNIPPET.format(marker=""))
    assert f.rule == "host-sync"
    assert f.where == "serving/runner.py:6"   # provenance: exact line
    assert "np.asarray" in f.message


def test_host_sync_matches_the_reference_on_its_snippets():
    from repro.analysis.rules.host_sync import check_source as jcheck
    from repro_torch.analysis.rules.host_sync import check_source
    for marker in ("", "  # sync: scheduler needs tokens",
                   "  # repro-allow: host-sync"):
        src = _SYNC_SNIPPET.format(marker=marker)
        for path in ("serving/runner.py", "serving/engine.py",
                     "kernels/ops.py"):
            assert ([(f.rule, f.where) for f in check_source(path, src)]
                    == [(f.rule, f.where) for f in jcheck(path, src)])


@pytest.mark.parametrize("call", [
    "toks.cpu()", "toks.numpy()", "toks.tolist()", "toks.item()",
    "torch.cuda.synchronize()", "stream.synchronize()", "np.asarray(toks)",
    "readback(toks)", "runner_mod.readback(toks)"])
def test_host_sync_flags_pytorch_sync_spellings(call):
    from repro_torch.analysis.rules.host_sync import check_source
    src = textwrap.dedent(f"""\
        def collect(self, handle):
            toks = handle[1]
            out = {call}
            return out
    """)
    (f,) = check_source("serving/runner.py", src)
    assert f.where == "serving/runner.py:3"
    assert check_source("serving/runner.py", src.replace(
        f"out = {call}", f"# sync: the scheduler reads them\n"
                         f"    out = {call}")) == []


def test_host_sync_accepts_marker_and_inline_allow():
    from repro_torch.analysis.rules.host_sync import check_source
    ok = _SYNC_SNIPPET.format(marker="  # sync: scheduler needs tokens")
    assert check_source("serving/runner.py", ok) == []
    allowed = _SYNC_SNIPPET.format(marker="  # repro-allow: host-sync")
    assert check_source("serving/runner.py", allowed) == []
    # non-tick files are out of scope entirely
    assert check_source("kernels/ops.py",
                        _SYNC_SNIPPET.format(marker="")) == []


# ------------------------------------------- rule: trace-stability


def test_trace_stability_flags_a_kernel_load_after_warmup():
    """The port's compile is a kernel library's build and load: a tick
    that loads one after warmup is flagged (simulated on the counter)."""
    from repro_torch.analysis.rules.trace_stability import audit_program
    state = {"n": 0}

    def call():
        state["n"] += 1
        if state["n"] > 1:                    # past the warmup call
            _build.COUNTS["loads"] += 1
    before = dict(_build.COUNTS)
    try:
        found = audit_program("seeded", call)
    finally:
        _build.COUNTS.update(before)
    assert [f.where for f in found] == ["seeded::load"]
    assert "loads" in found[0].message


def test_trace_stability_flags_fanout_across_repeats(monkeypatch):
    """One bucket, one program: a repeat that launches on another route
    is flagged (the counters' reads, before and after each repeat)."""
    from repro_torch.analysis.rules import trace_stability as ts
    from repro_torch.kernels import ops
    reads = iter([{"gqa_paged": {"tensor_core": 0, "cuda_core": 0}},
                  {"gqa_paged": {"tensor_core": 1, "cuda_core": 0}},
                  {"gqa_paged": {"tensor_core": 1, "cuda_core": 0}},
                  {"gqa_paged": {"tensor_core": 1, "cuda_core": 1}}])
    monkeypatch.setattr(ops, "launch_counts",
                        lambda routes=False: next(reads))
    found = ts.audit_program("seeded", lambda: None, warm=lambda: None)
    assert [f.where for f in found] == ["seeded::fanout"]


def test_trace_stability_flags_a_missing_mixed_bucket():
    from repro_torch.analysis.rules.trace_stability import bucket_coverage
    from repro_torch.serving.plan import PlanCache, chunk_buckets

    class Runner:
        chunk_tokens = 4
        buckets = chunk_buckets(4)
        plans = PlanCache()
    for flavor in ("greedy", "sampled"):
        Runner.plans.register(("decode", 1, flavor), None)
        for w in (1, 2):                      # no ("mixed", 4, ...)
            Runner.plans.register(("mixed", w, flavor), None)
    found = bucket_coverage(Runner, "seeded")
    assert found and {f.where for f in found} == {"seeded::bucket-coverage"}
    assert any("('mixed', 4, 'greedy')" in f.message for f in found)


def test_trace_stability_accepts_the_live_smoke_runners():
    """The real qwen smoke runner (``cuda`` read path: the plain
    versions here) and the read-until basecaller: nothing loads, the
    same launches each repeat (none on the CPU), every bucket planned."""
    from repro_torch.analysis.rules.trace_stability import check
    assert check(AnalysisContext(device="cpu")) == []


def test_plan_keys_are_the_reference_s():
    from repro.analysis.targets import _build_runner as jbuild
    from repro_torch.analysis.targets import _build_runner
    want = jbuild("qwen1.5-4b-smoke", "xla").plans.keys()
    got = _build_runner("qwen1.5-4b-smoke", "gather", device="cpu")
    assert sorted(got.plans.keys()) == sorted(want)


# ------------------------------------------------ targets vs reference


@pytest.mark.parametrize("arch", SMOKE_FAMILIES)
def test_arena_signatures_are_the_reference_s(arch):
    import jax.numpy as jnp
    from repro.analysis.targets import _pool_sigs as jsigs
    from repro.config import get_config as jget_config
    from repro.serving.cache import CachePool as JCachePool
    from repro_torch.analysis.targets import (BLOCK_LEN, CACHE_LEN, N_SLOTS,
                                              _pool_sigs)
    from repro_torch.config import get_config
    from repro_torch.serving.cache import CachePool
    want = jsigs(JCachePool(jget_config(arch), N_SLOTS, CACHE_LEN,
                            jnp.float32, block_len=BLOCK_LEN,
                            attn_backend="xla"))
    got = _pool_sigs(CachePool(get_config(arch), N_SLOTS, CACHE_LEN,
                               torch.float32, block_len=BLOCK_LEN,
                               attn_backend="gather", device="cpu"))
    assert got == want and got


@pytest.mark.parametrize("tick", ["decode", "mixed"])
def test_gather_tick_gathers_the_reference_s_views(tick):
    """The ``gather`` backend's tick gathers the same view-sized arena
    copies as the reference's ``xla`` tick (qwen1.5-4b-smoke). The
    reference scans its layer stack, so its jaxpr holds one layer's
    gathers inside the ``scan``; the port runs each layer."""
    from repro.analysis import jaxpr_walk as jw
    from repro.analysis.targets import serving_step_targets as jtargets
    from repro_torch.analysis.jaxpr_walk import GATHER_OPS
    from repro_torch.analysis.targets import serving_step_targets
    from repro_torch.config import get_config
    fam = (("gqa", "qwen1.5-4b-smoke"),)
    (want,) = [t for t in jtargets(fam, ("xla",), ())
               if t.name.endswith(f"/{tick}]")]
    (got,) = [t for t in serving_step_targets(fam, ("gather",), (),
                                              device="cpu")
              if t.name.endswith(f"/{tick}]")]
    jsites = [s for s in jw.iter_eqns(want.jaxpr)
              if s.eqn.primitive.name == "gather"
              and want.view_floor(s.eqn.invars[0].aval.shape) is not None
              and s.eqn.outvars[0].aval.size
              >= want.view_floor(s.eqn.invars[0].aval.shape)]
    assert jsites and all("scan" in s.path for s in jsites)
    jv = [s.eqn.outvars[0].aval.size for s in jsites]
    tv = []
    for s in iter_eqns(got.jaxpr):
        floor = (got.view_floor(s.eqn.in_shapes[0])
                 if s.eqn.name in GATHER_OPS else None)
        if floor is not None and s.eqn.out_numel() >= floor:
            tv.append(s.eqn.out_numel())
    assert sorted(tv) == sorted(jv * get_config(fam[0][1]).n_layers)


# ------------------------------------------- allowlist + driver + CLI

_FINDINGS = [Finding("compat", "launch/mesh.py:2", "msg"),
             Finding("precision", "step[x/cuda/mixed]::gqa_paged_ref/mm",
                     "m")]
_ALLOWS = ["compat:launch/*", "compat", "precision:launch/*", "*:step[*",
           "precision:step[x/cuda/*", "host-sync:"]


def test_findings_helpers_are_the_reference_s():
    from repro.analysis import findings as jfind
    for entry in _ALLOWS:
        assert tfind.parse_allow_entry(entry) == \
            jfind.parse_allow_entry(entry)
    for f in _FINDINGS:
        jf = jfind.Finding(f.rule, f.where, f.message)
        assert str(f) == str(jf)
        for entry in _ALLOWS:
            assert is_allowed(f, [entry]) == jfind.is_allowed(jf, [entry])
    lines = ["x = 1  # repro-allow: compat, host-sync", "y = 2",
             "# repro-allow: precision", "z = 3"]
    for ln in range(0, 6):
        for r in ("compat", "host-sync", "precision", "trace-stability"):
            assert (inline_allowed(lines, ln, r)
                    == jfind.inline_allowed(lines, ln, r))


def test_allowlist_suppression_globs():
    f = Finding("compat", "launch/mesh.py:2", "msg")
    assert is_allowed(f, ["compat:launch/*"])
    assert is_allowed(f, ["compat"])          # bare rule = everywhere
    assert not is_allowed(f, ["precision:launch/*"])
    kept, supp = apply_allowlist([f], ["compat:launch/*"])
    assert kept == [] and supp == [f]


def test_inline_allow_matches_rule_list():
    lines = ["x = 1  # repro-allow: compat, host-sync"]
    assert inline_allowed(lines, 1, "compat")
    assert inline_allowed(lines, 1, "host-sync")
    assert not inline_allowed(lines, 1, "precision")


def test_default_allowlist_is_empty():
    from repro_torch.analysis.allowlist import DEFAULT_ALLOWLIST
    assert DEFAULT_ALLOWLIST == ()


def test_driver_reports_crashed_rule_as_finding(monkeypatch):
    import repro_torch.analysis.rules.compat_gate as cg
    monkeypatch.setattr(
        cg, "check_source",
        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    ctx = AnalysisContext()
    (f,) = [f for f in run_rules(ctx, ["compat"]) if f.rule == "compat"]
    assert f.where == "rule:compat" and "crashed" in f.message


def test_cli_nonzero_on_seeded_tree_and_allow_flag(tmp_path, capsys):
    bad = tmp_path / "launch"
    bad.mkdir()
    (bad / "mesh.py").write_text(_TCOMPAT_BAD)
    (tmp_path / "serving").mkdir()
    (tmp_path / "serving" / "runner.py").write_text(
        _SYNC_SNIPPET.format(marker=""))

    rc = main(["--rules", "compat,host-sync", "--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "launch/mesh.py:2" in out and "serving/runner.py:6" in out

    rc = main(["--rules", "compat,host-sync", "--root", str(tmp_path),
               "--allow", "compat:launch/*",
               "--allow", "host-sync:serving/*"])
    assert rc == 0
    assert "suppressed" in capsys.readouterr().out
    assert main(["--rules", "no-such-rule"]) == 2


def test_cli_ast_rules_clean_on_repo():
    assert main(["--rules", "compat,host-sync"]) == 0


def test_driver_flags_seeded_trace_targets_through_registry():
    """Seeded violations reach the registered rules via an injected
    context — a bf16-accumulator attention program and an arena-view
    gather on the fused path both produce gate-failing findings."""
    q = torch.zeros((2, 8, 16), dtype=torch.bfloat16)
    bad_acc = _seeded_target(lambda q, k: q @ k.transpose(1, 2), (q, q),
                             "gather", arena_sigs={})
    k = torch.zeros((10, 4, 2, 16))
    idx = torch.zeros((8,), dtype=torch.long)
    bad_gather = _seeded_target(_take, (k, idx), "cuda")
    ctx = AnalysisContext(jaxpr_targets=[bad_acc, bad_gather])
    found = run_rules(ctx, ["precision", "no-materialization"])
    assert {f.rule for f in found} == {"precision", "no-materialization"}


def test_cli_full_gate_clean_on_repo(capsys):
    """The gate itself on the port's tree, every rule, the real tick
    programs recorded on the CPU: exit 0."""
    assert main(["--device", "cpu"]) == 0
    assert "clean" in capsys.readouterr().out


@pytest.mark.gpu
def test_cli_full_gate_clean_on_the_card(capsys):
    """On a card the ``cuda`` targets launch the paged kernels and
    ``qmatmul``, and every serving tick its fixed-shape writes
    (``scatter_rows``): the gate is clean there too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert main([]) == 0
    assert "clean" in capsys.readouterr().out
    ctx = AnalysisContext(device="cuda")
    launched = {k: v for t in ctx.jaxpr_targets
                for k, v in t.jaxpr.launches().items()}
    assert set(launched) == {"gqa_paged", "gqa_paged_chunk", "mla_paged",
                             "mla_paged_chunk", "qmatmul", "scatter_rows"}
