"""The QABAS serving-knob search and its launcher against the JAX
package's.

- ``enumerate_knobs``: the reference's grid under the backend name map
  (``xla`` -> ``gather``, ``pallas`` -> ``cuda``).
- ``analysis/roofline.py``: the H100 table, ``roofline_terms`` and
  ``model_flops`` against a restatement of the reference's formulas
  over that table (rel 1e-12); ``count_params_analytic`` and
  ``active_params`` equal the reference's, full configs included.
- ``knob_prior``: the same candidate order as the reference's prior on
  the same byte terms (the values differ: the tables differ).
- ``measure_knobs`` on the bridged fp32 ``qwen1.5-4b-smoke`` weights
  (int8-packed, the LM serving tests' models): cache bytes, resolved
  policy, greedy tokens and the bf16-parity column equal the
  reference's, exactly, for bf16, fp8 and int8 arenas at block_len 8
  and 16, each of the port's backends against its namesake (``gather``
  against ``xla``; ``cuda``, the kernels' plain versions on the CPU,
  against ``pallas`` in interpret mode: over an fp8 arena the kernels'
  blockwise softmax rounds p to bf16 on other partitions than the
  gather's whole-row softmax, and one greedy token of the workload
  differs between ``xla`` and ``pallas`` in the reference itself).
- ``search_serving_knobs`` with ``budget`` and ``per_group``, both
  packages' ``measure_knobs`` replaced by one deterministic function of
  the knobs: the same baseline, skipped list, measurement sequence
  (per-group specs included) and ranked table.
- ``launch/serve.py``: ``--knob-search`` prints the table and the best
  knobs, a basecaller exits with the reference's error; ``--split-tick``
  and ``--history-limit`` reach the engine and behave as the
  reference's; every flag of the reference's serve and train launchers
  (and of the three examples) exists in the port with the same default,
  type and action, up to the differences listed in ``ALLOWED``.
"""
import ast
import dataclasses
import math
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread)

from repro.analysis import roofline as jroofline
from repro.config import get_config as jget_config
from repro.core.qabas import serving as jserving
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.serving.cache import CachePool as JCachePool
from repro_torch.analysis import roofline
from repro_torch.config import get_config
from repro_torch.core.qabas import latency, serving
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.serving.cache import CachePool
from test_torch_lm_serving import (ENGINE, SPEC, _jax_serve, _serve,
                                   models as qwen_models)
from test_torch_moe_serving import models as moe_models

ROOT = Path(__file__).resolve().parents[1]
TO_REF = {"gather": "xla", "cuda": "pallas"}
TO_PORT = {v: k for k, v in TO_REF.items()}
REL = 1e-12


def _ref_knobs(k):
    return jserving.ServingKnobs(k.quant_policy, k.block_len,
                                 TO_REF[k.attn_backend])


# ------------------------------------------------------------- the grid


@pytest.mark.parametrize("kw", [
    {}, dict(modes=("bf16", "fp8", "int8"), block_lens=(4, 8, 16),
             backends=("xla", "pallas")),
    dict(modes=("int8", "bf16"), block_lens=(16,), backends=("pallas",))])
def test_enumerate_knobs_matches_reference(kw):
    want = jserving.enumerate_knobs(**kw)
    if "backends" in kw:
        kw = dict(kw, backends=tuple(TO_PORT[b] for b in kw["backends"]))
    got = serving.enumerate_knobs(**kw)
    assert [_ref_knobs(k) for k in got] == want
    assert serving.DEFAULT_CACHE_MODES == jserving.DEFAULT_CACHE_MODES


# ------------------------------------------------------------ roofline


def test_roofline_table_is_the_h100_data_sheet():
    assert (roofline.HBM_BW, roofline.PEAK_BF16, roofline.PEAK_INT8,
            roofline.PEAK_FP32, roofline.HBM_PER_CARD) == (
        3.35e12, 989e12, 1979e12, 67e12, 80 * 1024 ** 3)
    assert roofline.NVLINK_BW == 450e9
    # the QABAS latency estimator reads the same table
    assert (latency.HBM_BW, latency.PEAK_BF16, latency.PEAK_INT8) == (
        roofline.HBM_BW, roofline.PEAK_BF16, roofline.PEAK_INT8)
    # no TPU figure is left in the module (the reference's v5e table)
    src = (ROOT / "src/repro_torch/analysis/roofline.py").read_text()
    assert "v5e" not in src and "TPU" not in src
    numbers = {v for v in vars(roofline).values()
               if isinstance(v, (int, float))}
    tpu = {jroofline.PEAK_BF16, jroofline.PEAK_INT8, jroofline.HBM_BW,
           jroofline.ICI_BW, jroofline.HBM_PER_CHIP}
    assert not numbers & tpu


@pytest.mark.parametrize("hlo,int8_frac", [
    ({"flops": 3.2e12, "hbm_bytes": 7.9e9, "collective_bytes": 0.0}, 0.0),
    ({"flops": 8.0e15, "hbm_bytes": 1.0e9, "collective_bytes": 0.0}, 1.0),
    ({"flops": 1.0e14, "hbm_bytes": 4.0e10, "collective_bytes": 2.0e10},
     0.25),
    ({"flops": 0.0, "hbm_bytes": 0.0, "collective_bytes": 0.0}, 0.0)])
def test_roofline_terms_restate_the_reference(hlo, int8_frac):
    got = roofline.roofline_terms(hlo, int8_frac=int8_frac)
    peak = 989e12 * (1 - int8_frac) + 1979e12 * int8_frac
    terms = {"compute_s": hlo["flops"] / peak,
             "memory_s": hlo["hbm_bytes"] / 3.35e12,
             "collective_s": hlo["collective_bytes"] / 450e9}
    bound, total = max(terms.values()), sum(terms.values())
    # the reference's dict, key for key
    assert set(got) == set(jroofline.roofline_terms(hlo,
                                                    int8_frac=int8_frac))
    for k, v in terms.items():
        assert got[k] == pytest.approx(v, rel=REL, abs=0.0)
    assert got["step_time_lower_bound_s"] == pytest.approx(bound, rel=REL)
    assert got["roofline_fraction"] == pytest.approx(
        bound / total if total else 0.0, rel=REL)
    assert got["bottleneck"] == max(terms, key=terms.get)


@pytest.mark.parametrize("n,tokens,train", [(3950369280, 4096, True),
                                            (107072, 7, False)])
def test_model_flops_matches_reference(n, tokens, train):
    assert roofline.model_flops(n, tokens, train) == pytest.approx(
        jroofline.model_flops(n, tokens, train), rel=REL)


@pytest.mark.parametrize("arch", [
    "qwen1.5-4b", "deepseek-v3-671b", "granite-moe-1b-a400m", "mamba2-130m",
    "qwen1.5-4b-smoke", "deepseek-v3-671b-smoke", "rubicall", "hymba-1.5b",
    "hymba-1.5b-smoke"])
def test_param_counts_match_reference(arch):
    """Counted from shapes alone, no storage: full widths too."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert api.count_params_analytic(cfg) == \
        japi.count_params_analytic(jcfg)
    assert api.active_params(cfg) == japi.active_params(jcfg)


# ---------------------------------------------------------------- prior


def _prior_knobs():
    ks = [serving.ServingKnobs(m, bl, be) for m in ("bf16", "fp8", "int8")
          for bl in (8, 16) for be in ("gather", "cuda")]
    ks += [serving.ServingKnobs("default=bf16,g0_dense=int8", 16, "cuda"),
           serving.ServingKnobs("default=fp8,g1_moe=int8", 8, "gather")]
    # modes apart by more than the int8 credit's 2x (989 vs 1979 here,
    # 197 vs 394 there: no near-tie may hang on the third digit)
    arena = {"bf16": 96_000_000, "fp8": 48_000_000, "int8": 51_000_000,
             "default=bf16,g0_dense=int8": 70_000_000,
             "default=fp8,g1_moe=int8": 40_000_000}
    return ks, {k: arena[k.quant_policy] + 1000 * k.block_len + 7 * i
                for i, k in enumerate(ks)}


@pytest.mark.parametrize("param_bytes,n_slots", [
    (4_800_000_000, 4), (163_072, 2), (1_000_000_000, 65_536)])
def test_knob_prior_ranks_like_reference(param_bytes, n_slots):
    """Memory-bound (the first two) and compute-bound in both tables
    with the int8 credit (the third): the same order."""
    ks, cache = _prior_knobs()
    cfg = get_config("qwen1.5-4b")
    jcfg = jget_config("qwen1.5-4b")

    def order(mod, conv, c):
        pri = {k: mod.knob_prior(c, conv(k), param_bytes=param_bytes,
                                 cache_bytes=cache[k], n_slots=n_slots)
               for k in ks}
        return sorted(ks, key=lambda k: -pri[k])
    assert order(serving, lambda k: k, cfg) == order(jserving, _ref_knobs,
                                                     jcfg)


# ---------------------------------------------------------- measurement

TINY = dict(n_slots=2, cache_len=32, prompt_len=8, max_tokens=6,
            repeats=1)
MODES = ("bf16", "fp8", "int8")


@pytest.fixture(scope="module")
def measured():
    """The reference at block_len 8 on both backends (6 engine builds);
    the port at 8 and 16 on both."""
    jcfg, tcfg, jp, tp = qwen_models()
    ref = {(m, be): jserving.measure_knobs(
        jp, jcfg, jserving.ServingKnobs(m, 8, be), **TINY)
        for m in MODES for be in ("xla", "pallas")}
    port = {}
    for be in ("gather", "cuda"):
        for bl in (8, 16):
            base = serving.measure_knobs(
                tp, tcfg, serving.ServingKnobs("bf16", bl, be), device="cpu",
                **TINY)
            port[("bf16", bl, be)] = base
            for m in MODES[1:]:
                port[(m, bl, be)] = serving.measure_knobs(
                    tp, tcfg, serving.ServingKnobs(m, bl, be),
                    baseline=base, device="cpu", **TINY)
    return jcfg, ref, port


@pytest.mark.parametrize("backend", ["gather", "cuda"])
@pytest.mark.parametrize("block_len", [8, 16])
@pytest.mark.parametrize("mode", MODES)
def test_measure_knobs_matches_reference(measured, mode, block_len,
                                         backend):
    jcfg, ref, port = measured
    got = port[(mode, block_len, backend)]
    want = ref[(mode, TO_REF[backend])]
    jpool = JCachePool(jcfg, TINY["n_slots"], TINY["cache_len"],
                       jnp.dtype(jcfg.dtype), block_len=block_len,
                       quant_policy=mode, attn_backend="xla")
    assert got.cache_bytes == jpool.nbytes()
    assert got.bytes_by_class == jpool.nbytes_by_class()
    assert got.resolved_policy == want.resolved_policy == \
        jpool.quant_policy.describe()
    assert got._tokens == want._tokens
    assert len(got._tokens) == 2 * TINY["n_slots"]
    assert all(len(t) == TINY["max_tokens"] for t in got._tokens.values())
    if mode == "bf16":
        assert got.tokens_match_bf16 is None and got.bytes_vs_bf16 == 1.0
    else:
        assert got.tokens_match_bf16 == (
            want._tokens == ref[("bf16", TO_REF[backend])]._tokens)
        assert got.bytes_vs_bf16 == (port[("bf16", block_len, backend)]
                                     .cache_bytes / got.cache_bytes)
    assert got.decode_tok_s > 0 and got.score == pytest.approx(
        got.decode_tok_s / got.cache_bytes, rel=REL)


def test_measure_knobs_pool_size_is_analytic():
    """The arena of every candidate: K and V of every layer over n_slots
    x ceil(cache_len / block_len) blocks, plus int8's fp32 scale per
    position and KV head, the positions and each layer's window."""
    cfg = dataclasses.replace(get_config("qwen1.5-4b-smoke"),
                              dtype="float32")
    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    for mode, esize in (("bf16", 2), ("fp8", 1), ("int8", 1), ("fp32", 4)):
        for bl in (4, 8, 16):
            pool = CachePool(cfg, 4, 40, torch.float32, block_len=bl,
                             quant_policy=mode, device="cpu")
            positions = 4 * math.ceil(40 / bl) * bl
            want = (2 * L * positions * hkv * hd * esize
                    + (2 * L * positions * hkv * 4 if mode == "int8" else 0)
                    + L * positions * 4 + L * 4)
            assert pool.nbytes() == want, (mode, bl)


# --------------------------------------------------------------- search


def _fake_measure(mod, groups, calls):
    """One deterministic function of the knobs, in either package's
    types: bytes by group mode, tok/s by the (reference-named) label."""
    per_group = {"bf16": 4096, "fp8": 2048, "int8": 2176}

    def fake(params, cfg, knobs, *, baseline=None, n_slots=4, **kw):
        be = TO_REF.get(knobs.attn_backend, knobs.attn_backend)
        label = f"{knobs.quant_policy}|{knobs.block_len}|{be}"
        calls.append(label)
        parts = knobs.quant_policy.split(",")
        default = parts[0].replace("default=", "")
        mode = dict(p.split("=") for p in parts[1:])
        nbytes = 64 + sum(per_group[mode.get(g, default)] for g in groups)
        tps = 100.0 + sum(map(ord, label)) % 53 + knobs.block_len / 8
        tokens = {0: [1, 2, 3 if "int8" not in label else 4]}
        r = mod.KnobResult(
            knobs=knobs, resolved_policy=knobs.quant_policy,
            decode_tok_s=tps, cache_bytes=nbytes,
            bytes_by_class={"arena": nbytes - 64, "scales": 0, "pos": 64,
                            "state": 0},
            score=tps / nbytes,
            prior_score=mod.knob_prior(cfg, knobs,
                                       param_bytes=mod._param_bytes(params),
                                       cache_bytes=nbytes, n_slots=n_slots),
            bytes_vs_bf16=baseline.cache_bytes / nbytes if baseline else 1.0,
            tokens_match_bf16=(tokens == baseline._tokens if baseline
                               else None))
        r._tokens = tokens
        return r
    return fake


def _to_ref_text(s: str) -> str:
    """The port's table/log text in the reference's backend names (the
    table pads ``attn`` to 6 characters)."""
    return (s.replace("attn=gather", "attn=xla")
            .replace("attn=cuda", "attn=pallas")
            .replace("gather", "   xla").replace("  cuda", "pallas"))


@pytest.mark.parametrize("arch,budget", [("qwen1.5-4b-smoke", 5),
                                         ("deepseek-v3-671b-smoke", 4),
                                         ("deepseek-v3-671b-smoke", None)])
def test_search_serving_knobs_matches_reference(arch, budget, monkeypatch):
    from repro.models.lm import transformer as jtfm
    from repro_torch.models.lm import transformer as tfm
    if arch.startswith("qwen"):
        jcfg, tcfg, jp, tp = qwen_models()
    else:
        jcfg, tcfg, jp, tp = moe_models(arch)
    groups = [g for g, _, _ in tfm.group_names(tcfg)]
    assert groups == [g for g, _, _ in jtfm.group_names(jcfg)]
    assert serving._param_bytes(tp) == jserving._param_bytes(jp)
    runs = {}
    for mod, cfg, p, backends in (
            (jserving, jcfg, jp, ["xla", "pallas"]),
            (serving, tcfg, tp, ["gather", "cuda"])):
        calls, said = [], []
        monkeypatch.setattr(mod, "measure_knobs",
                            _fake_measure(mod, groups, calls))
        res = mod.search_serving_knobs(
            p, cfg, block_lens=[8, 16], backends=backends, n_slots=2,
            per_group=True, budget=budget, emit=said.append)
        runs[mod.__name__] = (calls, said, res)
    jcalls, jsaid, jres = runs[jserving.__name__]
    calls, said, res = runs[serving.__name__]
    assert calls == jcalls                   # baseline, prior order, refine
    assert any("refine" in line for line in said)
    assert (budget is not None) == any("skipping" in line for line in said)
    assert [_to_ref_text(line) for line in said] == jsaid
    assert [_ref_knobs(r.knobs) for r in res] == [r.knobs for r in jres]
    assert _to_ref_text(serving.format_knob_table(res)) == \
        jserving.format_knob_table(jres)


# ------------------------------------------------------------- launcher

KNOB_ARGS = ["--arch", "qwen1.5-4b", "--smoke", "--knob-search",
             "--device", "cpu", "--slots", "2", "--prompt-len", "8",
             "--tokens", "6", "--knob-budget", "4", "--wbits", "8"]


def test_serve_knob_search_prints_the_ranked_table(capsys):
    serve.main(KNOB_ARGS)
    out = capsys.readouterr().out
    assert "[serve] knob search over qwen1.5-4b-smoke" in out
    assert "rank  cache policy" in out
    rows = [ln for ln in out.splitlines()
            if ln[:4].strip().isdigit() and ln.startswith("   ")]
    assert [int(r.split()[0]) for r in rows] == [1, 2, 3, 4]
    assert "[knobs] baseline cache=bf16;bl=8;attn=gather" in out
    assert "[knobs] budget 4: skipping 8 low-prior candidates" in out
    assert "[serve] best: --quant-policy '" in out


def test_knob_search_refuses_a_basecaller_like_reference(capsys):
    with pytest.raises(SystemExit) as want:
        jserve.run_knob_search(None, jget_config("rubicall-smoke"), None)
    with pytest.raises(SystemExit) as got:
        serve.main(["--arch", "rubicall", "--smoke", "--knob-search",
                    "--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "has no KV cache" in str(got.value)


def test_split_tick_serves_like_the_reference_split_tick():
    """``co_batch=False``: one step per prefilling slot, then a
    decode-only step — the same greedy tokens as the reference's
    split-tick engine, and the same count of decode steps."""
    jcfg, tcfg, jp, tp = qwen_models()
    want, jeng = _jax_serve(jcfg, jp, co_batch=False, **ENGINE)
    got, eng = _serve(tcfg, tp, co_batch=False, **ENGINE)
    assert got == want
    assert eng.metrics.summary()["decode_steps"] == \
        jeng.metrics.summary()["decode_steps"]
    unified, _ = _serve(tcfg, tp, **ENGINE)
    assert unified == got                  # greedy tokens: schedule-free


def test_history_limit_bounds_history_like_the_reference():
    jcfg, tcfg, jp, tp = qwen_models()
    spec = SPEC * 2
    want, jeng = _jax_serve(jcfg, jp, spec=spec, history_limit=2, **ENGINE)
    got, eng = _serve(tcfg, tp, spec=spec, history_limit=2, **ENGINE)
    assert got == want and len(got) == 2
    assert [list(h) for h in eng.slot_history] == \
        [list(h) for h in jeng.slot_history]
    assert all(len(h) <= 2 for h in eng.slot_history)


def test_serve_flags_reach_the_engine(monkeypatch, capsys):
    seen = {}
    real = api.make_serving_engine

    def spy(params, cfg, **kw):
        seen.update(kw)
        return real(params, cfg, **kw)
    monkeypatch.setattr(api, "make_serving_engine", spy)
    serve.main(["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu",
                "--requests", "3", "--rate", "1000", "--prompt-len", "6",
                "--tokens", "4", "--split-tick", "--history-limit", "2"])
    out = capsys.readouterr().out
    assert seen["co_batch"] is False and seen["history_limit"] == 2
    assert "history_limit 2" in out and "(split-tick)" in out
    assert "[serve] done: 3 requests" in out


# ------------------------------------------------------- parser parity


def _flags(path: Path) -> dict:
    """{option string: (default, type, action, choices, dest)} of every
    ``add_argument`` in the file's ``main``, as source text."""
    tree = ast.parse(path.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    out = {}
    for node in ast.walk(main):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        kw = {k.arg: ast.unparse(k.value) for k in node.keywords}
        spec = tuple(kw.get(k) for k in ("default", "type", "action",
                                         "choices", "dest"))
        for a in node.args:
            out[a.value] = spec
    return out


# (reference, port, {flag: (field, reference text, port text)} allowed
# to differ, flags only the port has)
PARSERS = [
    ("src/repro/launch/serve.py", "src/repro_torch/launch/serve.py",
     {"--attn-backend": (3, "['auto', 'xla', 'pallas']",
                         "['auto', 'gather', 'cuda']")}),
    ("src/repro/launch/train.py", "src/repro_torch/launch/train.py",
     {"--ckpt-dir": (0, "'/tmp/repro_ckpt'",
                     "os.path.join(tempfile.gettempdir(), 'repro_ckpt')")}),
    ("examples/quickstart.py", "examples/quickstart_torch.py", {}),
    ("examples/train_basecaller.py", "examples/train_basecaller_torch.py",
     {"--ckpt-dir": (0, "'/tmp/repro_basecaller_ckpt'",
                     "os.path.join(tempfile.gettempdir(), "
                     "'repro_basecaller_ckpt')")}),
    ("examples/serve_quantized_lm.py", "examples/serve_quantized_lm_torch.py",
     {}),
]


@pytest.mark.parametrize("ref,port,allowed", PARSERS,
                         ids=[Path(p).name for _, p, _ in PARSERS])
def test_launcher_flags_match_reference(ref, port, allowed):
    want, got = _flags(ROOT / ref), _flags(ROOT / port)
    assert set(got) == set(want) | {"--device"}
    assert got["--device"][0] == "'cuda'"
    for flag, spec in want.items():
        if flag in allowed:
            field, ref_text, port_text = allowed[flag]
            assert spec[field] == ref_text and got[flag][field] == port_text
            spec = spec[:field] + (port_text,) + spec[field + 1:]
        assert got[flag] == spec, flag
