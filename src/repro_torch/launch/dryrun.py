"""Multi-pod dry run (the port's counterpart of ``repro.launch.dryrun``):
every (arch x shape x mesh) cell's step on stand-in devices, with no
allocation, its per-device argument bytes from the placements and its
roofline terms from counted work.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
    python -m repro_torch.launch.dryrun --arch llama3-405b --shape decode_32k --multi-pod
    python -m repro_torch.launch.dryrun --all            # every applicable cell

One JSON record per cell under ``results/dryrun_torch/`` (``--results``
names another directory; reruns skip existing files unless
``--force``). ``--save-hlo`` saves the counter's per-op table beside
it (``<cell>.ops.json``), where the reference saves its HLO text.

The mesh is the reference's production mesh on stand-in ranks
(:func:`repro_torch.launch.mesh.make_production_mesh`). Parameters,
optimizer state, caches and the batch are fake tensors
(``FakeTensorMode``, CPU device): nothing is allocated on any device,
and CUDA is never initialised. A record keeps every key of the
reference's:

- exact from the placements (:mod:`repro_torch.parallel.sharding`):
  ``memory_analysis.argument_size_in_bytes`` (one device's share of
  the parameters, optimizer state, caches and batch), its
  ``output_size_in_bytes`` and ``alias_size_in_bytes`` (the donated
  train carry or decode caches), ``bytes_per_device``,
  ``args_memory_s`` (argument bytes over one H100's HBM rate),
  ``params_total``, ``params_active``, ``tokens_per_step``,
  ``model_flops_*``;
- from the counter (:mod:`repro_torch.analysis.hlo`): ``hlo`` and
  ``roofline`` (:mod:`repro_torch.analysis.roofline`'s H100 terms),
  ``useful_flops_ratio``; ``lower_s`` is the seconds the counted run
  took;
- ``null``: what only a compiler gives (``generated_code_size_in_bytes``,
  ``temp_size_in_bytes``, ``xla_flops_1iter``, ``compile_s``).

A train cell counts one microbatch's gradients, times ``n_micro``, and
one AdamW update; a decode cell one step at position ``seq_len - 1``.
Attention is counted as the reference's program runs it
(``attention.REFERENCE_SCHEDULE``): a prompt through ``blockwise_attn``,
whose causal schedule is the full masked grid, or under ``tri`` the
triangle of block pairs at or below the diagonal. ``bf16attn`` (bf16
scores and probabilities), ``qc1024`` (query chunks of 1024) and
``tri`` set the reference's knobs, ``REPRO_ATTN_BF16``,
``REPRO_ATTN_QCHUNK`` and ``REPRO_ATTN_TRI``, as its ``build_cell``
does; :func:`run_cell` gives the caller's settings back after the cell.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.config import (ASSIGNED_ARCHS, SHAPES, ModelConfig,
                                ShapeConfig, get_config, shape_applicable)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.parallel import sharding as shd

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

VARIANTS = ("", "w8", "w4", "kvq8", "bf16attn", "micro4", "opt8",
            "qc1024", "tri")
# Hillclimb variants:
#   w8/w4     — weight-only int8/int4 serving quantization (decode)
#   kvq8      — fp8 KV-cache storage (decode)
#   micro4    — 4 grad-accum microbatches instead of the token rule
#   opt8      — int8-quantized AdamW moments (train memory)
#   bf16attn  — bf16 blockwise-attention scores (train/prefill)
#   qc1024    — 1024-query chunks in blockwise attention
#   tri       — blockwise attention over the causal triangle only
_KNOBS = (("bf16attn", "REPRO_ATTN_BF16", "1"),
          ("qc1024", "REPRO_ATTN_QCHUNK", "1024"),
          ("tri", "REPRO_ATTN_TRI", "1"))


def _set_knobs(variant: str) -> None:
    """The reference's ``build_cell``: each attention knob set for its
    variant and cleared for the others; and attention switched to the
    reference's program (``REFERENCE_SCHEDULE``)."""
    from repro_torch.models.lm import attention
    for name, var, value in _KNOBS:
        if variant == name:
            os.environ[var] = value
        else:
            os.environ.pop(var, None)
    attention.REFERENCE_SCHEDULE = True


@contextlib.contextmanager
def restored_knobs():
    """Gives back the attention knobs and schedule as they were."""
    from repro_torch.models.lm import attention
    env = {var: os.environ.get(var) for _, var, _ in _KNOBS}
    schedule = attention.REFERENCE_SCHEDULE
    try:
        yield
    finally:
        attention.REFERENCE_SCHEDULE = schedule
        for var, value in env.items():
            if value is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = value


def _params(cfg: ModelConfig, variant: str):
    gen = torch.Generator().manual_seed(0)
    if cfg.family == "basecaller":
        return api.init_params(gen, cfg)
    bits = {"w8": 8, "w4": 4}.get(variant, 0)
    return api.init_params(gen, cfg, device="cpu", wbits=bits)


def _train_like(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    return shape.kind == "train" or cfg.family == "basecaller"


def _cache_dtype(variant: str) -> torch.dtype:
    """The serving caches' storage: fp8 under ``kvq8``, else bf16."""
    return torch.float8_e4m3fn if variant == "kvq8" else torch.bfloat16


def _n_micro(cfg: ModelConfig, shape: ShapeConfig, mesh,
             variant: str = "") -> int:
    """Grad-accumulation microbatches of a train cell on ``mesh``."""
    dp = mesh.size() // shd.axis_sizes(mesh).get("model", 1)
    n = api.n_microbatches(cfg, shape.global_batch, shape.seq_len, dp=dp)
    return min(4, n) if variant == "micro4" else n


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               variant: str = "") -> dict:
    """The cell's arguments and outputs as fake tensors (call under
    ``FakeTensorMode``), with their shardings on ``mesh``: ``args`` and
    ``arg_shardings`` (trees of :class:`shd.Sharding`), ``donated``
    (indices of the arguments the step updates in place), ``outputs``
    and ``out_shardings``, and ``n_micro`` (train cells). A train cell's
    outputs come from one AdamW update on the cell's parameters, whose
    per-op table is ``update``; the others' are the logits and the
    caches the step returns. Sets the variant's attention knobs
    (:func:`_set_knobs`) for the count that follows."""
    from repro_torch.analysis import hlo
    from repro_torch.core.quant.policy import tree_map
    from repro_torch.models.lm import transformer as tfm
    from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                                init_opt_state)
    _set_knobs(variant)
    params = _params(cfg, variant)
    psh = shd.param_shardings(params, cfg, mesh)
    batch = api.batch_struct(cfg, shape, device="cpu")
    bsh = shd.shardings_like(
        batch, api.batch_specs(cfg, shape, tuple(mesh.mesh_dim_names)), mesh)
    like = functools.partial(shd.shardings_like, mesh=mesh)

    if _train_like(cfg, shape):
        opt_cfg = AdamWConfig(state_bits=8 if variant == "opt8" else 0)
        opt = init_opt_state(params, opt_cfg)
        mstate = api.init_model_state(cfg)
        carry = api.TrainCarry(params, opt, mstate)
        carry_sh = api.TrainCarry(
            psh, like(opt, shd.opt_state_specs(opt, params, cfg)),
            like(mstate, shd.replicated_specs(mstate)))
        grads = tree_map(lambda t: torch.zeros(t.shape), params)
        (newp, newo, om), update = hlo.count_ops(adamw_update, params, grads,
                                                 opt, opt_cfg)
        metrics = {"loss": torch.zeros(()), **om}
        outputs = (api.TrainCarry(newp, newo, mstate), metrics)
        out_sh = (carry_sh, like(metrics, shd.replicated_specs(metrics)))
        return {"args": (carry, batch), "arg_shardings": (carry_sh, bsh),
                "donated": (0,), "outputs": outputs,
                "out_shardings": out_sh, "update": update,
                "n_micro": _n_micro(cfg, shape, mesh, variant)}

    B, S = shape.global_batch, shape.seq_len
    dp_axes = tuple(a for a in mesh.mesh_dim_names if a != "model")
    logits = torch.empty((B, 1, cfg.vocab_size), dtype=getattr(torch,
                                                               cfg.dtype))
    lsh = like(logits, shd.Spec(dp_axes if B > 1 else None, None, None))
    caches = tfm.init_caches(cfg, B, S, cache_dtype=_cache_dtype(variant),
                             device="cpu")
    csh = like(caches, shd.cache_spec_tree(cfg))
    if shape.kind == "prefill":
        args, arg_sh, donated = (params, batch), (psh, bsh), ()
    else:
        args = (params, caches, batch["tokens"], batch["t"])
        arg_sh = (psh, csh, bsh["tokens"], bsh["t"])
        donated = (1,)
    return {"args": args, "arg_shardings": arg_sh, "donated": donated,
            "outputs": (logits, caches), "out_shardings": (lsh, csh),
            "update": {}, "n_micro": 1}


def _count(cfg: ModelConfig, shape: ShapeConfig, variant: str,
           n_micro: int) -> dict:
    """The per-op table of ``cfg``'s step (call under
    ``FakeTensorMode``): one microbatch's gradients times ``n_micro``
    (train), the prefill, or one decode step at ``seq_len - 1``."""
    from repro_torch.analysis import hlo
    from repro_torch.models.lm import transformer as tfm
    params = _params(cfg, variant)
    batch = api.batch_struct(cfg, shape, device="cpu")
    if _train_like(cfg, shape):
        mb = {k: v[: v.shape[0] // n_micro] for k, v in batch.items()}
        _, table = hlo.count_ops(api.microbatch_grads, api.make_loss_fn(cfg),
                                 params, api.init_model_state(cfg), mb, 1)
        return hlo.scale_table(table, n_micro)
    if shape.kind == "prefill":
        return hlo.count_ops(api.make_prefill_step(cfg), params, batch)[1]
    caches = tfm.init_caches(cfg, shape.global_batch, shape.seq_len,
                             cache_dtype=_cache_dtype(variant), device="cpu")
    return hlo.count_ops(api.make_decode_step(cfg), params, caches,
                         batch["tokens"], shape.seq_len - 1)[1]


def layer_cuts(cfg: ModelConfig):
    """Configs cut in depth whose counts give ``cfg``'s: every layer of
    one block kind counts the same, so a step's count is ``base +
    sum_k n_k * per_layer_k`` over the kinds' layer counts n_k, as the
    reference's HLO scales a scanned layer by its trip count. Returns
    (cut configs, their rows ``[1, n_k...]``, ``cfg``'s row): the
    shallowest cuts whose rows are independent (one per unknown). The
    basecaller family, which has no layer plan, is counted whole."""
    import numpy as np

    from repro_torch.models.lm import transformer as tfm
    if cfg.family == "basecaller":
        return [cfg], [[1]], [1]
    kinds = sorted({k for k, _ in tfm.layer_plan(cfg)})

    def row(c):
        n = dict.fromkeys(kinds, 0)
        for kind, m in tfm.layer_plan(c):
            if kind not in n:
                return None
            n[kind] += m
        return [1] + [n[k] for k in kinds]
    cuts, rows = [], []
    for L in range(1, 8):
        for nd in range(L + 1) if cfg.n_dense_layers else (0,):
            c = dataclasses.replace(cfg, n_layers=L, n_dense_layers=nd)
            r = row(c)
            if r is None or np.linalg.matrix_rank(
                    np.array(rows + [r], float)) == len(rows):
                continue
            cuts.append(c)
            rows.append(r)
            if len(rows) == len(kinds) + 1:
                return cuts, rows, row(cfg)
    raise ValueError(f"{cfg.name}: no independent layer cuts")


def count_step(cfg: ModelConfig, shape: ShapeConfig, *, variant: str = "",
               n_micro: int = 1):
    """``cfg``'s per-op table, solved from its :func:`layer_cuts`'
    counts (each cut counted under ``FakeTensorMode``). Returns (table,
    the cuts' ``(n_layers, n_dense_layers)``)."""
    import numpy as np
    from repro_torch.compat import FakeTensorMode
    cuts, rows, target = layer_cuts(cfg)
    tables = []
    for c in cuts:
        with FakeTensorMode():
            tables.append(_count(c, shape, variant, n_micro))
    # per op and key: solve rows @ coef = counts, then target @ coef
    w = np.linalg.solve(np.array(rows, float).T, np.array(target, float))
    names = sorted({n for t in tables for n in t})
    zero = {"calls": 0, "bytes": 0, "flops": 0}
    table = {n: {k: int(round(sum(wi * t.get(n, zero)[k]
                                  for wi, t in zip(w, tables))))
                 for k in zero} for n in names}
    return table, [(c.n_layers, c.n_dense_layers) for c in cuts]


def cell_collectives(cfg: ModelConfig, shape: ShapeConfig, sizes: dict,
                     leaves, n_micro: int) -> dict:
    """The per-device collective bytes of a cell's step
    (``hlo.collective_bytes``) on a mesh of axis ``sizes``, from its
    parameter ``leaves`` (:func:`_param_leaves`)."""
    from repro_torch.analysis import hlo
    dp = math.prod(s for a, s in sizes.items() if a != "model")
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    return hlo.collective_bytes(
        leaves, sizes, n_micro=n_micro, train=_train_like(cfg, shape),
        tokens=max(tokens // n_micro // dp, 1),
        frames=max(shape.global_batch // n_micro * cfg.frontend_tokens
                   // dp, 1),
        act_bytes=getattr(torch, cfg.dtype).itemsize,
        moe_slots=_moe_slots(cfg, shape, n_micro, dp))


def _moe_slots(cfg: ModelConfig, shape: ShapeConfig, n_micro: int,
               dp: int) -> float:
    """One MoE layer's dispatch slots on one data shard a microbatch
    (``hlo.moe_slots``): a batch row is a GShard group; a decode step
    folds its batch into one group (``moe.moe_ffn``)."""
    from repro_torch.analysis import hlo
    if not cfg.n_experts:
        return 0.0
    B = shape.global_batch
    groups, group_len = ((1, B) if shape.kind == "decode"
                         else (B // n_micro, shape.seq_len))
    return hlo.moe_slots(cfg.n_experts, cfg.experts_per_tok, groups,
                         group_len, dp)


def _param_leaves(params, psh):
    """(path, shape, itemsize, filtered spec) of every parameter."""
    paths, out = [], []
    shd._map_with_path(lambda p, _: paths.append(p), params)
    it = iter(paths)
    shd.zip_map(lambda t, sh: out.append((next(it), tuple(t.shape),
                                          t.element_size(), sh.spec)),
                params, psh)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             force: bool = False, save_hlo: bool = False,
             variant: str = "", results: Path = RESULTS) -> dict:
    from repro_torch.compat import FakeTensorMode

    from repro_torch.analysis import hlo
    from repro_torch.analysis.roofline import (HBM_BW, model_flops,
                                               roofline_terms)
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    if variant:
        tag += f"__{variant}"
    out_path = results / f"{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    results.mkdir(parents=True, exist_ok=True)
    if not shape_applicable(cfg, shape):
        rec = {"cell": tag, "skipped": "long_500k needs sub-quadratic attn "
               "(full-attention arch)"}
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    with restored_knobs():
        with FakeTensorMode():
            cell = build_cell(cfg, shape, mesh, variant=variant)
            args, ash = cell["args"], cell["arg_shardings"]
            arg_bytes = sum(shd.per_device_bytes(a, s)
                            for a, s in zip(args, ash))
            alias = sum(shd.per_device_bytes(args[i], ash[i])
                        for i in cell["donated"])
            out_bytes = shd.per_device_bytes(cell["outputs"],
                                             cell["out_shardings"])
            train = _train_like(cfg, shape)
            leaves = _param_leaves(args[0].params if train else args[0],
                                   ash[0].params if train else ash[0])
        n_micro = cell["n_micro"]
        t0 = time.time()
        table, cuts = count_step(cfg, shape, variant=variant,
                                 n_micro=n_micro)
        table = hlo.merge_tables(table, cell["update"])
        t_count = time.time() - t0

    sizes = shd.axis_sizes(mesh)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    coll = cell_collectives(cfg, shape, sizes, leaves, n_micro)
    rec_hlo = hlo.per_device(hlo.totals(table), n_chips, coll)
    terms = roofline_terms(
        rec_hlo, int8_frac=0.9 if variant in ("w8", "w4") else 0.0)
    n_active = api.active_params(cfg)
    mf = model_flops(n_active, tokens, shape.kind == "train")
    mem = {"generated_code_size_in_bytes": None,
           "argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "alias_size_in_bytes": alias,
           "temp_size_in_bytes": None}
    rec = {
        "cell": tag, "arch": arch, "shape": shape_name, "variant": variant,
        # decode is one pass over every live argument (weights + caches):
        # argument bytes over the HBM rate is the per-step traffic floor
        "args_memory_s": arg_bytes / HBM_BW,
        "n_chips": n_chips,
        "mesh": sizes,
        "params_total": api.count_params_analytic(cfg),
        "params_active": n_active,
        "tokens_per_step": tokens,
        "memory_analysis": mem,
        "bytes_per_device": arg_bytes + out_bytes - alias,
        "xla_flops_1iter": None,
        "hlo": rec_hlo,
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / rec_hlo["flops"]
        if rec_hlo["flops"] else None,
        "lower_s": round(t_count, 2), "compile_s": None,
        "counted_on": "cpu, FakeTensorMode (nothing allocated)",
        "layer_cuts": cuts,
        "cuda_initialized": torch.cuda.is_initialized(),
    }
    if train:
        rec["n_micro"] = n_micro
    out_path.write_text(json.dumps(rec, indent=1))
    if save_hlo:
        (results / f"{tag}.ops.json").write_text(json.dumps(
            dict(sorted(table.items(), key=lambda kv: -kv[1]["bytes"])),
            indent=1))
    return rec


def all_cells(include_paper: bool = True):
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            yield arch, shape
    if include_paper:
        yield "rubicall", "train_4k"   # the paper's own arch (bonus row)
        yield "bonito", "train_4k"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-hlo", action="store_true")
    ap.add_argument("--variant", default="", choices=VARIANTS)
    ap.add_argument("--results", default=str(RESULTS),
                    help="directory of the per-cell JSON records")
    args = ap.parse_args(argv)

    cells = ([(args.arch, args.shape, args.multi_pod)] if not args.all
             else [(a, s, mp) for (a, s) in all_cells()
                   for mp in (False, True)])
    failed = 0
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
        try:
            rec = run_cell(arch, shape, mp, force=args.force,
                           save_hlo=args.save_hlo, variant=args.variant,
                           results=Path(args.results))
            if "skipped" in rec:
                print(f"[skip] {tag}: {rec['skipped']}")
            else:
                r = rec["roofline"]
                print(f"[ok]   {tag}: compute {r['compute_s']*1e3:.2f}ms "
                      f"memory {r['memory_s']*1e3:.2f}ms "
                      f"coll {r['collective_s']*1e3:.2f}ms "
                      f"<- {r['bottleneck']}  args "
                      f"{rec['memory_analysis']['argument_size_in_bytes']} "
                      f"B/device (counted in {rec['lower_s']}s)")
        except Exception as e:          # one cell's fault ends no sweep
            failed += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
            traceback.print_exc()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
