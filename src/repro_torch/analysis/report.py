"""Render the dry run's tables from its cell records (the port's
counterpart of ``repro.analysis.report``).

Usage: PYTHONPATH=src python -m repro_torch.analysis.report [--results DIR]

Reads every ``*.json`` record that ``python -m repro_torch.launch.dryrun``
wrote under ``results/dryrun_torch/`` (``--results`` names another
directory; the per-op tables ``*.ops.json`` that ``--save-hlo`` writes
beside them are not records and are left out) and prints two Markdown
tables: the baseline roofline of every cell, and each variant beside
its cell's baseline. The terms are the records' H100 roofline
(``analysis/roofline.py``); ``compile s`` is the record's
``compile_s``, null in the port's records (nothing is compiled).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/2**30:.1f}"


def load(results: Path = RESULTS):
    cells = {}
    for f in sorted(Path(results).glob("*.json")):
        if f.name.endswith(".ops.json"):
            continue
        cells[f.stem] = json.loads(f.read_text())
    return cells


def baseline_table(cells):
    print("| arch | shape | mesh | compute s | memory s | collective s |"
          " bound | bytes/dev GiB | useful-flops | compile s |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for key, r in cells.items():
        if key.count("__") > 2:
            continue                      # variants listed separately
        arch, shape, mesh = key.split("__")
        if "skipped" in r:
            print(f"| {arch} | {shape} | {mesh} | — | — | — | "
                  f"SKIP (full-attn) | — | — | — |")
            continue
        t = r["roofline"]
        uf = r.get("useful_flops_ratio")
        ufs = f"{uf:.3f}" if uf is not None else "-"
        print(f"| {arch} | {shape} | {mesh} | {t['compute_s']:.3f} | "
              f"{t['memory_s']:.3f} | {t['collective_s']:.3f} | "
              f"{t['bottleneck'].replace('_s','')} | "
              f"{fmt_bytes(r.get('bytes_per_device'))} | {ufs} | "
              f"{r.get('compile_s') or '-'} |")


def variant_table(cells):
    print("| cell | variant | compute s | memory s | collective s |"
          " args-bytes s | bound |")
    print("|---|---|---|---|---|---|---|")
    for key, r in cells.items():
        if "skipped" in r:
            continue
        parts = key.split("__")
        variant = parts[3] if len(parts) > 3 else "baseline"
        base = "__".join(parts[:3])
        if not any((k.count("__") > 2 and "__".join(
                k.split("__")[:3]) == base) for k in cells):
            continue
        t = r["roofline"]
        print(f"| {base} | {variant} | {t['compute_s']:.3f} | "
              f"{t['memory_s']:.3f} | {t['collective_s']:.3f} | "
              f"{r.get('args_memory_s', 0):.4f} | "
              f"{t['bottleneck'].replace('_s','')} |")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--results", default=str(RESULTS),
                    help="directory of the dry run's per-cell records")
    args = ap.parse_args(argv)
    cells = load(Path(args.results))
    print("## Baseline roofline table (single-pod 16x16 + multi-pod "
          "2x16x16)\n")
    baseline_table(cells)
    print("\n## Hillclimb variants\n")
    variant_table(cells)


if __name__ == "__main__":
    main()
