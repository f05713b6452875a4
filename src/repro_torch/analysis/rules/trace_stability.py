"""Rule ``trace-stability``: serving the same tick shape bucket twice
must compile nothing.

Front-runs the "no mid-traffic compiles" hardening item. The reference
counts jit-cache entries: a tick that RETRACES silently turns a
microsecond dispatch into a multi-second compile, mid-traffic. The
port's counterpart of a compiled tick is a tick plan captured as a CUDA
graph at ``warmup()`` (``serving/plan.py``), and a warmed plan captured
again is its retrace (``PlanCache.stats()["retraces"]``); its other
compile is the ``nvcc`` build and the ctypes load of a kernel's library
at its first launch (``kernels/_build.py``, counted in
``_build.COUNTS``). So the port's audit runs over the real runners:
after ``warmup()``, tick one fixed decode-only bucket and one fixed
mixed bucket twice each and assert that

- nothing was built or loaded (the reference's "the cache did not
  grow"): ``TokenRunner.warmup`` runs all-pad ticks (``t = -1``), and
  a kernel those ticks do not launch would first load in the middle of
  traffic;
- each repeat launched the same kernels on the same routes
  (``ops.launch_counts(routes=True)``; the reference's "fanout": one
  bucket, one program);
- no plan was staged or captured again (``retraces`` stayed 0).

On the CPU nothing builds, loads or launches, so the audit reports
nothing, as the reference's does on a build without the cache counter.
The bucket-coverage audit closes the loop from the other side: every
tick shape the ENGINE SCHEDULER can emit (decode-only plus every mixed
chunk width 1..prefill_chunk, greedy and sampled) must round to a
registered plan bucket — a width that escapes the bucket set is exactly
the shape that ``--warmup`` would not have pre-paid.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import rule
from repro_torch.kernels import _build, ops


def _launch_delta(before: Dict, after: Dict) -> Dict:
    return {k: {r: n - before[k][r] for r, n in by.items()
                if n != before[k][r]}
            for k, by in after.items()
            if any(n != before[k][r] for r, n in by.items())}


def audit_program(name: str, call: Callable[[], None],
                  warm: Optional[Callable[[], None]] = None,
                  repeats: int = 2) -> List[Finding]:
    """Load audit: ``warm()`` (by default one ``call()``) pre-pays;
    then ``call()``, which drives one fixed shape bucket, runs
    ``repeats`` times and must build or load nothing and launch the
    same kernels on the same routes each time."""
    (warm or call)()
    before = dict(_build.COUNTS)
    launched = []
    for _ in range(repeats):
        pre = ops.launch_counts(routes=True)
        call()
        launched.append(_launch_delta(pre, ops.launch_counts(routes=True)))
    after = dict(_build.COUNTS)
    findings: List[Finding] = []
    if after != before:
        grew = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        findings.append(Finding(
            "trace-stability", f"{name}::load",
            f"kernel libraries built/loaded after warmup, on an identical "
            f"shape bucket: {grew} across {repeats} calls (a kernel the "
            f"warmup ticks never launched first loads mid-traffic)"))
    if any(d != launched[0] for d in launched[1:]):
        findings.append(Finding(
            "trace-stability", f"{name}::fanout",
            f"one shape bucket launched different kernels or routes on "
            f"repeat: {launched}"))
    return findings


def bucket_coverage(runner, label: str) -> List[Finding]:
    """Schedulable-shape closure: every (kind, width, flavor) the engine
    scheduler can hand this runner rounds to a registered plan bucket,
    so ``warmup()`` genuinely pre-pays every first launch."""
    from repro_torch.serving.plan import round_chunk
    findings: List[Finding] = []
    for flavor in ("greedy", "sampled"):
        if ("decode", 1, flavor) not in runner.plans:
            findings.append(Finding(
                "trace-stability", f"{label}::bucket-coverage",
                f"no ('decode', 1, {flavor!r}) plan — the lockstep "
                f"decode tick would run unwarmed mid-traffic"))
        for n in range(1, runner.chunk_tokens + 1):
            try:
                b = round_chunk(n, runner.buckets)
            except ValueError:
                findings.append(Finding(
                    "trace-stability", f"{label}::bucket-coverage",
                    f"mixed chunk width {n} does not round to any "
                    f"bucket in {runner.buckets} — the scheduler can "
                    f"emit a shape outside the warmed plan set"))
                continue
            if ("mixed", b, flavor) not in runner.plans:
                findings.append(Finding(
                    "trace-stability", f"{label}::bucket-coverage",
                    f"mixed width {n} rounds to bucket {b} but no "
                    f"('mixed', {b}, {flavor!r}) plan is registered"))
    return findings + plan_retraces(runner, label)


def plan_retraces(runner, label: str) -> List[Finding]:
    """A warmed plan staged again (on a card: its CUDA graph captured
    again) is a retrace, as a recompile is in the reference."""
    stats = runner.plans.stats()
    if not stats["retraces"]:
        return []
    return [Finding(
        "trace-stability", f"{label}::plan-retrace",
        f"{stats['retraces']} plan-cache retrace(s): a warmed plan was "
        f"staged and captured again mid-traffic ({stats['graphs']} "
        f"graphs)")]


def audit_token_runner(runner, works_decode, works_mixed,
                       label: str) -> List[Finding]:
    """The load audit of a live :class:`TokenRunner` on its canned
    decode-only and mixed ticks, then its bucket coverage."""
    findings = audit_program(f"TokenRunner.decode[{label}]",
                             lambda: runner.step(works_decode),
                             warm=runner.warmup)
    findings += audit_program(f"TokenRunner.mixed[{label}]",
                              lambda: runner.step(works_mixed),
                              warm=runner.warmup)
    return findings + bucket_coverage(runner, f"TokenRunner[{label}]")


@rule("trace-stability", "runtime",
      "ticking the same shape bucket twice after warmup builds or loads "
      "no kernel and launches the same kernels on the same routes (load "
      "audit over the real TokenRunner + streaming-basecaller ticks) and "
      "every schedulable tick shape rounds to a registered plan bucket")
def check(ctx) -> List[Finding]:
    runner, works_decode, works_mixed = ctx.trace_stability_setup()
    findings = audit_token_runner(runner, works_decode, works_mixed,
                                  "qwen1.5-4b-smoke")
    # streaming tick: live-window forward + fused read-until classifier
    # (pre-finish payloads vary only in VALUES — UNBOUNDED read_len,
    # window content — never in shape, so repeats must load nothing)
    bc_runner, works_stream = ctx.stream_stability_setup()
    label = "BasecallerRunner.window[bonito-smoke/stream/read_until]"
    findings += audit_program(label, lambda: bc_runner.step(works_stream),
                              warm=bc_runner.warmup)
    return findings + plan_retraces(bc_runner, label)
