"""AnalysisContext — what rules see when they run.

One context per analyzer invocation. It owns the three surfaces rules
check:

- ``ast_files()``: every ``*.py`` under ``src_root`` (default
  ``src/repro_torch``) as ``(relpath, source, tree)`` triples (AST
  rules).
- ``jaxpr_targets``: the recorded serving programs from
  :mod:`repro_torch.analysis.targets` (trace rules), recorded lazily on
  first access on the context's ``device`` and cached — AST-only runs
  never build a model or touch a device.
- ``trace_stability_setup()`` / ``stream_stability_setup()``: a live
  smoke :class:`TokenRunner` plus canned decode-only and mixed work
  lists, and a live read-until :class:`BasecallerRunner` plus one
  streaming window tick (the runtime load audit).

``device``: CUDA unless the caller asks for the CPU (``"cpu"``); without
a card, a run that needs targets or runners raises, as every entry
point of the port does. Tests inject their own surfaces: pass
``src_root``/``rel_prefix`` to lint a temp tree, or ``jaxpr_targets``
to feed seeded-violation programs through the registered rules.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import resolve_device


class AnalysisContext:
    def __init__(self, src_root: Optional[Path] = None,
                 rel_prefix: Optional[str] = None,
                 jaxpr_targets: Optional[Sequence[Any]] = None,
                 device=None):
        if src_root is None:
            src_root = Path(__file__).resolve().parents[1]  # src/repro_torch
            if rel_prefix is None:
                rel_prefix = "src/repro_torch/"
        self.src_root = Path(src_root)
        self.rel_prefix = rel_prefix or ""
        self.device = device
        self._jaxpr_targets = (list(jaxpr_targets)
                               if jaxpr_targets is not None else None)
        self._stability = None
        self._stream_stability = None

    # ----------------------------------------------------------- AST
    def py_files(self) -> List[Path]:
        return sorted(self.src_root.rglob("*.py"))

    def ast_files(self) -> Iterator[Tuple[str, str, ast.AST]]:
        """``(relpath, source, tree)`` per parseable source file."""
        for path in self.py_files():
            rel = (self.rel_prefix
                   + path.relative_to(self.src_root).as_posix())
            source = path.read_text()
            try:
                tree = ast.parse(source, filename=rel)
            except SyntaxError:
                continue        # not this analyzer's job; python will say
            yield rel, source, tree

    # -------------------------------------------------------- traces
    @property
    def jaxpr_targets(self) -> List[Any]:
        if self._jaxpr_targets is None:
            from repro_torch.analysis.targets import (
                attention_op_targets, basecaller_stream_targets,
                serving_step_targets)
            dev = resolve_device(self.device)
            self._jaxpr_targets = (serving_step_targets(device=dev)
                                   + attention_op_targets(device=dev)
                                   + basecaller_stream_targets(device=dev))
        return self._jaxpr_targets

    # ------------------------------------------------------- runtime
    def trace_stability_setup(self):
        """``(runner, works_decode, works_mixed)`` for the load audit: a
        qwen smoke runner on the ``cuda`` read path (the kernels on a
        card, whose libraries load at first launch) plus one fixed
        decode-only tick and one fixed mixed (prefill chunk + decode
        row) tick."""
        if self._stability is None:
            from repro_torch.analysis.targets import (_build_runner,
                                                      canned_works)
            runner = _build_runner("qwen1.5-4b-smoke", "cuda",
                                   device=resolve_device(self.device))
            self._stability = (runner, *canned_works(runner))
        return self._stability

    def stream_stability_setup(self):
        """``(runner, works_stream)`` for the streaming-tick load audit:
        a live read-until BasecallerRunner plus one fixed streaming
        window tick (a pre-finish cursor payload: UNBOUNDED read_len,
        classify armed)."""
        if self._stream_stability is None:
            from repro_torch.analysis.targets import _build_basecaller_runner
            from repro_torch.serving.runner import PrefillWork
            from repro_torch.serving.stream import UNBOUNDED, StreamingRequest
            runner = _build_basecaller_runner(
                read_until=True, device=resolve_device(self.device))
            req = StreamingRequest(rid=0)
            req.append(np.zeros((runner.core + 2 * runner.halo,),
                                np.float32))
            runner.admit(0, req)
            payload = (np.zeros((runner.core + 2 * runner.halo, 1),
                                np.float32), 0,
                       runner.core // runner.stride, -runner.halo,
                       UNBOUNDED, 1)
            works = [PrefillWork(payload, runner.core, 0, True, False,
                                 req), None]
            self._stream_stability = (runner, works)
        return self._stream_stability
