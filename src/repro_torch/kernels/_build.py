"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/lib<name>-<hash>.so`` at the repository root, the hash
covering the source and the flags, so an edited source rebuilds and an
unchanged one loads from the last build. Nothing here runs at import:
the first kernel call (or :func:`build_all`) compiles.

The port's "compile" is this module's work: ``COUNTS`` keeps the
sources built and the libraries loaded, so a load audit can tell a
kernel whose library first loads in the middle of traffic. Every
wrapper counts its launches through :func:`count_launch`, which also
tells the analyzer's recorder (``ON_LAUNCH``), when one is recording.
While a tick plan's CUDA graph is captured (:func:`tally`) nothing
launches yet: the capture's launches go to its tally, and each replay
adds that tally to the counters (:func:`replay_launches`), so a graphed
tick counts what the same tick counts eagerly.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
LOGS: Dict[str, str] = {}            # nvcc output per source (ptxas -v)
COUNTS: Dict[str, int] = {"builds": 0, "loads": 0}
# (kernel, route) -> None: the analyzer's recorder while it records
ON_LAUNCH: Optional[Callable[[str, str], None]] = None


# (wrapper, kernel, route) -> launches, while a CUDA graph captures
Tally = Dict[Tuple[Callable, str, str], int]
_TALLY: Optional[Tally] = None


def _count(wrapper: Callable, kernel: str, route: str, n: int) -> None:
    wrapper.launches += n
    wrapper.routes[route] += n
    if ON_LAUNCH is not None:
        for _ in range(n):
            ON_LAUNCH(kernel, route)


def count_launch(wrapper: Callable, kernel: str, route: str) -> None:
    """One launch of ``kernel`` on ``route``: the wrapper's ``.launches``
    and ``.routes[route]`` counts, and the recorder's site, if any; or,
    inside :func:`tally`, one launch in the capture's tally."""
    if _TALLY is not None:
        key = (wrapper, kernel, route)
        _TALLY[key] = _TALLY.get(key, 0) + 1
        return
    _count(wrapper, kernel, route, 1)


@contextlib.contextmanager
def tally() -> Iterator[Tally]:
    """Launches counted inside go to the yielded tally, not to the
    counters: a CUDA graph's capture records launches without running
    them."""
    global _TALLY
    prev, _TALLY = _TALLY, {}
    try:
        yield _TALLY
    finally:
        _TALLY = prev


def replay_launches(launched: Tally) -> None:
    """A replay of a captured graph: its tally's launches, counted."""
    for (wrapper, kernel, route), n in launched.items():
        _count(wrapper, kernel, route, n)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{h}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    out = _target(name)
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path,
            proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Optional[List[str]] = None) -> List[str]:
    """Compile every (or the named) source not built yet, one ``nvcc``
    per source, all started together; returns the names compiled."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not _target(n).exists()]
    running = [(n, *_start(n)) for n in todo]
    for n, out, tmp, proc in running:
        _finish(n, out, tmp, proc)
    COUNTS["builds"] += len(todo)
    return todo


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
        COUNTS["loads"] += 1
    return lib
