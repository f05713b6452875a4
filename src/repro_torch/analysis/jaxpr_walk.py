"""Recorded op traces — the port's stand-in for the reference's jaxprs,
and ONE walker over them.

The reference walks the jaxpr of each traced serving program, recursing
into the sub-jaxprs of ``pjit``, ``scan`` and ``pallas_call``. The port
compiles no tick program: it runs each one eagerly. So a program is
recorded by running it once under :class:`Recorder`, a
``TorchDispatchMode`` (as ``analysis/hlo.py`` counts the dry run's
ops), and every aten op becomes one :class:`Op` with:

- its name (the aten overload packet: ``index``, ``mm``, ``_to_copy``);
- the shapes and dtypes of its tensor inputs and outputs, and an
  identity for each tensor, so that an op's consumers can be found;
- its ``path``: the plain versions of kernels it runs inside, read from
  the Python stack (a frame of a public function in ``kernels/ref.py``:
  ``("gqa_paged_ref",)``) — the counterpart of an op inside a
  ``pallas_call`` body;
- its provenance: the innermost ``src/repro_torch`` frame's
  ``file:line``, the counterpart of a jaxpr equation's source info.

Composite ops that inference mode would hand the mode whole (``to``,
``matmul``, ``reshape``, ``einsum``) are decomposed under the mode, so
the trace holds the aten ops that actually run (``_to_copy``, ``mm``,
``view``, ``bmm``), whatever grad mode the program enters.

A hand-written kernel launches through ctypes, which the dispatcher
never sees: each launch is recorded as a site of its own, ``kernel:<name>``
with its route, through the launch counter's hook
(``kernels/_build.ON_LAUNCH``, None when nothing records).

A recorded trace is flat: an op's nesting is its ``path``, so
:func:`sub_jaxprs` yields nothing and :func:`iter_eqns` is one pass.
The public names are the reference walker's.
"""
from __future__ import annotations

import dataclasses
import itertools
import sys
from pathlib import Path
from typing import Any, Dict, Iterator, List, NamedTuple, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import _build

_PKG = Path(__file__).resolve().parents[1]            # src/repro_torch
_REF = _PKG / "kernels" / "ref.py"
_SKIP = (_PKG / "analysis", _PKG / "kernels" / "_build.py")
_CIA = torch._C.DispatchKey.CompositeImplicitAutograd

# the op kinds rules match on (aten overload packets)
GATHER_OPS = ("index", "index_select", "gather", "take", "embedding")


@dataclasses.dataclass(frozen=True)
class Op:
    """One recorded aten op or kernel launch (a jaxpr equation's
    counterpart)."""
    name: str                           # "index", "mm", "kernel:gqa_paged"
    in_shapes: Tuple[Tuple[int, ...], ...]
    in_dtypes: Tuple[torch.dtype, ...]
    in_ids: Tuple[int, ...]
    out_shapes: Tuple[Tuple[int, ...], ...]
    out_dtypes: Tuple[torch.dtype, ...]
    out_ids: Tuple[int, ...]
    path: Tuple[str, ...]               # enclosing plain versions
    source: str                         # "src/repro_torch/...py:LINE"
    route: str = ""                     # a kernel launch's route

    def out_numel(self, i: int = 0) -> int:
        n = 1
        for d in self.out_shapes[i]:
            n *= d
        return n


@dataclasses.dataclass
class OpTrace:
    """The ops of one recorded run, in execution order."""
    ops: List[Op] = dataclasses.field(default_factory=list)

    def launches(self) -> Dict[str, Dict[str, int]]:
        """Kernel launches recorded, ``{kernel: {route: n}}``."""
        out: Dict[str, Dict[str, int]] = {}
        for op in self.ops:
            if op.name.startswith("kernel:"):
                by = out.setdefault(op.name[len("kernel:"):], {})
                by[op.route] = by.get(op.route, 0) + 1
        return out


class EqnSite(NamedTuple):
    """One op + the plain-version path that encloses it (e.g.
    ``("gqa_paged_chunk_ref",)`` for a gather inside that plain
    version)."""
    eqn: Op
    path: Tuple[str, ...]

    @property
    def path_str(self) -> str:
        return "/".join(self.path + (self.eqn.name,))


class _Frames:
    """Classifies code objects once: a plain version's name, and the
    ``src/repro_torch`` file of a frame outside this package."""

    def __init__(self):
        self._code: Dict[Any, Tuple[str, str]] = {}

    def of(self, code) -> Tuple[str, str]:
        hit = self._code.get(code)
        if hit is None:
            path = Path(code.co_filename)
            plain = (code.co_name if path == _REF
                     and not code.co_name.startswith("_") else "")
            try:
                rel = path.relative_to(_PKG)
                src = ("" if any(path.is_relative_to(p) for p in _SKIP)
                       else f"src/repro_torch/{rel.as_posix()}")
            except ValueError:
                src = ""
            hit = self._code[code] = (plain, src)
        return hit

    def site(self) -> Tuple[Tuple[str, ...], str]:
        """(plain-version path, outermost first; innermost port
        ``file:line``) of the running Python stack."""
        path: List[str] = []
        source = ""
        f = sys._getframe(2)
        while f is not None:
            plain, src = self.of(f.f_code)
            if plain:
                path.append(plain)
            if src and not source:
                source = f"{src}:{f.f_lineno}"
            f = f.f_back
        return tuple(reversed(path)), source


class Recorder(TorchDispatchMode):
    """Record every aten op (and, through ``_build.ON_LAUNCH``, every
    kernel launch) run inside ``with Recorder() as rec:`` into
    ``rec.trace``."""

    def __init__(self):
        super().__init__()
        self.trace = OpTrace()
        self._ids = WeakIdKeyDictionary()
        self._next = itertools.count()
        self._frames = _Frames()
        self._hooks: List[Any] = []

    def _id(self, t: torch.Tensor) -> int:
        i = self._ids.get(t)
        if i is None:
            i = self._ids[t] = next(self._next)
        return i

    def _tensors(self, tree) -> List[torch.Tensor]:
        return [t for t in tree_flatten(tree)[0]
                if isinstance(t, torch.Tensor)]

    def __enter__(self):
        # re-entered while decomposing: a stack, so the outermost exit
        # puts back whatever hook was there before
        self._hooks.append(_build.ON_LAUNCH)
        _build.ON_LAUNCH = self._launch
        return super().__enter__()

    def __exit__(self, *exc):
        _build.ON_LAUNCH = self._hooks.pop()
        return super().__exit__(*exc)

    def _launch(self, kernel: str, route: str) -> None:
        path, source = self._frames.site()
        self.trace.ops.append(Op(f"kernel:{kernel}", (), (), (), (), (), (),
                                 path, source, route))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), _CIA):
            # inference mode hands composites over whole: record the
            # aten ops they run instead
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out
        ins = self._tensors((args, kwargs))
        outs = self._tensors(out)
        path, source = self._frames.site()
        self.trace.ops.append(Op(
            func.overloadpacket.__name__,
            tuple(tuple(t.shape) for t in ins), tuple(t.dtype for t in ins),
            tuple(self._id(t) for t in ins),
            tuple(tuple(t.shape) for t in outs),
            tuple(t.dtype for t in outs), tuple(self._id(t) for t in outs),
            path, source))
        return out


def record(fn, *args, **kwargs) -> Tuple[Any, OpTrace]:
    """Run ``fn(*args, **kwargs)`` once under a :class:`Recorder`;
    returns (its result, the trace)."""
    with Recorder() as rec:
        out = fn(*args, **kwargs)
    return out, rec.trace


def sub_jaxprs(eqn: Op) -> Iterator[Any]:
    """Nothing: a recorded trace is flat, an op's nesting is its path."""
    return iter(())


def iter_eqns(trace: OpTrace) -> Iterator[EqnSite]:
    """Every recorded op, in execution order, with its path."""
    for op in trace.ops:
        yield EqnSite(op, op.path)


def find_eqns(trace: OpTrace, names: Sequence[str]) -> List[EqnSite]:
    """All ops whose name is in ``names``."""
    names = set(names)
    return [s for s in iter_eqns(trace) if s.eqn.name in names]


def gather_sizes(trace: OpTrace) -> List[int]:
    """Output sizes of every gather-kind op (``index``, ``index_select``,
    ``gather``, ``take``, ``embedding``) anywhere in the program — the
    quantity the no-materialization gates compare against the paged
    logical-view size."""
    return [site.eqn.out_numel(i) for site in iter_eqns(trace)
            if site.eqn.name in GATHER_OPS
            for i in range(len(site.eqn.out_shapes))]


def eqn_provenance(eqn: Op) -> str:
    """The op's ``file:line`` in ``src/repro_torch`` (empty when no port
    frame ran it)."""
    return eqn.source
