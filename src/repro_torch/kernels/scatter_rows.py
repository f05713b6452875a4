"""Row scatter with dropped writes: the hand-written CUDA kernel
(``csrc/scatter_rows.cu``) behind a checked wrapper.

``dst[i0[w], i1[w]] = src[w]`` for every write ``w``, except that a
write whose ``i0`` or ``i1`` falls outside ``dst``'s first two dims is
dropped: the reference's ``.at[i0, i1].set(v, mode="drop")``, with which
it writes a tick's KV, int8 scales and positions at fixed shapes
(``repro/models/lm/attention.py``, ``mla.py``). The paged index math
(:func:`repro_torch.kernels.paged_attention.paged_indices`) marks a pad
token or an unassigned block with ``wblk == n_blocks`` and its position
column with ``lw == Leff``, so the number of writes is the tick's
``B * C`` whatever the tick holds, and nothing is filtered on the host.

A row is raw bytes: one kernel serves every arena dtype. On a CPU tensor
:func:`scatter_rows` runs the plain version,
:func:`repro_torch.kernels.ref.scatter_rows_ref` (the in-range writes
filtered, then one ``index_put_``). A port-only kernel: the TPU
reference's scatter is XLA's, inside its jitted step.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

ROUTES = ("tensor_core", "cuda_core")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("scatter_rows")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.scatter_rows_launch.argtypes = ([vp] * 4 + [ctypes.c_int]
                                        + [i64] * 3 + [vp])
    lib.scatter_rows_launch.restype = ctypes.c_int
    return lib


def _check(name: str, a: torch.Tensor, dst: torch.Tensor) -> None:
    if a.device != dst.device:
        raise ValueError(f"scatter_rows: {name} is on {a.device}, dst on "
                         f"{dst.device}")
    if not a.is_contiguous():
        raise ValueError(f"scatter_rows: {name} must be contiguous")


def scatter_rows_cuda(dst: torch.Tensor, i0: torch.Tensor, i1: torch.Tensor,
                      src: torch.Tensor) -> None:
    """In place on ``dst`` (n0, n1, ...), contiguous on the card: row
    ``(i0[w], i1[w])`` takes ``src[w]`` (``src`` (n, ...) of dst's dtype
    and row shape; ``i0``/``i1`` (n,) int64), out-of-range writes
    dropped. Launches on the current stream without synchronising;
    counts one launch in ``.launches`` and one on ``cuda_core`` in
    ``.routes`` (a byte copy: no tensor-core work)."""
    if not dst.is_cuda:
        raise ValueError("scatter_rows_cuda needs a CUDA tensor")
    if dst.ndim < 2:
        raise ValueError("scatter_rows: dst needs two index dims")
    n = i0.numel()
    row = tuple(dst.shape[2:])
    if src.dtype != dst.dtype or tuple(src.shape) != (n, *row):
        raise ValueError(f"scatter_rows: src must be {(n, *row)} "
                         f"{dst.dtype}, got {tuple(src.shape)} {src.dtype}")
    for name, idx in (("i0", i0), ("i1", i1)):
        if idx.dtype != torch.int64 or idx.numel() != n:
            raise ValueError(f"scatter_rows: {name} must be ({n},) int64")
        _check(name, idx, dst)
    _check("dst", dst, dst)
    _check("src", src, dst)
    row_bytes = src.element_size() * max(1, src[0].numel()) if n else 0
    with torch.cuda.device(dst.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().scatter_rows_launch(
            dst.data_ptr(), src.data_ptr(), i0.data_ptr(), i1.data_ptr(), n,
            dst.shape[0], dst.shape[1], row_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"scatter_rows launch failed: CUDA error {rc}")
    if n:
        _build.count_launch(scatter_rows_cuda, "scatter_rows", "cuda_core")


scatter_rows_cuda.launches = 0
scatter_rows_cuda.routes = dict.fromkeys(ROUTES, 0)
