"""Fault-tolerant checkpointing, on the reference's on-disk layout.

- **Layout**: one ``.npy`` per leaf and a ``manifest.json`` holding each
  leaf's file, shape, dtype and crc32, under the reference's leaf keys
  (dict keys and list indices joined by '/', a NamedTuple field as
  ``.field``, ``None`` no leaf): a checkpoint the JAX package wrote
  restores here, and the other way round.
- **Atomic**: write to ``step_N.tmp/`` then ``os.rename`` — a crash
  mid-save never corrupts the latest valid checkpoint.
- **Verified**: ``latest_valid`` skips any checkpoint whose manifest,
  shapes or crc32 do not check out.
- **Async**: ``save_async`` snapshots to host tensors on the caller's
  thread (one sync) and writes on a background thread.
- **Bounded**: keeps the newest ``keep`` checkpoints.
- **Whole leaves**: the layout knows nothing of sharding. A
  tensor-parallel run gathers its shards into whole leaves before it
  writes (:meth:`CheckpointManager.save_flat_async` takes the gathered
  snapshot), and restores by reading whole leaves and slicing each
  rank's shard (``restore(shard=)``), so a checkpoint written at any
  model size, or by the reference, restores at any other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


def leaf_items(tree, prefix: str = ""):
    """(key, leaf) of every leaf under the reference's checkpoint keys,
    in its flattening order (dict keys sorted)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from leaf_items(getattr(tree, f), f"{prefix}.{f}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(like, fn, prefix: str = ""):
    """``like``'s structure with every leaf replaced by ``fn(key,
    leaf)``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, fn, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), fn, f"{prefix}.{f}/")
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, fn, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return fn(prefix[:-1], like)


def snapshot(tree) -> Dict[str, torch.Tensor]:
    """Host copies of every leaf: asynchronous device-to-host copies,
    then one wait for them all."""
    flat = {k: v.detach().to("cpu", non_blocking=True, copy=True)
            for k, v in leaf_items(tree)}
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return flat


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save -----------------------------------------------------------
    def save(self, step: int, tree: Any) -> Path:
        return self._write(step, snapshot(tree))

    def save_async(self, step: int, tree: Any) -> None:
        """Snapshot now, write in the background."""
        self.save_flat_async(step, snapshot(tree))

    def save_flat_async(self, step: int,
                        flat: Dict[str, torch.Tensor]) -> None:
        """Write a :func:`snapshot` (``{key: host tensor}``) in the
        background."""
        self.wait()
        self._thread = threading.Thread(target=self._write,
                                        args=(step, flat), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, torch.Tensor]) -> Path:
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {}
        for key, t in flat.items():
            arr = t.numpy()
            fname = key.replace("/", "__") + ".npy"
            np.save(tmp / fname, arr)
            manifest[key] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            }
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "leaves": manifest}))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        ckpts = [c for c in sorted(self.dir.glob("step_*"))
                 if not c.name.endswith(".tmp")]
        for old in ckpts[: max(0, len(ckpts) - self.keep)]:
            shutil.rmtree(old)

    # -- restore ---------------------------------------------------------
    def _validate(self, path: Path) -> bool:
        mf = path / "manifest.json"
        if not mf.exists():
            return False
        try:
            manifest = json.loads(mf.read_text())
            for meta in manifest["leaves"].values():
                arr = np.load(path / meta["file"])
                if list(arr.shape) != meta["shape"]:
                    return False
                if zlib.crc32(np.ascontiguousarray(arr).tobytes()) \
                        != meta["crc32"]:
                    return False
            return True
        except (OSError, ValueError, KeyError, EOFError):
            return False

    def latest_valid(self) -> Optional[Tuple[int, Path]]:
        for path in sorted(self.dir.glob("step_*"), reverse=True):
            if path.name.endswith(".tmp"):
                continue
            if self._validate(path):
                return int(path.name.split("_")[1]), path
        return None

    def restore(self, like_tree: Any, path: Optional[Path] = None, *,
                shard: Optional[Callable[[str, torch.Tensor],
                                         torch.Tensor]] = None
                ) -> Tuple[int, Any]:
        """Restore into the structure of ``like_tree``, each leaf on the
        device of the leaf it replaces. Returns (step, tree).
        ``shard(key, whole leaf)``: the part of each whole leaf this
        rank keeps (a tensor-parallel rank's shard)."""
        if path is None:
            latest = self.latest_valid()
            if latest is None:
                raise FileNotFoundError(f"no valid checkpoint in {self.dir}")
            path = latest[1]
        meta = json.loads((path / "manifest.json").read_text())
        leaves = meta["leaves"]

        def load(key, like):
            t = torch.from_numpy(np.load(path / leaves[key]["file"]))
            if shard is not None:
                t = shard(key, t)
            return t.to(like.device)
        return meta["step"], _rebuild(like_tree, load)
