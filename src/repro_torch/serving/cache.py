"""Paged block-granular KV pool for the continuous-batching engine (the
port's counterpart of ``repro.serving.cache``).

Per layer group, K/V bytes live in a shared block arena on the device
(``(n_layers, n_blocks, block_len, Hkv, hd)`` leaves) and a host block
table per group (``(n_slots, T)`` int32, -1 = free) maps each slot's
logical block j to an arena block. Allocation is host bookkeeping (a
LIFO free list per group, all-or-nothing ``alloc``); positions stay
per slot (``pos: (n_layers, n_slots, T * block_len)``), so a recycled
block keeps its bytes but stays masked until its new owner writes it.

``CacheQuantPolicy`` sets each group's storage: ``bf16`` | ``fp8``
(``torch.float8_e4m3fn``) | ``int8`` (+ fp32 scale arenas written at
the same indices as their bytes) | ``fp16`` | ``fp32``. Every mode is
stored as asked; there is no fallback. ``nbytes`` counts every leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.ops import resolve_attn_backend
from repro_torch.kernels.paged_attention import EMPTY_POS
from repro_torch.models.lm import transformer as tfm

DEFAULT_BLOCK_LEN = 16

CACHE_MODES = ("bf16", "fp8", "int8", "fp16", "fp32")
_MODE_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
                "fp32": torch.float32, "int8": torch.int8,
                "fp8": torch.float8_e4m3fn}


def _dtype_mode(dtype) -> str:
    """Mode name of a storage dtype (reports, the legacy kwarg)."""
    for mode, dt in _MODE_DTYPES.items():
        if dt == dtype:
            return mode
    raise ValueError(f"no cache mode stores {dtype}")


@dataclasses.dataclass(frozen=True)
class CacheQuantPolicy:
    """Per-layer-group cache storage: ``default`` mode plus ``(group,
    mode)`` overrides. ``parse`` takes the CLI grammar: a bare mode
    (``"int8"``) or ``"g0_dense=int8,default=bf16"``."""
    default: str = "bf16"
    overrides: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        for mode in (self.default,) + tuple(m for _, m in self.overrides):
            if mode not in CACHE_MODES:
                raise ValueError(
                    f"unknown cache mode {mode!r}; choose from {CACHE_MODES}")

    @classmethod
    def parse(cls, spec) -> "CacheQuantPolicy":
        if isinstance(spec, CacheQuantPolicy):
            return spec
        if spec is None:
            return cls()
        if not isinstance(spec, str):        # a raw dtype (legacy kwarg)
            return cls(_dtype_mode(spec))
        default, overrides = None, []
        for seg in filter(None, (s.strip() for s in spec.split(","))):
            if "=" in seg:
                g, _, m = seg.partition("=")
                g, m = g.strip(), m.strip()
                if g == "default":
                    default = m
                else:
                    overrides.append((g, m))
            elif default is None:
                default = seg
            else:
                raise ValueError(
                    f"quant policy {spec!r}: more than one default mode")
        return cls(default or "bf16", tuple(overrides))

    def mode_for(self, group: str) -> str:
        return dict(self.overrides).get(group, self.default)

    def dtype_for(self, group: str) -> torch.dtype:
        return _MODE_DTYPES[self.mode_for(group)]

    def validate_groups(self, groups) -> None:
        """Reject overrides naming groups the model does not have."""
        unknown = [g for g, _ in self.overrides if g not in groups]
        if unknown:
            raise ValueError(
                f"quant policy names unknown layer groups {unknown}; "
                f"this model has {sorted(groups)}")

    def describe(self) -> str:
        return ",".join([self.default]
                        + [f"{g}={m}" for g, m in self.overrides])


class CachePool:
    """Device-resident paged pool + host block allocator.

    n_slots : decode batch rows. cache_len : per-request logical
    capacity. block_len : positions per arena block. n_blocks : arena
    blocks per group (0 = every slot fully backed; capped there).
    attn_backend : ``auto``/``gather``/``cuda``, resolved once here for
    ``device``. quant_policy : a :class:`CacheQuantPolicy` or its string
    (None: the uniform ``cache_dtype``).
    """

    def __init__(self, cfg: ModelConfig, n_slots: int, cache_len: int,
                 cache_dtype=torch.bfloat16, block_len: int = 0,
                 n_blocks: int = 0, attn_backend: str = "auto",
                 quant_policy=None, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.attn_backend = resolve_attn_backend(attn_backend, self.device)
        self.n_slots = int(n_slots)
        self.cache_len = int(cache_len)
        self.block_len = int(block_len) or min(DEFAULT_BLOCK_LEN, cache_len)
        self.layout: Dict[str, int] = tfm.paged_group_layout(
            cfg, cache_len, self.block_len)
        self.n_blocks: Dict[str, int] = {
            g: min(int(n_blocks) or self.n_slots * T, self.n_slots * T)
            for g, T in self.layout.items()}
        policy = CacheQuantPolicy.parse(
            quant_policy if quant_policy is not None else cache_dtype)
        all_groups = [g for g, _, _ in tfm.group_names(cfg)]
        policy.validate_groups(all_groups)
        self.quant_policy = policy
        self.group_dtypes: Dict[str, torch.dtype] = {
            g: policy.dtype_for(g) for g in all_groups}
        self.caches: Dict[str, Any] = tfm.init_caches_paged(
            cfg, self.n_slots, cache_len, self.n_blocks, self.block_len,
            cache_dtype=self.group_dtypes, device=self.device)
        self.reset_spec = tfm.caches_reset_specs(cfg, self.group_dtypes)
        self.slot_axes = tfm.caches_slot_axes(cfg, self.group_dtypes)
        self.tables: Dict[str, np.ndarray] = {
            g: np.full((self.n_slots, T), -1, np.int32)
            for g, T in self.layout.items()}
        self.free: Dict[str, List[int]] = {
            g: list(range(nb)) for g, nb in self.n_blocks.items()}
        self.alloc_count = 0            # lifetime block grants
        self._dev_tables = None

    # ------------------------------------------------------- allocator
    def blocks_for(self, n_positions: int) -> Dict[str, int]:
        bl = self.block_len
        return {g: min(-(-max(n_positions, 0) // bl), T)
                for g, T in self.layout.items()}

    def fits(self, n_positions: int) -> bool:
        """Could a request writing ``n_positions`` ever be served?"""
        need = self.blocks_for(n_positions)
        return all(need[g] <= self.n_blocks[g] for g in need)

    def alloc(self, slot: int, upto: int) -> bool:
        """Back logical positions ``[0, upto)`` of ``slot``; all or
        nothing (False leaves the pool untouched)."""
        need = self.blocks_for(upto)
        missing: Dict[str, List[int]] = {}
        for g, j_max in need.items():
            tab = self.tables[g]
            miss = [j for j in range(j_max) if tab[slot, j] < 0]
            if len(miss) > len(self.free[g]):
                return False
            missing[g] = miss
        for g, miss in missing.items():
            for j in miss:
                self.tables[g][slot, j] = self.free[g].pop()
                self.alloc_count += 1
                self._dev_tables = None
        return True

    def release_slot(self, slot: int) -> None:
        """Return every block of ``slot`` to the free lists."""
        for g, tab in self.tables.items():
            owned = tab[slot][tab[slot] >= 0]
            if owned.size:
                self.free[g].extend(int(b) for b in owned)
                tab[slot] = -1
                self._dev_tables = None

    def host_tables(self) -> Dict[str, torch.Tensor]:
        """The block tables as CPU tensors (views of the host arrays)."""
        return {g: torch.from_numpy(t) for g, t in self.tables.items()}

    def device_tables(self) -> Dict[str, torch.Tensor]:
        """Block tables on the pool's device (cached until they change)."""
        if self._dev_tables is None:
            self._dev_tables = {g: torch.from_numpy(t.copy()).to(self.device)
                                for g, t in self.tables.items()}
        return self._dev_tables

    def block_stats(self) -> Dict[str, float]:
        total = sum(self.n_blocks.values())
        used = total - sum(len(f) for f in self.free.values())
        return {"blocks_used": used, "blocks_total": total,
                "util": used / total if total else 0.0}

    # ------------------------------------------------------ device ops
    def mask_fresh_rows(self, caches: Dict[str, Any],
                        fresh: torch.Tensor) -> None:
        """In place: every slot with ``fresh > 0`` takes its spec'd reset
        value on every resettable leaf (positions -> empty); arena
        bytes are ``keep`` and stay."""
        sel = (fresh.to(self.device) > 0)
        for g, spec in self.reset_spec.items():
            for name, how in spec.items():
                if how == "keep":
                    continue
                if how != "empty":
                    raise ValueError(f"unknown cache reset action {how!r}")
                leaf = caches[g][name]
                leaf.masked_fill_(sel.view((1, -1) + (1,) * (leaf.ndim - 2)),
                                  EMPTY_POS)

    def nbytes(self) -> int:
        """Total pool bytes over every leaf (arenas, scales, positions)."""
        return sum(sum(t.numel() * t.element_size() for t in tree.values())
                   for tree in self.caches.values())

    def nbytes_by_class(self) -> Dict[str, int]:
        """``nbytes`` split into ``arena``, ``scales``, ``pos`` and
        ``state`` (other leaves)."""
        out = {"arena": 0, "scales": 0, "pos": 0, "state": 0}
        for g, tree in self.caches.items():
            for name, leaf in tree.items():
                nb = leaf.numel() * leaf.element_size()
                if name.endswith("_scale"):
                    out["scales"] += nb
                elif name == "pos":
                    out["pos"] += nb
                elif g in self.layout and name in ("k", "v"):
                    out["arena"] += nb
                else:
                    out["state"] += nb
        return out
