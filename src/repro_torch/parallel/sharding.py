"""Path-based sharding rules (the port's counterpart of
``repro.parallel.sharding``: MaxText-style logical rules keyed on the
parameter tree's paths).

Scheme on the production mesh (data=16, model=16[, pod=2]):

- DP/FSDP over 'pod' x 'data': weight d_model dims shard on 'data'
  (each layer's weights all-gathered for its forward, the FSDP
  pattern; gradients reduce-scattered).
- TP over 'model': attention head-merged output dims, FFN hidden,
  vocab (embedding rows / lm_head columns), the MoE expert dim (EP).
- Optimizer m/v mirror the parameter tree, so the same rules (ZeRO).
- The basecaller family is pure DP (3M parameters: replication wins).

Rules emit specs for the UNSTACKED layer shape; a stacked leaf (the
layer axis of a group) gets leading ``None``s, so one rule covers both.

A spec is a :class:`Spec`: one entry per tensor dim, ``None``, a mesh
axis name or a tuple of names, entry for entry the reference's
``PartitionSpec``. :func:`param_specs`, :func:`cache_spec_tree` and
:func:`opt_state_specs` give spec trees shaped as the trees they
describe (a ``PackedTensor`` leaf's data and scale are its children
``0`` and ``1``, as the reference's pytree flattens them).
:func:`param_shardings`, :func:`to_shardings` and
:func:`shardings_like` turn them into :class:`Sharding`\\ s on a
``DeviceMesh``: the spec filtered to the mesh and the DTensor
placements it means, one per mesh axis (``Shard(d)`` where tensor dim
d carries the axis, else ``Replicate()``; a dim over several axes is
split major axis first, as the reference's).

The reference's ``constrain_tree`` (a GSPMD hint inside a jitted
program) has no twin: the port's model runs on plain tensors. A
tensor-parallel train step (``parallel/tensor_parallel``) holds each
rank's shard of the leaves :func:`model_split_dim` splits, the
``model`` entries of these specs under a rule of whole units (whole
heads, not :func:`_filter_axes`'s flat divisibility; the SSM's
``in_proj`` and conv split in :class:`Segments`, their B and C whole),
and sums the split units at the reference's ``constrain`` points.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.compat import Replicate, Shard
from repro_torch.config import ModelConfig
from repro_torch.core.quant.policy import PackedTensor

BATCH_AXES: Tuple[str, ...] = ("pod", "data")

# (pattern, base spec entries) — first match wins.
_LM_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r"embed(/\d+)?$",                  ("model", "data")),
    (r"lm_head/kernel(/\d+)?$",         ("data", "model")),
    (r"vision_proj/kernel(/\d+)?$",     ("data", "model")),
    (r"(wo|out_proj)/kernel(/\d+)?$",   ("model", "data")),
    (r"(wo|out_proj)/bias$",            (None,)),
    (r"router/kernel$",                 ("data", None)),
    (r"ffn/wi(/\d+)?$",                ("model", "data", None)),   # MoE (E,d,ff)
    (r"ffn/wg(/\d+)?$",                ("model", "data", None)),
    (r"ffn/wo(/\d+)?$",                ("model", None, "data")),
    (r"(wi|wg|wq|wk|wv|wuq|wukv|wdq|wdkv|in_proj|proj)/kernel(/\d+)?$",
                                        ("data", "model")),
    (r"(wi|wg|wq|wk|wv|wuq|wukv|in_proj)/bias$", ("model",)),
    (r"conv_w$",                        (None, "model")),
    (r"conv_b$",                        ("model",)),
    (r"(A_log|D|dt_bias)$",             (None,)),
    (r"(scale|bias)$",                  (None,)),
)


class Spec(tuple):
    """A partition spec: ``Spec(*entries)``, one entry per tensor dim. A
    one-name tuple entry is kept as the name, as ``PartitionSpec`` keeps
    it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (tuple(e) if len(e) > 1 else e[0])
            if isinstance(e, (tuple, list)) and e else e for e in entries))

    def __repr__(self) -> str:
        return "Spec" + tuple.__repr__(self)


def _replicated(ndim: int) -> Spec:
    return Spec(*([None] * ndim))


def spec_for_path(path: str, ndim: int, cfg: ModelConfig) -> Spec:
    if cfg.family == "basecaller":
        return _replicated(ndim)
    for pat, base in _LM_RULES:
        if re.search(pat, path):
            if len(base) > ndim:      # e.g. scalar leaves
                return _replicated(ndim)
            return Spec(*((None,) * (ndim - len(base)) + tuple(base)))
    return _replicated(ndim)


# The units a model axis splits in training (``parallel/tensor_parallel``),
# each with the counts that every split of it must divide: attention by
# whole heads (query and KV; an xdec block's cross-attention too), MLA by
# its query heads (its latent has no KV heads of its own: ``wukv``
# expands it to every query head), the SSM by its heads, the dense MLP
# by its hidden width, the vocabulary, the expert stacks. Every other
# leaf stays whole on each rank.
_ATTN_UNIT = re.compile(r"(^|/)x?attn/(wq|wk|wv)/(kernel|bias)$"
                        r"|(^|/)x?attn/wo/kernel$")
_MLA_UNIT = re.compile(r"(^|/)attn/(wuq|wukv|wo)/kernel$")
_SSM_UNIT = re.compile(r"(^|/)ssm/(in_proj/kernel|conv_w|conv_b|A_log|D"
                       r"|dt_bias|out_proj/kernel)$")
_MLP_UNIT = re.compile(r"ffn/(shared/)?(wi|wg|wo)/kernel$")
_VOCAB_UNIT = re.compile(r"(^|/)embed$|(^|/)lm_head/kernel$")
_EXPERT_UNIT = re.compile(r"ffn/(wi|wg|wo)$")


@dataclasses.dataclass(frozen=True)
class Segments:
    """A leaf a model axis splits in part: along ``dim``, the whole
    leaf's consecutive segments, each ``(length, split)``. A rank holds
    its part of every split segment (the ``index``-th of ``model`` equal
    parts) and all of every whole one, in the same order. The SSM's
    ``in_proj`` columns (z, x and dt by heads; B and C, which every head
    reads, whole) and its conv channels (x by heads; B and C whole)."""
    dim: int
    parts: Tuple[Tuple[int, bool], ...]

    def lengths(self, model: int) -> Tuple[int, ...]:
        """Each segment's length on one rank of ``model``."""
        return tuple(n // model if s else n for n, s in self.parts)


def _unit_counts(path: str, shape, cfg: ModelConfig) -> Tuple[int, ...]:
    """The counts a model axis must divide for ``path``'s unit to split
    (none: the leaf is in no unit)."""
    if cfg.family == "basecaller":
        return ()
    if cfg.mla and _MLA_UNIT.search(path):
        return (cfg.n_heads,)
    if _ATTN_UNIT.search(path):
        return (cfg.n_heads, cfg.n_kv_heads)
    if _SSM_UNIT.search(path):
        from repro_torch.models.lm.ssm import ssm_dims
        return (ssm_dims(cfg)[1],)
    if _VOCAB_UNIT.search(path):
        return (cfg.vocab_size,)
    if _EXPERT_UNIT.search(path):
        return (cfg.n_experts,)
    if _MLP_UNIT.search(path):
        # the hidden width: wi/wg's columns, wo's rows
        return (shape[-2] if path.endswith("wo/kernel") else shape[-1],)
    return ()


def _ssm_split(path: str, shape, cfg: ModelConfig):
    """An SSM leaf's split where the spec does not give it: ``in_proj``
    and the conv in :class:`Segments`, the per-head vectors along their
    last dim (None: ``out_proj``, whose rows the spec gives)."""
    from repro_torch.models.lm.ssm import ssm_dims
    d_in, nh, N, _ = ssm_dims(cfg)
    last = len(shape) - 1
    if path.endswith("in_proj/kernel"):
        return Segments(last, ((d_in, True), (d_in, True), (2 * N, False),
                               (nh, True)))
    if path.endswith(("conv_w", "conv_b")):
        return Segments(last, ((d_in, True), (2 * N, False)))
    if path.endswith(("A_log", "D", "dt_bias")):
        return last
    return None


def model_split_dim(path: str, shape, cfg: ModelConfig,
                    model: int) -> Optional[Any]:
    """How a model axis of ``model`` ranks splits a whole leaf (``path``,
    ``shape``) in training: the dim it cuts into ``model`` equal parts,
    a :class:`Segments` where only some segments of a dim split, or None
    where the leaf stays whole. The dim is the one :func:`spec_for_path`
    puts ``model`` on (an SSM's per-head leaves, which the spec keeps
    whole, split by heads), where ``model`` divides every count of the
    leaf's unit. Unlike :func:`_filter_axes`, which divides a flat dim,
    this cuts only whole units (``wk`` at ``n_kv_heads * head_dim``
    columns stays whole where the axis does not divide ``n_kv_heads``;
    an MLA block's ``wo`` splits with its ``wuq`` and ``wukv`` by query
    heads)."""
    counts = _unit_counts(path, shape, cfg)
    if model <= 1 or not counts or any(c % model for c in counts):
        return None
    if _SSM_UNIT.search(path):
        split = _ssm_split(path, shape, cfg)
        if split is not None:
            return split
    spec = spec_for_path(path, len(shape), cfg)
    dims = [d for d, e in enumerate(spec)
            if e == "model" or (isinstance(e, tuple) and "model" in e)]
    return dims[0] if dims else None


def model_coordinate(mesh: DeviceMesh) -> Tuple[int, int]:
    """(this rank's index on the mesh's ``model`` axis, the axis's size);
    (0, 1) on a mesh without one."""
    if "model" not in (mesh.mesh_dim_names or ()):
        return 0, 1
    return mesh.get_local_rank("model"), axis_sizes(mesh)["model"]


def axis_sizes(mesh: DeviceMesh) -> dict:
    """{axis name: size} of ``mesh``, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _filter_axes(spec: Spec, mesh: DeviceMesh,
                 shape: Optional[Tuple[int, ...]] = None) -> Spec:
    """Drop axis names absent from the mesh and axes that do not divide
    the corresponding dim (every shard the same size, as the reference's
    GSPMD input shardings): the largest prefix of a dim's axes that
    divides it is kept."""
    sizes = axis_sizes(mesh)

    def fix(i, e):
        if e is None:
            return None
        entry = tuple(a for a in (e if isinstance(e, (tuple, list)) else (e,))
                      if a in sizes)
        if not entry:
            return None
        if shape is not None and i < len(shape):
            while entry and shape[i] % math.prod(sizes[a] for a in entry):
                entry = entry[:-1]
            if not entry:
                return None
        return entry if len(entry) > 1 else entry[0]

    return Spec(*(fix(i, e) for i, e in enumerate(spec)))


# ---------------------------------------------------------------------------
# Trees: dicts, lists, tuples (OptState, TrainCarry), PackedTensor nodes


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, tensor)`` over every tensor of a parameter tree; a
    PackedTensor's data and scale are its children ``0`` and ``1``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{path}{i}/")
                for i, v in enumerate(tree)]
    if isinstance(tree, PackedTensor):
        return PackedTensor(fn(path + "0", tree.data),
                            fn(path + "1", tree.scale), tree.bits,
                            tree.orig_shape)
    return fn(path[:-1], tree)


def zip_map(fn, struct, spec):
    """``fn(leaf, spec leaf)`` over ``struct``, its spec tree matched by
    key (None subtrees stay None)."""
    if struct is None:
        return None
    if isinstance(struct, dict):
        return {k: zip_map(fn, v, spec[k]) for k, v in struct.items()}
    if isinstance(struct, PackedTensor):
        return PackedTensor(fn(struct.data, spec.data),
                            fn(struct.scale, spec.scale), struct.bits,
                            struct.orig_shape)
    if isinstance(struct, list):
        return [zip_map(fn, v, s) for v, s in zip(struct, spec)]
    if isinstance(struct, tuple):          # OptState, TrainCarry, tuples
        parts = [zip_map(fn, v, s) for v, s in zip(struct, spec)]
        return (type(struct)(*parts) if hasattr(struct, "_fields")
                else tuple(parts))
    return fn(struct, spec)


def _map_specs(fn, spec_tree):
    if spec_tree is None or isinstance(spec_tree, Spec):
        return None if spec_tree is None else fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, PackedTensor):
        return PackedTensor(fn(spec_tree.data), fn(spec_tree.scale),
                            spec_tree.bits, spec_tree.orig_shape)
    if isinstance(spec_tree, list):
        return [_map_specs(fn, v) for v in spec_tree]
    parts = [_map_specs(fn, v) for v in spec_tree]
    return (type(spec_tree)(*parts) if hasattr(spec_tree, "_fields")
            else tuple(parts))


# ---------------------------------------------------------------------------
# Spec trees


def param_specs(params_struct, cfg: ModelConfig):
    """Spec tree matching a params (or grads / m / v) tree."""
    return _map_with_path(
        lambda path, leaf: spec_for_path(path, leaf.ndim, cfg), params_struct)


def prepend_none(spec_tree, n: int = 1):
    """Add leading None dims (stacked-layer axes) to every Spec leaf."""
    return _map_specs(lambda s: Spec(*((None,) * n + tuple(s))), spec_tree)


def _attn_cache_specs(window: int = 0) -> dict:
    seq_ax = None if window > 0 else "model"   # ring buffers are small
    return {"k": Spec(BATCH_AXES, seq_ax, None, None),
            "v": Spec(BATCH_AXES, seq_ax, None, None),
            "pos": Spec(None), "window": Spec()}


def _mla_cache_specs() -> dict:
    return {"c": Spec(BATCH_AXES, "model", None),
            "k_rope": Spec(BATCH_AXES, "model", None),
            "pos": Spec(BATCH_AXES, None)}


def _ssm_cache_specs() -> dict:
    return {"h": Spec(BATCH_AXES, "model", None, None),
            "conv": Spec(BATCH_AXES, None, "model")}


def block_cache_specs(cfg: ModelConfig, kind: str) -> dict:
    """Specs of one block's contiguous cache (the static path's, as
    ``transformer.init_block_cache`` lays it out)."""
    from repro_torch.models.lm import transformer as tfm
    if kind in tfm.MLA_KINDS:
        return _mla_cache_specs()
    if kind == "ssm":
        return _ssm_cache_specs()
    if kind in tfm.HYBRID_KINDS:
        return {"kv": _attn_cache_specs(tfm._block_window(cfg, kind)),
                "ssm": _ssm_cache_specs()}
    return _attn_cache_specs()


def cache_spec_tree(cfg: ModelConfig) -> dict:
    """Spec tree matching ``transformer.init_caches``."""
    from repro_torch.models.lm import transformer as tfm
    specs = {}
    for gname, kind, n in tfm.group_names(cfg):
        specs[gname] = prepend_none(block_cache_specs(cfg, kind))
        if kind == "xdec":
            specs[gname + "/enc_kv"] = {
                "k": Spec(None, ("pod", "data"), None, None, None),
                "v": Spec(None, ("pod", "data"), None, None, None)}
    return specs


def replicated_specs(tree):
    """A spec tree replicating every leaf of ``tree`` (None stays None)."""
    if tree is None:
        return None
    return _map_with_path(lambda _, leaf: _replicated(leaf.ndim), tree)


def opt_state_specs(opt_struct, params_struct, cfg: ModelConfig):
    """OptState(step, m, v, m_scale, v_scale): m/v mirror the params;
    the int8 moments' per-leaf scales and the step are replicated."""
    pspecs = param_specs(params_struct, cfg)
    return type(opt_struct)(Spec(), pspecs, pspecs,
                            replicated_specs(opt_struct.m_scale),
                            replicated_specs(opt_struct.v_scale))


# ---------------------------------------------------------------------------
# Shardings on a DeviceMesh


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec filtered to ``mesh`` and its DTensor placements, one per
    mesh axis (the reference's ``NamedSharding``)."""
    mesh: DeviceMesh
    spec: Spec
    placements: Tuple[Any, ...]

    def local_shape(self, shape) -> Tuple[int, ...]:
        """One device's shard of a tensor of ``shape`` (rank 0's where a
        split is uneven: the larger part)."""
        out = list(shape)
        for size, pl in zip(self.mesh.shape, self.placements):
            if isinstance(pl, Shard):
                out[pl.dim] = -(-out[pl.dim] // size)
        return tuple(out)

    def local_bytes(self, t: torch.Tensor) -> int:
        return math.prod(self.local_shape(t.shape)) * t.element_size()


def placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Any, ...]:
    """DTensor placements of a (filtered) spec: per mesh axis,
    ``Shard(d)`` for the tensor dim d whose entry names it, else
    ``Replicate()``."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec) if e is not None and name in
                (e if isinstance(e, tuple) else (e,))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _sharding(spec: Spec, mesh: DeviceMesh, shape=None) -> Sharding:
    spec = _filter_axes(spec, mesh, shape)
    return Sharding(mesh, spec, placements(spec, mesh))


def param_shardings(params_struct, cfg: ModelConfig, mesh: DeviceMesh):
    return _map_with_path(
        lambda path, leaf: _sharding(spec_for_path(path, leaf.ndim, cfg),
                                     mesh, tuple(leaf.shape)),
        params_struct)


def shardings_like(struct_tree, spec_tree, mesh: DeviceMesh):
    """Sharding tree matching ``struct_tree``, from a spec tree (each
    spec filtered against its leaf's shape)."""
    return zip_map(lambda leaf, s: _sharding(s, mesh, tuple(leaf.shape)),
                    struct_tree, spec_tree)


def to_shardings(spec_tree, mesh: DeviceMesh, struct_tree=None):
    """Spec tree -> Sharding tree (filtering absent axis names; against
    the leaves' shapes too when ``struct_tree`` is given)."""
    if struct_tree is not None:
        return shardings_like(struct_tree, spec_tree, mesh)
    return _map_specs(lambda s: _sharding(s, mesh), spec_tree)


def per_device_bytes(struct_tree, sharding_tree) -> int:
    """Bytes one device holds of ``struct_tree`` under its shardings."""
    total = 0

    def add(leaf, sh):
        nonlocal total
        total += sh.local_bytes(leaf)
    zip_map(add, struct_tree, sharding_tree)
    return total
