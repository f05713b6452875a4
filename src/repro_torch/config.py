"""Config system: frozen dataclasses + a registry keyed by --arch id.

The port's own copy of ``repro.config`` (field for field, so a config
compares equal across the two packages). Registered: the paper's
basecaller family (``PAPER_ARCHS``) and the ten assigned LM archs
(``ASSIGNED_ARCHS``). Reduced ("smoke") variants are derived
mechanically with :meth:`ModelConfig.smoke`. The dry run's cells are
(arch x :data:`SHAPES`), where :func:`shape_applicable`.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class QuantPolicy:
    """Per-layer <weight, activation> bit-widths (paper's tuple notation).

    ``weight_bits``/``act_bits`` of 0 mean "leave in bf16/fp32". Layer
    granularity is applied by the model builders; this dataclass carries
    the defaults plus optional per-layer overrides keyed by a layer tag.
    """

    weight_bits: int = 0
    act_bits: int = 0
    per_channel: bool = True
    overrides: Tuple[Tuple[str, Tuple[int, int]], ...] = ()

    def bits_for(self, tag: str) -> Tuple[int, int]:
        for pat, wa in self.overrides:
            if pat in tag:
                return wa
        return (self.weight_bits, self.act_bits)

    @property
    def enabled(self) -> bool:
        return self.weight_bits > 0 or self.act_bits > 0 or bool(self.overrides)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0            # 0 -> d_model // n_heads
    # ---- attention flavour ----
    qkv_bias: bool = False
    rope_2d: bool = False
    rope_theta: float = 10000.0
    mla: bool = False
    mla_q_lora_rank: int = 0
    mla_kv_lora_rank: int = 0
    mla_qk_nope_dim: int = 0
    mla_qk_rope_dim: int = 0
    mla_v_dim: int = 0
    sliding_window: int = 0
    # ---- MoE ----
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_d_ff: int = 0
    n_dense_layers: int = 0
    # ---- SSM ----
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    # ---- enc-dec / frontends ----
    n_enc_layers: int = 0
    frontend: str = ""
    frontend_tokens: int = 0
    # ---- basecaller ----
    n_blocks: int = 0
    channels: Tuple[int, ...] = ()
    kernel_sizes: Tuple[int, ...] = ()
    strides: Tuple[int, ...] = ()
    repeats: Tuple[int, ...] = ()
    use_skips: bool = False
    n_bases: int = 5              # A C G T + CTC blank
    # ---- numerics / training ----
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    quant: QuantPolicy = field(default_factory=QuantPolicy)
    remat: bool = True
    mtp_depth: int = 0
    source: str = ""              # provenance note

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def supports_long_context(self) -> bool:
        """sub-quadratic archs that run the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    def smoke(self) -> "ModelConfig":
        """Mechanically reduced config of the same family for CPU tests."""
        def cap(v, m):
            return min(v, m) if v else v
        kw: Dict[str, Any] = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2),
            d_model=cap(self.d_model, 64),
            n_heads=cap(self.n_heads, 4),
            n_kv_heads=cap(self.n_kv_heads, 2),
            d_ff=cap(self.d_ff, 128),
            vocab_size=cap(self.vocab_size, 256),
            head_dim=16 if self.n_heads else 0,
            n_experts=cap(self.n_experts, 4),
            experts_per_tok=cap(self.experts_per_tok, 2),
            n_shared_experts=cap(self.n_shared_experts, 1),
            moe_d_ff=cap(self.moe_d_ff, 64),
            dense_d_ff=cap(self.dense_d_ff, 128),
            n_dense_layers=cap(self.n_dense_layers, 1),
            ssm_state=cap(self.ssm_state, 16),
            ssm_headdim=cap(self.ssm_headdim, 16),
            ssm_chunk=cap(self.ssm_chunk, 32),
            n_enc_layers=cap(self.n_enc_layers, 2),
            frontend_tokens=cap(self.frontend_tokens, 8),
            mla_q_lora_rank=cap(self.mla_q_lora_rank, 32),
            mla_kv_lora_rank=cap(self.mla_kv_lora_rank, 16),
            mla_qk_nope_dim=cap(self.mla_qk_nope_dim, 16),
            mla_qk_rope_dim=cap(self.mla_qk_rope_dim, 8),
            mla_v_dim=cap(self.mla_v_dim, 16),
            sliding_window=cap(self.sliding_window, 32),
            n_blocks=cap(self.n_blocks, 4),
            mtp_depth=cap(self.mtp_depth, 1),
            dtype="float32",
            remat=False,
        )
        if self.n_kv_heads and self.n_heads:
            kw["n_kv_heads"] = max(1, min(2, kw["n_heads"]))
        if self.channels:
            kw["channels"] = tuple(min(c, 32) for c in self.channels[:4])
            kw["kernel_sizes"] = self.kernel_sizes[:4]
            kw["strides"] = self.strides[:4]
            kw["repeats"] = tuple(min(r, 1) for r in self.repeats[:4])
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Shapes


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"
    microbatch: int = 0       # 0 -> auto

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


# ---------------------------------------------------------------------------
# Registry


_REGISTRY: Dict[str, ModelConfig] = {}

ASSIGNED_ARCHS = (
    "command-r-plus-104b",
    "qwen1.5-4b",
    "chatglm3-6b",
    "llama3-405b",
    "internvl2-1b",
    "hymba-1.5b",
    "mamba2-130m",
    "granite-moe-1b-a400m",
    "deepseek-v3-671b",
    "whisper-tiny",
)

PAPER_ARCHS = ("rubicall", "bonito", "causalcall")


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    for arch in ASSIGNED_ARCHS + PAPER_ARCHS:
        if arch not in _REGISTRY:
            importlib.import_module("repro_torch.configs." + arch.replace(
                "-", "_").replace(".", "_"))


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).smoke()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    _ensure_loaded()
    return dict(_REGISTRY)
