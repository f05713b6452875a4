"""chatglm3-6b [dense] — 2d (half-dim) RoPE, GQA kv=2.

[arXiv:2406.12793; hf]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    head_dim=128,
    rope_2d=True,           # rotary applied to half of head_dim
    qkv_bias=True,          # chatglm uses bias on qkv only
    source="arXiv:2406.12793 (GLM family)",
))
