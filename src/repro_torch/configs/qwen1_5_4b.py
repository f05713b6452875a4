"""qwen1.5-4b [dense] — MHA (kv=20) with QKV bias.

[hf:Qwen/Qwen1.5-0.5B family; hf]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-4B",
))
