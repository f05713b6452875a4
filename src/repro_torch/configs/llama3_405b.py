"""llama3-405b [dense] — GQA kv=8, 128k vocab.

[arXiv:2407.21783; unverified]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    source="arXiv:2407.21783",
))
