"""hymba-1.5b [hybrid] — parallel attention + Mamba heads per block.

Layers 0, mid, last use full (global) attention; the rest use
sliding-window attention: a bounded ring of KV per window layer plus
O(1) SSM state per layer.

[arXiv:2411.13676; hf]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    ssm_state=16,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
    sliding_window=1024,
    tie_embeddings=True,
    source="arXiv:2411.13676",
))
