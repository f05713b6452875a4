"""internvl2-1b [vlm] — InternViT (stub) + Qwen2-0.5B-style LM backbone.

Frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings occupying the first ``frontend_tokens``
positions of the sequence.

[arXiv:2404.16821; hf]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    frontend="vision",
    frontend_tokens=256,     # ViT patch embeddings per image
    source="arXiv:2404.16821",
))
