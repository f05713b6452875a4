"""granite-moe-1b-a400m [moe] — 32 experts, top-8 routing, GQA kv=8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,               # per-expert hidden size
    moe_d_ff=512,
    vocab_size=49155,
    head_dim=64,
    n_experts=32,
    experts_per_tok=8,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
