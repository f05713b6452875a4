"""mamba2-130m [ssm] — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    source="arXiv:2405.21060",
))
