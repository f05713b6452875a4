"""whisper-tiny [audio] — encoder-decoder; conv audio frontend is a STUB
(``input_specs()`` supplies precomputed log-mel frame embeddings).

[arXiv:2212.04356; unverified]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,              # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    frontend="audio",
    frontend_tokens=1500,    # 30 s of audio at 50 Hz after conv stem
    tie_embeddings=True,
    source="arXiv:2212.04356",
))
