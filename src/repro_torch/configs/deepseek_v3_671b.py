"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed experts top-8, MTP.

First 3 layers are dense (d_ff 18432); remaining 58 are MoE with routed
expert hidden 2048 (the assigned d_ff). MLA dims per arXiv:2412.19437.

The published 61 layers stay here; a run that cuts depth does so with
``dataclasses.replace(cfg, n_layers=...)`` and says so.

[arXiv:2412.19437; hf]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,          # MLA: kv "heads" equal q heads post-expansion
    d_ff=2048,               # routed expert hidden (assigned)
    moe_d_ff=2048,
    dense_d_ff=18432,
    n_dense_layers=3,
    vocab_size=129280,
    head_dim=128,
    mla=True,
    mla_q_lora_rank=1536,
    mla_kv_lora_rank=512,
    mla_qk_nope_dim=128,
    mla_qk_rope_dim=64,
    mla_v_dim=128,
    n_experts=256,
    experts_per_tok=8,
    n_shared_experts=1,
    mtp_depth=1,
    source="arXiv:2412.19437",
))
