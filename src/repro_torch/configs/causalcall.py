"""Causalcall-style baseline — dilated causal TCN with residual blocks.

[Zeng et al., Frontiers in Genetics 2020]
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="causalcall",
    family="basecaller",
    n_layers=5,
    d_model=512,
    n_blocks=5,
    channels=(512, 512, 512, 512, 512),   # ~3.4M params (paper ~3.6M)
    kernel_sizes=(3, 3, 3, 3, 3),
    strides=(1, 1, 1, 1, 1),
    repeats=(2, 2, 2, 2, 2),
    use_skips=True,
    n_bases=5,
    vocab_size=5,
    source="Causalcall (TCN, dilations 1..16)",
))
