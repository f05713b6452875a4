"""Bonito-style baseline — QuartzNet-like CTC CNN WITH skip connections.

This is the paper's most-accurate baseline and the SkipClip teacher.
Block = R repeats of (grouped conv + pointwise conv + BN + ReLU) with a
residual skip (pointwise-projected) around the repeats. FP32 weights.
"""
from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="bonito",
    family="basecaller",
    n_layers=7,
    d_model=800,
    n_blocks=7,
    channels=(344, 464, 512, 512, 560, 624, 800),   # ~10.2M params (paper ~10M)
    kernel_sizes=(9, 33, 39, 51, 63, 75, 87),
    strides=(3, 1, 1, 1, 1, 1, 1),
    repeats=(1, 5, 5, 5, 5, 5, 1),
    use_skips=True,
    n_bases=5,
    vocab_size=5,
    source="github.com/nanoporetech/bonito (QuartzNet-style CTC)",
))
