"""RUBICALL — the paper's QABAS+SkipClip-designed basecaller (Fig. 5).

28 quantized conv blocks (grouped 1-D conv + pointwise conv, BatchNorm,
quantized ReLU), NO skip connections, mixed per-layer precision:
higher bits near the squiggle input, lower bits near the CTC head.
~3.3 M parameters. CTC head over {blank, A, C, G, T}.
"""
from repro_torch.config import ModelConfig, QuantPolicy, register

_N_BLOCKS = 28
# kernel sizes cycle through the QABAS-selected options (paper search space:
# 3,5,7,9,25,31,55,75,115,123); wider receptive fields in the middle.
_KS = (9, 9, 25, 25, 31, 31, 31, 55, 55, 55, 75, 75, 75, 75,
       75, 75, 55, 55, 55, 31, 31, 31, 25, 25, 9, 9, 5, 5)
_CH = (344,) * _N_BLOCKS

# Mixed precision <weight, activation> per depth range (Fig. 5 trend).
_QUANT = QuantPolicy(
    weight_bits=8, act_bits=8, per_channel=True,
    overrides=(
        ("block00", (16, 16)), ("block01", (16, 16)),
        ("block02", (16, 8)), ("block03", (16, 8)),
        ("block04", (16, 8)), ("block05", (8, 8)),
        ("block2", (8, 4)),   # blocks 20-27 (prefix match)
        ("head", (8, 4)),
    ),
)

CONFIG = register(ModelConfig(
    name="rubicall",
    family="basecaller",
    n_layers=_N_BLOCKS,
    d_model=344,
    n_blocks=_N_BLOCKS,
    channels=_CH,
    kernel_sizes=_KS,
    strides=(3,) + (1,) * (_N_BLOCKS - 1),   # stem downsamples the squiggle 3x
    repeats=(1,) * _N_BLOCKS,
    use_skips=False,
    n_bases=5,
    vocab_size=5,
    quant=_QUANT,
    source="RUBICON paper Fig. 5",
))
