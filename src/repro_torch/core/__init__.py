"""RUBICON core: the paper's contribution as PyTorch modules.

- ``core.quant``    — mixed-precision quantization (QAT fake-quant with
                      a straight-through gradient, packed int8/int4
                      weights for serving, per-layer <weight,
                      activation> policies);
- ``core.qabas``    — quantization-aware differentiable NAS (supernet,
                      path sampling, the latency table from the H100
                      roofline, the serving-knob search);
- ``core.skipclip`` — gradual skip-connection removal under KD;
- ``core.distill``  — knowledge-distillation losses;
- ``core.pruning``  — one-shot L1 unstructured / structured pruning.

The modules run on whatever device their tensors are on; none of them
launches a kernel itself (the packed weights reach the kernels through
the models' layers in eval mode).
"""
__all__: list = []
