"""Quantization: fake-quant for training (straight-through gradient,
per-tensor or per-channel scales) and packed int8/int4 weights with
per-column scales for serving, where the kernels read them."""
from repro_torch.core.quant.fake_quant import fake_quant, quant_dequant_params
from repro_torch.core.quant.policy import (PackedTensor, dequantize, pack_int4,
                                           quantize_tensor, quantize_tree,
                                           tree_size_bytes, unpack_int4)

__all__ = ["fake_quant", "quant_dequant_params", "PackedTensor",
           "dequantize", "pack_int4", "quantize_tensor", "quantize_tree",
           "tree_size_bytes", "unpack_int4"]
