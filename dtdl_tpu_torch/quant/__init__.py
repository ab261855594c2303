"""int8/fp8 quantization for serving (weight-only matmuls, quantized KV),
the port of dtdl_tpu/quant.

One engine argument away::

    engine = InferenceEngine(model, quantize_weights=True,  # int8 weights
                             kv_dtype="int8")               # int8 KV

``quantize_weights="w8f"`` and ``kv_dtype="fp8"`` are the float8_e4m3fn
variants.  :mod:`dtdl_tpu_torch.quant.core` holds the recipes,
:mod:`dtdl_tpu_torch.quant.layers` the quantized linear layer.
"""

from dtdl_tpu_torch.quant.core import (FP8_DTYPE, FP8_MAX, SCALE_SUFFIX,
                                       Fp8UnsupportedError,
                                       canon_kv_dtype, canon_weight_quant,
                                       dequantize_params, kv_quantize,
                                       kv_scale_dtype, quantize_params,
                                       quantize_tensor, tree_bytes,
                                       weight_dtypes)
from dtdl_tpu_torch.quant.layers import QuantLinear

__all__ = ["FP8_DTYPE", "FP8_MAX", "Fp8UnsupportedError", "QuantLinear",
           "SCALE_SUFFIX",
           "canon_kv_dtype", "canon_weight_quant", "dequantize_params",
           "kv_quantize", "kv_scale_dtype", "quantize_params",
           "quantize_tensor", "tree_bytes", "weight_dtypes"]
