"""Post-training int8 quantization (the port of ``cxxnet_tpu/quant``):
the PTQ pass over verified rounds, drift verdicts, and the dequantize
helpers an fp engine negotiates a quantized round with.
``python -m cxxnet_tpu_torch.quant`` is its command line."""

from .ptq import (QUANT_LAYER_TYPES, calibrate_act_scales,
                  dequantize_blob, dequantize_params, drift_verdict,
                  is_quantized_params, quantizable_layers, quantize_blob,
                  quantize_params, quantize_weight, weight_drift,
                  write_quantized_round)

__all__ = [
    "QUANT_LAYER_TYPES", "calibrate_act_scales", "dequantize_blob",
    "dequantize_params", "drift_verdict", "is_quantized_params",
    "quantizable_layers", "quantize_blob", "quantize_params",
    "quantize_weight", "weight_drift", "write_quantized_round",
]
