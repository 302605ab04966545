"""Post-training quantization as a params -> params transform.

Counterpart of ``deeplearning4j_tpu/quant/``:

- ``transforms`` — ``QuantizedTensor`` (q + scale), the
  ``quantize_params`` / ``quantize_model`` recipes and the dequantizing
  ops (``dequant_matmul``, ``dequantize``, ``take_rows``,
  ``tied_logits``), int8 and fp8;
- ``calibrate`` — activation-range calibration producing a serializable
  ``QuantSpec``;
- ``validate`` — the max-divergence gate ``ModelRegistry.deploy(
  quantize=...)`` runs between warmup and cutover.
"""
from .calibrate import QuantSpec, calibrate
from .transforms import (QuantizedTensor, default_act_dtype, dequant_matmul,
                         dequantize, fp8_supported, param_bytes_of,
                         precision_of, precision_of_model, quantize_model,
                         quantize_params, quantize_tensor, take_rows,
                         tied_logits)
from .validate import (QuantizationRejectedError, divergence_report,
                       validate)

__all__ = [
    "QuantSpec", "calibrate", "QuantizedTensor", "default_act_dtype",
    "dequant_matmul", "dequantize", "fp8_supported", "param_bytes_of",
    "precision_of", "precision_of_model", "quantize_model",
    "quantize_params", "quantize_tensor", "take_rows", "tied_logits",
    "QuantizationRejectedError", "divergence_report", "validate",
]
