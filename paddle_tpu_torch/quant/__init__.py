"""Serving-side weight-only int8 quantization (port of
``paddle_tpu/quant``).

- :mod:`.format`: the weight format (``[K, N]`` int8 + ``[ceil(K/B), N]``
  f32 scales) and ``quantize_model`` / ``dequantize_weight``;
- :mod:`.kernels`: ``dequant_matmul``, the hand-written CUDA kernel on
  the card and its plain version on the CPU;
- :mod:`.layers`: ``WeightOnlyLinear``, the serving form of
  ``nn.Linear``;
- :mod:`.bridge`: the lossless converter from the QAT/PTQ module's
  ``convert`` output into this format (no requantization);
- :mod:`.checkpoint`: ``save_quantized`` / ``load_quantized`` on the
  ``CheckpointManager`` atomic-commit and CRC contract, in the
  reference's files;
- :mod:`.quality`: the bundled-prompt quality gate (max and mean logits
  error and greedy-match rate of the quantized model against the float
  one).

The engine knob is ``LlamaServingEngine(weight_dtype="int8")`` /
``PADDLE_TPU_WEIGHT_DTYPE=int8``. The reference's plain formulation
``dequant_matmul_xla`` is ``dequant_matmul_ref`` here.
"""

from .format import (DEFAULT_BLOCK, default_block, dequantize_weight,
                     effective_block, is_quantized, model_weight_block,
                     quantize_model, quantize_weight, serving_weight_bytes)
from .kernels import dequant_matmul, dequant_matmul_ref, supported
from .layers import WeightOnlyLinear
from .bridge import bridge_linear, bridge_model
from .checkpoint import load_quantized, save_quantized
from . import quality

__all__ = [
    "DEFAULT_BLOCK", "default_block", "effective_block",
    "quantize_weight", "dequantize_weight", "quantize_model",
    "is_quantized", "model_weight_block", "serving_weight_bytes",
    "dequant_matmul", "dequant_matmul_ref", "supported",
    "WeightOnlyLinear", "bridge_linear", "bridge_model",
    "save_quantized", "load_quantized", "quality",
]
