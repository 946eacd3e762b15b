"""PyTorch + CUDA port of `llama3_quantization_tpu` for NVIDIA Hopper.

Imports torch and numpy only: never JAX, never the JAX package. Entry
points that create tensors take `device` (default "cuda") and raise when
CUDA is missing unless the caller asks for the CPU. On CPU tensors every
kernel wrapper runs its plain PyTorch version; on CUDA tensors it launches
its hand-written kernel (`csrc/`, built with nvcc at first use).
"""

from .convert import params_from_numpy
from .device import resolve_device
from .models.configs import LLAMA3_8B, TINY_LLAMA, ModelConfig
from .models.params import init_params, linear_names, quantize_model_rtn
from .models.synthetic import init_quantized_params
from .models.transformer import (
    NO_QUANT,
    RuntimeQuantConfig,
    decode_step,
    decode_step_multi,
    flatten_speculative,
    forward_hidden,
    forward_logits,
    greedy_generate,
    init_kv_cache,
    sample_generate,
    sample_logits,
    speculative_generate,
)
from .models.windowed import decode_window, merge_window_into_cache, set_windowed_decode, windowed_ok
from .ops import launches
from .ops.decode_attention import (
    flash_decode_gqa,
    flash_decode_gqa_s8,
    flash_decode_gqa_s8_stacked,
    flash_decode_gqa_stacked,
)
from .ops.a8_matmul import a8_matmul, quantize_activations_s8
from .ops.flash_attention import flash_attention
from .ops.fused_qmatmul import fused_dequant_matmul
from .ops.kvcache import kv4_codes, kv4_pack, kv4_quantize, kv4_unpack_codes, kv_quantize
from .ops.matmul import backend, get_backend, prepare_decode_params, qlinear, qmatmul, set_backend
from .ops.s4_matmul import S4Weight, prepare_s4, s4_matmul, s4w_matmul
from .quant.pack import pack_factor, pack_subbyte, unpack_subbyte
from .quant.qtensor import QuantizedTensor, dequantize, from_codes, quantize_rtn
from .quant.quantizer import QuantSpec, fake_quant, fake_quant_dynamic, minmax_scale_zp
from .quant.serving import (
    fuse_for_decode,
    recode_head_s4,
    recode_head_s8,
    recode_model_s8,
    recode_s8_percol,
)
from .serving import ServingEngine

__all__ = [
    "LLAMA3_8B", "NO_QUANT", "TINY_LLAMA", "ModelConfig", "QuantSpec", "QuantizedTensor",
    "RuntimeQuantConfig", "S4Weight", "ServingEngine", "a8_matmul", "backend", "decode_step",
    "decode_step_multi", "decode_window", "dequantize", "fake_quant", "fake_quant_dynamic",
    "flash_attention", "flash_decode_gqa", "flash_decode_gqa_s8", "flash_decode_gqa_s8_stacked",
    "flash_decode_gqa_stacked", "flatten_speculative", "forward_hidden", "forward_logits",
    "from_codes",
    "fuse_for_decode", "fused_dequant_matmul", "get_backend", "greedy_generate",
    "init_kv_cache", "init_params", "init_quantized_params", "kv4_codes", "kv4_pack",
    "kv4_quantize", "kv4_unpack_codes", "kv_quantize", "launches", "linear_names",
    "merge_window_into_cache", "minmax_scale_zp", "pack_factor", "pack_subbyte",
    "params_from_numpy", "prepare_decode_params", "prepare_s4", "qlinear", "qmatmul",
    "quantize_activations_s8", "quantize_model_rtn", "quantize_rtn", "recode_head_s4",
    "recode_head_s8", "recode_model_s8", "recode_s8_percol", "resolve_device", "s4_matmul",
    "s4w_matmul", "sample_generate", "sample_logits", "set_backend", "set_windowed_decode",
    "speculative_generate", "unpack_subbyte", "windowed_ok",
]
