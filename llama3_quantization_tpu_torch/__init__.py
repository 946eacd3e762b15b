"""PyTorch + CUDA port of `llama3_quantization_tpu` for NVIDIA Hopper.

Imports torch and numpy only: never JAX, never the JAX package. Entry
points that create tensors take `device` (default "cuda") and raise when
CUDA is missing unless the caller asks for the CPU. On CPU tensors every
kernel wrapper runs its plain PyTorch version; on CUDA tensors it launches
its hand-written kernel (`csrc/`, built with nvcc at first use).
"""

from .convert import params_from_numpy
from .device import resolve_device
from .models.configs import (
    FALCON_7B,
    LLAMA3_8B,
    MIXTRAL_8X7B,
    NAMED_CONFIGS,
    OPT_125M,
    TINY_FALCON,
    TINY_LLAMA,
    TINY_MIXTRAL,
    TINY_OPT,
    ModelConfig,
)
from .models.params import init_params, linear_names, quantize_model_rtn
from .models.seq2seq import (
    Seq2SeqConfig,
    decode_step_seq2seq,
    forward_logits_seq2seq,
    from_hf_seq2seq,
    greedy_generate_seq2seq,
    greedy_generate_seq2seq_cached,
    init_seq2seq_params,
    init_seq2seq_state,
    quantize_seq2seq_rtn,
)
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
    set_decode_attn,
    set_decode_kernel,
    set_decode_mesh,
    set_flash,
    set_moe_capacity,
    set_stacked_decode,
    speculative_generate,
)
from .models.windowed import decode_window, merge_window_into_cache, set_windowed_decode, windowed_ok
from .ops import launches
from .ops.decode_attention import (
    flash_decode_gqa,
    flash_decode_gqa_s8,
    flash_decode_gqa_s8_stacked,
    flash_decode_gqa_stacked,
    xla_decode_gqa_s8,
    xla_decode_gqa_s8_stacked,
)
from .ops.a8_matmul import a8_matmul, quantize_activations_s8
from .ops.flash_attention import flash_attention
from .ops.fused_qmatmul import fused_dequant_matmul
from .ops.kvcache import kv4_codes, kv4_pack, kv4_quantize, kv4_unpack_codes, kv_quantize
from .ops.matmul import backend, get_backend, prepare_decode_params, qlinear, qmatmul, set_backend
from .ops.padding import PaddedWeight, pad_for_kernels
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
    "FALCON_7B", "LLAMA3_8B", "MIXTRAL_8X7B", "NAMED_CONFIGS", "NO_QUANT", "OPT_125M",
    "TINY_FALCON", "TINY_LLAMA", "TINY_MIXTRAL", "TINY_OPT", "ModelConfig", "QuantSpec",
    "QuantizedTensor", "RuntimeQuantConfig", "S4Weight", "Seq2SeqConfig", "ServingEngine",
    "a8_matmul", "backend", "decode_step", "decode_step_multi", "decode_step_seq2seq", "decode_window", "dequantize", "fake_quant",
    "fake_quant_dynamic", "flash_attention", "flash_decode_gqa", "flash_decode_gqa_s8",
    "flash_decode_gqa_s8_stacked", "flash_decode_gqa_stacked", "flatten_speculative",
    "forward_hidden", "forward_logits", "forward_logits_seq2seq", "from_codes", "from_hf_seq2seq", "fuse_for_decode", "fused_dequant_matmul",
    "get_backend", "greedy_generate", "greedy_generate_seq2seq", "greedy_generate_seq2seq_cached",
    "init_kv_cache", "init_params", "init_quantized_params", "init_seq2seq_params",
    "init_seq2seq_state",
    "kv4_codes", "kv4_pack", "kv4_quantize", "kv4_unpack_codes", "kv_quantize", "launches",
    "linear_names", "merge_window_into_cache", "minmax_scale_zp", "pack_factor", "pack_subbyte",
    "PaddedWeight", "pad_for_kernels", "params_from_numpy", "prepare_decode_params", "prepare_s4",
    "qlinear", "qmatmul", "quantize_activations_s8", "quantize_model_rtn", "quantize_rtn",
    "quantize_seq2seq_rtn",
    "recode_head_s4", "recode_head_s8", "recode_model_s8", "recode_s8_percol", "resolve_device",
    "s4_matmul", "s4w_matmul", "sample_generate", "sample_logits", "set_backend",
    "set_decode_attn", "set_decode_kernel", "set_decode_mesh", "set_flash", "set_moe_capacity", "set_stacked_decode",
    "set_windowed_decode", "speculative_generate", "unpack_subbyte", "windowed_ok",
    "xla_decode_gqa_s8", "xla_decode_gqa_s8_stacked",
]
