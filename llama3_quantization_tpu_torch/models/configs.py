"""Model architecture configs.

A copy of `llama3_quantization_tpu/models/configs.py`: the port keeps its
own so that it never imports the JAX package. Keep the two in step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer architecture description.

    Covers Llama-2/3 (GQA, RoPE, SwiGLU, RMSNorm) and OPT (learned positions,
    ReLU MLP, LayerNorm, absolute pos offset) via `arch`.
    """

    arch: str = "llama"  # "llama" | "opt" | "falcon" | "mixtral"
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_position_embeddings: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    # OPT specifics
    do_layer_norm_before: bool = True
    activation: str = "silu"  # "silu" (llama) | "relu" (opt) | "gelu" (falcon)
    #: Falcon-style parallel attention+MLP off one shared layernorm
    parallel_block: bool = False
    #: Mixtral-style sparse MoE MLP
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # RoPE frequency scaling (HF `rope_scaling`): None, "linear", or
    # "llama3" (Llama-3.1 long-context NTK-by-parts). Flattened fields so
    # the frozen dataclass stays hashable.
    rope_scaling_type: Optional[str] = None
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_pos: int = 8192
    # numerics
    dtype: str = "bfloat16"

    @property
    def rope_scaling_(self):
        """Scaling tuple for rope_cos_sin (None when unscaled)."""
        if self.rope_scaling_type is None:
            return None
        return (
            self.rope_scaling_type,
            self.rope_scaling_factor,
            self.rope_low_freq_factor,
            self.rope_high_freq_factor,
            self.rope_original_max_pos,
        )

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def kv_repeat(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def uses_rope(self) -> bool:
        return self.arch in ("llama", "falcon", "mixtral")

    @property
    def rms_norms(self) -> bool:
        return self.arch in ("llama", "mixtral")

    @property
    def is_moe(self) -> bool:
        return self.arch == "mixtral"


# ---------------------------------------------------------------------------
# Named configs (shapes from the HF model cards).
# ---------------------------------------------------------------------------

LLAMA3_8B = ModelConfig(
    arch="llama",
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    rope_theta=500000.0,
    max_position_embeddings=8192,
)

LLAMA3_70B = ModelConfig(
    arch="llama",
    vocab_size=128256,
    hidden_size=8192,
    intermediate_size=28672,
    num_layers=80,
    num_heads=64,
    num_kv_heads=8,
    rope_theta=500000.0,
    max_position_embeddings=8192,
)

LLAMA2_7B = ModelConfig(
    arch="llama",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=11008,
    num_layers=32,
    num_heads=32,
    num_kv_heads=32,
    rope_theta=10000.0,
    max_position_embeddings=4096,
    rms_norm_eps=1e-5,
)

OPT_125M = ModelConfig(
    arch="opt",
    vocab_size=50272,
    hidden_size=768,
    intermediate_size=3072,
    num_layers=12,
    num_heads=12,
    num_kv_heads=12,
    max_position_embeddings=2048,
    activation="relu",
    tie_word_embeddings=True,
)

#: Tiny llama-shaped config for CPU tests (random init, real code paths).
TINY_LLAMA = ModelConfig(
    arch="llama",
    vocab_size=512,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    rope_theta=10000.0,
    max_position_embeddings=256,
)

TINY_OPT = ModelConfig(
    arch="opt",
    vocab_size=512,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=4,
    max_position_embeddings=256,
    activation="relu",
    tie_word_embeddings=True,
)

FALCON_7B = ModelConfig(
    arch="falcon",
    vocab_size=65024,
    hidden_size=4544,
    intermediate_size=4 * 4544,
    num_layers=32,
    num_heads=71,
    num_kv_heads=1,  # multi-query attention
    rope_theta=10000.0,
    max_position_embeddings=2048,
    activation="gelu",
    parallel_block=True,
    tie_word_embeddings=False,
)

TINY_FALCON = ModelConfig(
    arch="falcon",
    vocab_size=512,
    hidden_size=64,
    intermediate_size=256,
    num_layers=2,
    num_heads=4,
    num_kv_heads=1,
    rope_theta=10000.0,
    max_position_embeddings=256,
    activation="gelu",
    parallel_block=True,
)

MIXTRAL_8X7B = ModelConfig(
    # Sparse MoE: 8 experts, top-2 routing; the reference quantizes its
    # Linears with the router excluded (`quant/omniquant.py:198-206`).
    arch="mixtral",
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    rope_theta=1e6,
    max_position_embeddings=32768,
    num_experts=8,
    num_experts_per_tok=2,
)

TINY_MIXTRAL = ModelConfig(
    arch="mixtral",
    vocab_size=512,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    rope_theta=10000.0,
    max_position_embeddings=256,
    num_experts=4,
    num_experts_per_tok=2,
)

NAMED_CONFIGS = {
    "llama3-8b": LLAMA3_8B,
    "llama3-70b": LLAMA3_70B,
    "llama2-7b": LLAMA2_7B,
    "opt-125m": OPT_125M,
    "falcon-7b": FALCON_7B,
    "mixtral-8x7b": MIXTRAL_8X7B,
    "tiny-mixtral": TINY_MIXTRAL,
    "tiny-llama": TINY_LLAMA,
    "tiny-opt": TINY_OPT,
    "tiny-falcon": TINY_FALCON,
}
