"""W·A8 matmul on int8 containers: the a8 backend (port of
`llama3_quantization_tpu/ops/a8_matmul.py`).

Activations are quantized per token to s8 and the weights stay unpacked
codes (signed int8: the per-column s8 serving recode of `quant/serving.py`,
or grouped centered codes; or unsigned uint8 8-bit codes), with scales
applied after the integer dots:

    y[b, n] = s_x[b] * sum_g s[g, n] * (xq[b, g, :] . c[g, :, n] - z[g, n] * xsum[b, g])

Both JAX forms, the `g == 1` per-column dot (`a8_matmul.py:89-105`) and the
grouped batched dot (`:107-124`), are kernel B3 here (`ops/qmatmul_a8.py`,
counted as "B3.s8" at M <= 64). The JAX package's K-split matvec for very
wide N (`_use_ksplit` / `matvec_ksplit`, `:51-73`) is a TPU schedule of the
same integer sums on a block-diagonal operand: B3 computes those sums
directly, so it is not reproduced.
"""

from __future__ import annotations

import torch

from ..quant.qtensor import QuantizedTensor
from .qmatmul_a8 import quantize_activations_s8, w_a8_matmul

__all__ = ["a8_matmul", "quantize_activations_s8"]


def a8_matmul(x: torch.Tensor, qt: QuantizedTensor, out_dtype=None) -> torch.Tensor:
    """`x @ dequant(qt)` with s8 activations, for unpacked codes: int8
    containers, or uint8 codes whose dot JAX's `dot_general` promotes (B3's
    "u8" layout keeps that exact s32 value)."""
    if qt.packed:
        raise ValueError("a8 path requires unpacked (int8-container) storage")
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    layout = "u8" if qt.data.dtype == torch.uint8 else "s8"
    y = w_a8_matmul(x.reshape(-1, qt.k), qt.data, layout, qt.scale, qt.zero,
                    qt.group_size or qt.k, out_dtype, "B3.s8")
    return y.reshape(*lead, qt.n)
