"""Quantized matmul dispatch (port of `llama3_quantization_tpu/ops/matmul.py`).

A `QuantizedTensor` with a zero point and contiguous groups takes the fused
kernels (B1 for M <= 64, B2 above; their plain versions on the CPU), as the
JAX package's "pallas" backend does. Tensors those kernels do not take
(`zero is None`, or a `g_idx` act-order map) ride the dequant reference
route, as the JAX "xla" backend does. Plain tensors (the bf16 `lm_head`)
are a `torch.matmul`. The `a8` and `s4` backends are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..quant.qtensor import QuantizedTensor, dequantize
from .fused_qmatmul import fused_dequant_matmul


def qmatmul(x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """`x @ w` where `w` is a tensor or a QuantizedTensor."""
    if isinstance(w, QuantizedTensor):
        if w.zero is not None and w.g_idx is None:
            return fused_dequant_matmul(x, w, out_dtype=out_dtype)
        wd = dequantize(w)
        return torch.matmul(x.to(wd.dtype), wd).to(out_dtype or x.dtype)
    return torch.matmul(x, w.to(x.dtype)).to(out_dtype or x.dtype)


def qlinear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear layer `x @ w (+ bias)`."""
    y = qmatmul(x, w)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
