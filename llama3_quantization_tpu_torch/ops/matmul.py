"""Quantized matmul dispatch (port of `llama3_quantization_tpu/ops/matmul.py`).

Four backends for `QuantizedTensor` weights, chosen process-wide by
`set_backend` (or scoped by the `backend(...)` context manager) and read at
every call:

- "pallas" (the port's default): the fused kernels B1 (M <= 64) and B2
  (`ops/fused_qmatmul.py`) for weights with a zero point;
- "a8": unpacked int8 containers through kernel B3 with s8 activations
  (`ops/a8_matmul.py`); packed weights take the dequant route, with a
  one-time warning;
- "s4": codes of up to 4 bits through B3 on 4-bit storage
  (`ops/s4_matmul.py`); unpacked 8-bit containers through the a8 route;
- "xla": dequantize, then `torch.matmul`.

Whatever the backend, act-order (`g_idx`) weights and the cases a backend
does not take ride the dequant route, as in JAX, and plain tensors (a bf16
`lm_head`) are a `torch.matmul`. `prepare_decode_params` turns a parameter
tree's weights into `S4Weight`s under "s4"; those always run `s4w_matmul`.

The JAX package defaults to "xla"; the port defaults to "pallas", so that
its paths run their kernels unless a caller asks otherwise.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Optional

import torch

from ..quant.qtensor import QuantizedTensor, dequantize
from ..quant.quantizer import QuantSpec, fake_quant_dynamic
from .a8_matmul import a8_matmul
from .fused_qmatmul import fused_dequant_matmul
from .s4_matmul import S4Weight, prepare_s4, s4_matmul, s4w_matmul

BACKENDS = ("xla", "pallas", "a8", "s4")
_BACKEND = "pallas"
_A8_PACKED_WARNED = False


def set_backend(name: str) -> None:
    """Select the quantized-matmul backend for every later call."""
    global _BACKEND
    if name not in BACKENDS:
        raise ValueError(name)
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


@contextlib.contextmanager
def backend(name: str):
    """Run the body under backend `name`, then restore the previous one."""
    global _BACKEND
    prev = _BACKEND
    set_backend(name)
    try:
        yield
    finally:
        _BACKEND = prev


def prepare_decode_params(tree):
    """Under "s4", a copy of the parameter tree with every QuantizedTensor of
    up to 4 bits (and no `g_idx`) replaced by its `S4Weight`; the tree
    itself under every other backend. Call it once per generate or serving
    run, outside the step loop: it rewrites the weight bytes."""
    if _BACKEND != "s4":
        return tree

    def walk(node):
        if isinstance(node, QuantizedTensor):
            return prepare_s4(node) if node.bits <= 4 and node.g_idx is None else node
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(tree)


def _dequant_matmul(x: torch.Tensor, w: QuantizedTensor, out_dtype) -> torch.Tensor:
    wd = dequantize(w)
    return torch.matmul(x.to(wd.dtype), wd).to(out_dtype or x.dtype)


def qmatmul(x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """`x @ w` where `w` is a tensor, a QuantizedTensor or an S4Weight."""
    global _A8_PACKED_WARNED
    if isinstance(w, S4Weight):
        return s4w_matmul(x, w, out_dtype=out_dtype)
    if not isinstance(w, QuantizedTensor):
        return torch.matmul(x, w.to(x.dtype)).to(out_dtype or x.dtype)
    if w.g_idx is not None:
        # act-order grouping: only the gather-dequant route understands it
        return _dequant_matmul(x, w, out_dtype)
    if _BACKEND == "s4":
        if w.bits <= 4:
            return s4_matmul(x, w, out_dtype=out_dtype)
        if not w.packed:
            return a8_matmul(x, w, out_dtype=out_dtype)
    if _BACKEND == "a8":
        if not w.packed:
            return a8_matmul(x, w, out_dtype=out_dtype)
        if not _A8_PACKED_WARNED:
            _A8_PACKED_WARNED = True
            warnings.warn(
                "a8 backend with PACKED weights: falling back to the dequant path; recode "
                "with quant.serving.recode_model_s8 (unpacked s8 containers) for kernel B3",
                stacklevel=2,
            )
    if _BACKEND == "pallas" and x.dim() >= 2 and w.zero is not None:
        return fused_dequant_matmul(x, w, out_dtype=out_dtype)
    return _dequant_matmul(x, w, out_dtype)


def qlinear(
    x: torch.Tensor, w, bias: Optional[torch.Tensor] = None, act_spec: Optional[QuantSpec] = None
) -> torch.Tensor:
    """Linear layer `x @ w (+ bias)`, with an enabled `act_spec`
    fake-quantizing the input first (`ops/matmul.py:147-161`)."""
    if act_spec is not None and act_spec.enabled:
        x = fake_quant_dynamic(x, act_spec)
    y = qmatmul(x, w)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
