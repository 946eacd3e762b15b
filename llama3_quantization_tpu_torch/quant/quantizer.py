"""Uniform affine quantizer (port of `llama3_quantization_tpu/quant/quantizer.py`).

Min/max dynamic calibration, asymmetric zero-point rounding, scale clipping
to [1e-5, 1e4], group reshape with zero padding, and the dynamic fake quant
of activations and attention tensors (`fake_quant_dynamic`, incl. the
`fix0to1` softmax metric). `torch.round` rounds half to even, as
`jnp.round` does. The straight-through estimator and learnable weight
clipping belong to training and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.kvcache import true_div

CLIPMIN = 1e-5
CLIPMAX = 1e4


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of a quantization scheme."""

    n_bits: int = 8
    symmetric: bool = False
    #: per-group quantization along the last axis; None = whole axis
    group_size: Optional[int] = None
    #: signed integer range without a zero point
    disable_zero_point: bool = False
    #: "minmax" (dynamic calibration) or "fix0to1" (softmax probabilities
    #: on the fixed grid k / (2^n - 1))
    metric: str = "minmax"

    def __post_init__(self):
        if not (1 <= self.n_bits <= 16):
            raise ValueError(f"bitwidth {self.n_bits} not supported")

    @property
    def qmin(self) -> int:
        if self.disable_zero_point:
            return -(2 ** (self.n_bits - 1))
        return 0

    @property
    def qmax(self) -> int:
        if self.disable_zero_point:
            return 2 ** (self.n_bits - 1) - 1
        return 2**self.n_bits - 1

    @property
    def enabled(self) -> bool:
        return self.n_bits < 16


def _group_reshape(x: torch.Tensor, group_size: int) -> Tuple[torch.Tensor, int]:
    """(..., d) -> (..., ceil(d/gs), gs), zero-padding the tail."""
    d = x.shape[-1]
    pad = (-d) % group_size
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, group_size), pad


def scale_zp_from_minmax(
    xmin: torch.Tensor, xmax: torch.Tensor, spec: QuantSpec
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(scale, round_zero_point) from reduced min/max statistics."""
    if spec.symmetric or spec.disable_zero_point:
        abs_max = torch.maximum(xmax.abs(), xmin.abs())
        scale = (abs_max / (2 ** (spec.n_bits - 1) - 1)).clamp(CLIPMIN, CLIPMAX)
        if spec.disable_zero_point:
            return scale, None
        return scale, torch.full_like(scale, 2 ** (spec.n_bits - 1) - 1)
    scale = ((xmax - xmin) / (2**spec.n_bits - 1)).clamp(CLIPMIN, CLIPMAX)
    zp = torch.round((-xmin / scale).clamp(-CLIPMAX, CLIPMAX))
    return scale, zp


def minmax_scale_zp(
    x: torch.Tensor, spec: QuantSpec
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dynamic min/max calibration over the last axis (or its groups).

    The returned tensors keep the reduced axis so they broadcast against
    the grouped view of `x`."""
    if spec.group_size:
        x, _ = _group_reshape(x, spec.group_size)
    xmin = x.amin(dim=-1, keepdim=True)
    xmax = x.amax(dim=-1, keepdim=True)
    return scale_zp_from_minmax(xmin, xmax, spec)


def fake_quant(
    x: torch.Tensor,
    scale: torch.Tensor,
    round_zp: Optional[torch.Tensor],
    spec: QuantSpec,
) -> torch.Tensor:
    """Quantize-dequantize with given parameters."""
    orig_shape = x.shape
    pad = 0
    if spec.group_size:
        x, pad = _group_reshape(x, spec.group_size)
    x_int = torch.round(x / scale)
    if round_zp is not None:
        x_int = x_int + round_zp
    x_int = x_int.clamp(float(spec.qmin), float(spec.qmax))
    x_dq = x_int - round_zp if round_zp is not None else x_int
    x_dq = x_dq * scale
    if spec.group_size:
        x_dq = x_dq.reshape(*orig_shape[:-1], -1)
        if pad:
            x_dq = x_dq[..., : orig_shape[-1]]
    return x_dq


def fake_quant_dynamic(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Dynamic-calibration fake quant (`quantizer.py:196-212`): min/max of
    the last axis (or its groups), then quantize-dequantize; `fix0to1`
    rounds to the fixed grid k / (2^n - 1) instead. Disabled specs (16 bits)
    pass `x` through."""
    if not spec.enabled:
        return x
    if spec.metric == "fix0to1":
        levels = 2**spec.n_bits - 1
        return true_div(torch.round(x * levels), float(levels))
    scale, zp = minmax_scale_zp(x, spec)
    return fake_quant(x, scale, zp, spec)
