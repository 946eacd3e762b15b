"""QuantizedTensor (port of `llama3_quantization_tpu/quant/qtensor.py`).

Layout: weights are `[K, N]` (in-features first) so the forward is
`y = x @ W`; groups run along K; scales and zero points are `[G, N]`.
A layer-stacked tensor carries a leading `[L]` axis on `data`, `scale`,
`zero` and `g_idx`, with `k` and `n` still naming one layer's shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .pack import pack_subbyte, unpack_subbyte
from .quantizer import QuantSpec, minmax_scale_zp


@dataclasses.dataclass
class QuantizedTensor:
    """Packed integer weight + grouped dequant parameters.

    data:  uint8 `[K/f, N]` when `packed` else int8/uint8 codes `[K, N]`
    scale: `[G, N]` float32
    zero:  `[G, N]` float32 integer-valued zero point, or None (signed
           codes without a zero point)
    g_idx: optional `[K]` int32 column -> group map (act-order grouping);
           such tensors ride the dequant path
    """

    data: torch.Tensor
    scale: torch.Tensor
    zero: Optional[torch.Tensor]
    bits: int = 4
    group_size: Optional[int] = None
    sym: bool = False
    k: int = 0
    n: int = 0
    packed: bool = False
    out_dtype: torch.dtype = torch.bfloat16
    g_idx: Optional[torch.Tensor] = None

    @property
    def num_groups(self) -> int:
        return self.scale.shape[-2]

    def layer(self, i: int) -> "QuantizedTensor":
        """Layer `i` of a layer-stacked tensor (views, no copy)."""
        return dataclasses.replace(
            self,
            data=self.data[i],
            scale=self.scale[i],
            zero=None if self.zero is None else self.zero[i],
            g_idx=None if self.g_idx is None else self.g_idx[i],
        )


def _codes(qt: QuantizedTensor) -> torch.Tensor:
    if qt.packed:
        return unpack_subbyte(qt.data, qt.bits, qt.k, qt.group_size)
    return qt.data


def dequantize(qt: QuantizedTensor, dtype=None) -> torch.Tensor:
    """Codes -> real weights `[K, N]`: `(q - zero) * scale` per group, in fp32
    then cast to `dtype` (default `qt.out_dtype`)."""
    dtype = dtype or qt.out_dtype
    q = _codes(qt)
    if qt.g_idx is not None:
        gi = qt.g_idx.long()
        qf = q.float()
        if qt.zero is not None:
            qf = qf - qt.zero[gi]
        return (qf * qt.scale[gi]).to(dtype)
    gs = qt.group_size or qt.k
    qg = q.reshape(qt.num_groups, gs, qt.n).float()
    if qt.zero is not None:
        qg = qg - qt.zero[:, None, :]
    w = qg * qt.scale[:, None, :]
    return w.reshape(qt.k, qt.n).to(dtype)


def _float_or_bf16(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype.is_floating_point else torch.bfloat16


def quantize_rtn(
    w: torch.Tensor,
    spec: QuantSpec,
    pack: bool = False,
    lwc_up: Optional[torch.Tensor] = None,
    lwc_low: Optional[torch.Tensor] = None,
) -> QuantizedTensor:
    """Round-to-nearest real quantization of a `[K, N]` weight; under
    `spec.lwc` the ranges are clipped by the LWC logits (`[N, G, 1]` or
    `[N, 1]`, as `quantizer.lwc_init` makes them)."""
    k, n = w.shape
    if not spec.enabled:
        raise ValueError("n_bits >= 16 disables quantization; keep the fp weight")
    if spec.n_bits > 8:
        raise NotImplementedError(f"{spec.n_bits}-bit codes exceed int8 storage")
    gs = spec.group_size or k
    if k % gs:
        raise ValueError(f"K={k} not divisible by group_size={gs}")
    wt = w.float().T  # [N, K]
    scale, zp = minmax_scale_zp(wt, spec, lwc_up, lwc_low)  # [N, G, 1] or [N, 1]
    grouped = wt.reshape(n, k // gs, gs)
    q = torch.round(grouped / scale.reshape(n, -1, 1))
    if zp is not None:
        q = q + zp.reshape(n, -1, 1)
    q = q.clamp(spec.qmin, spec.qmax)
    scale_gn = scale.reshape(n, -1).T.contiguous()  # [G, N]
    zero_gn = zp.reshape(n, -1).T.contiguous() if zp is not None else None
    out_dtype = _float_or_bf16(w.dtype)
    codes_kn = q.reshape(n, k).T
    if not pack and zp is not None:
        # unpacked asym storage: centered signed int8 codes, zero shifted
        off = 2 ** (spec.n_bits - 1)
        return QuantizedTensor(
            data=(codes_kn - off).to(torch.int8).contiguous(),
            scale=scale_gn,
            zero=zero_gn - off,
            bits=spec.n_bits,
            group_size=spec.group_size,
            sym=False,
            k=k,
            n=n,
            packed=False,
            out_dtype=out_dtype,
        )
    code_dtype = torch.int8 if zp is None else torch.uint8
    codes = codes_kn.to(code_dtype).contiguous()
    packable = spec.n_bits in (2, 3, 4)
    if pack and zp is not None and packable:
        data, packed = pack_subbyte(codes, spec.n_bits, spec.group_size), True
    elif pack and zp is None and packable:
        # signed codes: bias into the unsigned range for packing
        biased = (codes_kn - spec.qmin).to(torch.uint8)
        data, packed = pack_subbyte(biased, spec.n_bits, spec.group_size), True
        zero_gn = torch.full((k // gs, n), float(-spec.qmin), dtype=torch.float32, device=w.device)
    else:
        data, packed = codes, False
    return QuantizedTensor(
        data=data,
        scale=scale_gn,
        zero=zero_gn,
        bits=spec.n_bits,
        group_size=spec.group_size,
        sym=spec.symmetric or spec.disable_zero_point,
        k=k,
        n=n,
        packed=packed,
        out_dtype=out_dtype,
    )


def from_codes(
    codes: torch.Tensor,
    scale: torch.Tensor,
    zero: Optional[torch.Tensor],
    spec: QuantSpec,
    pack: bool = False,
    out_dtype=torch.bfloat16,
    g_idx: Optional[torch.Tensor] = None,
) -> QuantizedTensor:
    """Build a QuantizedTensor from codes `[K, N]` and params `[G, N]`."""
    k, n = codes.shape
    if pack and zero is not None and spec.n_bits in (2, 3, 4):
        data = pack_subbyte(codes.to(torch.uint8), spec.n_bits, spec.group_size)
        packed = True
    elif zero is not None:
        off = 2 ** (spec.n_bits - 1)
        data = (codes.to(torch.int32) - off).to(torch.int8)
        zero = zero - off
        packed = False
    else:
        data, packed = codes, False
    return QuantizedTensor(
        data=data,
        scale=scale.float(),
        zero=None if zero is None else zero.float(),
        bits=spec.n_bits,
        group_size=spec.group_size,
        sym=zero is None,
        k=k,
        n=n,
        packed=packed,
        out_dtype=out_dtype,
        g_idx=None if g_idx is None else g_idx.to(torch.int32),
    )
