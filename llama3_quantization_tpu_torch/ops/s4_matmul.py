"""W4·A8 matmul on 4-bit weight storage: the s4 backend (port of
`llama3_quantization_tpu/ops/s4_matmul.py`).

`prepare_s4` turns a `QuantizedTensor` of codes up to 4 bits into an
`S4Weight`: signed 4-bit codes two per byte (code - 2^(bits-1) for packed
weights, the container value for unpacked ones) and the zero point as one
int8 per (group, column), `zero8 = round(zero - 2^(bits-1))`, as the JAX
`S4Weight` holds them. 2- and 3-bit codes are repacked into that 4-bit
storage. The nibble layout is the group-local one of `quant/pack.py`: byte
row j of group g holds rows g*gs + j (low nibble) and g*gs + gs/2 + j (high
nibble); a packed 4-bit weight keeps its bytes, each nibble flipped by
`^ 8`. `s4w_matmul` then runs kernel B3 (`ops/qmatmul_a8.py`, counted as
"B3.s4" at M <= 64) with s8 activations.

The JAX package reaches the same integers through the TPU's int4 MXU: a
block-diagonal operand (`_bd_parts`, `:171-183`) with optional K chunks
(`chunks`, `:116-125`) at decode, batched group dots at prefill. Those are
TPU schedules of one integer sum, which B3 computes directly; they are not
reproduced. Call `prepare_s4` (or `ops/matmul.prepare_decode_params`) once
outside a decode loop: it rewrites every weight byte.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..quant.pack import unpack_subbyte
from ..quant.qtensor import QuantizedTensor
from .qmatmul_a8 import w_a8_matmul


@dataclasses.dataclass
class S4Weight:
    """Decode-prepared weight: signed 4-bit codes `data4` uint8 `[..., K/2, N]`
    (group-local nibbles), fp32 `scale` `[..., G, N]` and the centered int8
    zero point `zero8` `[..., G, N]` or None. A leading `[L]` axis stacks
    layers, as on `QuantizedTensor`."""

    data4: torch.Tensor
    scale: torch.Tensor
    zero8: Optional[torch.Tensor]
    bits: int = 4
    group_size: Optional[int] = None
    k: int = 0
    n: int = 0
    out_dtype: torch.dtype = torch.bfloat16

    def layer(self, i: int) -> "S4Weight":
        """Layer `i` of a layer-stacked weight (views, no copy)."""
        return dataclasses.replace(
            self, data4=self.data4[i], scale=self.scale[i],
            zero8=None if self.zero8 is None else self.zero8[i],
        )


def _pack_signed_nibbles(codes: torch.Tensor, gs: int) -> torch.Tensor:
    """Signed codes `[..., K, N]` in [-8, 7] -> uint8 `[..., K/2, N]`, group-local."""
    *lead, k, n = codes.shape
    c = (codes.to(torch.int16) & 0xF).to(torch.uint8).reshape(*lead, k // gs, 2, gs // 2, n)
    return (c[..., 0, :, :] | (c[..., 1, :, :] << 4)).reshape(*lead, k // 2, n)


def _signed_codes(qt: QuantizedTensor) -> torch.Tensor:
    """Codes `[..., K, N]` centered by 2^(bits-1) when packed (int16)."""
    if not qt.packed:
        return qt.data
    flat = qt.data.reshape(-1, *qt.data.shape[-2:])
    codes = torch.stack([unpack_subbyte(d, qt.bits, qt.k, qt.group_size) for d in flat])
    codes = codes.reshape(*qt.data.shape[:-2], qt.k, qt.n)
    return codes.to(torch.int16) - (1 << (qt.bits - 1))


def prepare_s4(qt: QuantizedTensor) -> S4Weight:
    """Container codes -> 4-bit storage + int8 centered zero point, for a
    tensor with or without leading layer axes (`s4_matmul.py:128-168`)."""
    if qt.bits > 4:
        raise ValueError(f"s4 path requires bits <= 4, got {qt.bits}")
    if qt.g_idx is not None:
        raise ValueError("act-order (g_idx) weights have no s4 form")
    gs = qt.group_size or qt.k
    if qt.packed and qt.bits == 4:
        data4 = qt.data ^ 0x88  # c - 8 in two's complement, per nibble
    else:
        data4 = _pack_signed_nibbles(_signed_codes(qt), gs)
    off = (1 << (qt.bits - 1)) if qt.packed else 0
    # zero is integer-valued; centered |zero - off| <= 2^(bits-1) fits int8
    zero8 = None if qt.zero is None else torch.round(qt.zero - off).to(torch.int8)
    return S4Weight(data4=data4.contiguous(), scale=qt.scale, zero8=zero8, bits=qt.bits,
                    group_size=qt.group_size, k=qt.k, n=qt.n, out_dtype=qt.out_dtype)


def s4w_matmul(x: torch.Tensor, w: S4Weight, out_dtype=None) -> torch.Tensor:
    """`x @ dequant(w)` with s8 activations through B3."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    y = w_a8_matmul(x.reshape(-1, w.k), w.data4, "s4", w.scale, w.zero8,
                    w.group_size or w.k, out_dtype, "B3.s4")
    return y.reshape(*lead, w.n)


def s4_matmul(x: torch.Tensor, qt: QuantizedTensor, out_dtype=None) -> torch.Tensor:
    """One-shot prepare + matmul. In decode loops call `prepare_s4` once
    outside the loop instead."""
    return s4w_matmul(x, prepare_s4(qt), out_dtype=out_dtype)
