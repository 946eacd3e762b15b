"""Sub-byte weight packing (port of `llama3_quantization_tpu/quant/pack.py`).

Weights are stored `[K, N]` (contraction axis first). For `bits in {2, 4}`,
`f = 8 // bits` values share one uint8 byte, and packing is **group-local**:
within each group of `gs` rows, byte row `j` holds rows `s * (gs // f) + j`
in bit field `[s * bits, (s + 1) * bits)`. Adjacent rows therefore do NOT
share a byte. 3-bit codes use bit planes `[3 * K / 8, N]`: plane `b` holds
bit `b` of eight consecutive rows per byte. 8-bit codes are one per byte.
"""

from __future__ import annotations

from typing import Optional

import torch


def pack_factor(bits: int) -> int:
    """Values per byte for the nibble scheme (1 for bits not in {2, 4})."""
    return 8 // bits if bits in (2, 4) else 1


def packed_rows(k: int, bits: int) -> int:
    """Packed byte-rows for a K-row code matrix."""
    if bits in (2, 4):
        return k // (8 // bits)
    if bits == 3:
        return 3 * k // 8
    return k


def _pack_planes(q: torch.Tensor, bits: int) -> torch.Tensor:
    k, n = q.shape
    if k % 8:
        raise ValueError(f"K={k} must be a multiple of 8 for plane packing")
    weights = (1 << torch.arange(8, device=q.device, dtype=torch.int32))
    q32 = q.to(torch.int32)
    planes = []
    for b in range(bits):
        bit = ((q32 >> b) & 1).reshape(k // 8, 8, n)
        planes.append((bit * weights[None, :, None]).sum(dim=1).to(torch.uint8))
    return torch.cat(planes, dim=0)  # [bits*K/8, N]


def _unpack_planes(packed: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    n = packed.shape[-1]
    planes = packed.reshape(bits, k // 8, n).to(torch.int32)
    shifts = torch.arange(8, device=packed.device, dtype=torch.int32)
    out = torch.zeros((k // 8, 8, n), dtype=torch.int32, device=packed.device)
    for b in range(bits):
        bit = (planes[b][:, None, :] >> shifts[None, :, None]) & 1
        out |= bit << b
    return out.reshape(k, n).to(torch.uint8)


def _group_view(k: int, group_size: Optional[int]) -> int:
    gs = group_size or k
    if k % gs:
        raise ValueError(f"K={k} not a multiple of group_size={gs}")
    return gs


def pack_subbyte(q: torch.Tensor, bits: int, group_size: Optional[int] = None) -> torch.Tensor:
    """Pack unsigned codes `q[K, N]` (values in [0, 2^bits)) into uint8."""
    f = pack_factor(bits)
    if bits == 3:
        return _pack_planes(q.to(torch.uint8), bits)
    if f == 1:
        return q.to(torch.uint8)
    k, n = q.shape
    gs = _group_view(k, group_size)
    if gs % f:
        raise ValueError(f"group_size={gs} must be a multiple of {f} for {bits}-bit packing")
    sub = gs // f
    qg = q.to(torch.uint8).reshape(k // gs, f, sub, n)
    packed = torch.zeros((k // gs, sub, n), dtype=torch.uint8, device=q.device)
    for s in range(f):
        packed |= qg[:, s] << (s * bits)
    return packed.reshape(k // f, n)


def unpack_subbyte(
    packed: torch.Tensor, bits: int, k: int, group_size: Optional[int] = None
) -> torch.Tensor:
    """Inverse of `pack_subbyte`: packed bytes -> uint8 codes `[K, N]`."""
    f = pack_factor(bits)
    if bits == 3:
        return _unpack_planes(packed, bits, k)
    if f == 1:
        return packed
    gs = _group_view(k, group_size)
    sub = gs // f
    n = packed.shape[-1]
    pg = packed.reshape(k // gs, sub, n)
    mask = 2**bits - 1
    parts = [(pg >> (s * bits)) & mask for s in range(f)]
    return torch.stack(parts, dim=1).reshape(k, n)
