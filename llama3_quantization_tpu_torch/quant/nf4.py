"""NF4 codebook quantization and double-quantized statistics (port of
`llama3_quantization_tpu/quant/nf4.py`).

Block-64 normal-float-4 codebook quantization with a per-block absmax, the
absmax itself optionally double-quantized (dynamic-FP8 codebook, mean
offset, per-256 group scale), as bitsandbytes stores it for IR-QLoRA. The
codebooks are built with numpy and held bit-equal to JAX's by
`tests/test_torch_nf4_irqlora.py`.

`quantize_to_codebook` is JAX's `argmin |x - code|` (first minimum on
ties) computed as a `torch.bucketize` over each pair of neighbours' flip
point: the least float32 `x` whose rounded distance to the upper code is
below its rounded distance to the lower one, found on the host from the
same float32 subtractions. It needs no `[..., len(code)]` temporary; a
test holds it equal to the argmin on random values and on every float
within 64 ulps of each flip point.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

#: the QLoRA NF4 data type: quantiles of N(0,1) normalized to [-1, 1]
_NF4_VALUES = [
    -1.0,
    -0.6961928009986877,
    -0.5250730514526367,
    -0.39491748809814453,
    -0.28444138169288635,
    -0.18477343022823334,
    -0.09105003625154495,
    0.0,
    0.07958029955625534,
    0.16093020141124725,
    0.24611230194568634,
    0.33791524171829224,
    0.44070982933044434,
    0.5626170039176941,
    0.7229568362236023,
    1.0,
]
NF4_CODE = torch.tensor(_NF4_VALUES, dtype=torch.float32)


def make_dynamic_map(signed: bool = True, max_exponent_bits: int = 7, total_bits: int = 8):
    """bitsandbytes' dynamic 8-bit codebook (`create_dynamic_map`) that
    stores IR-QLoRA's tau, with the JAX package's deliberate divergence:
    the unsigned map spends the freed sign bit on one more fraction bit and
    shrinks the additional-items block, so it has exactly 2**total_bits
    entries (`nf4.py:45-81`)."""
    data = []
    non_sign_bits = total_bits - (1 if signed else 0)
    additional_exp = non_sign_bits - max_exponent_bits - (0 if signed else 1)
    additional_items = 2**additional_exp - 1 if additional_exp >= 0 else 0
    for i in range(max_exponent_bits):
        fraction_items = int(2 ** (i + non_sign_bits - max_exponent_bits) + 1)
        boundaries = np.linspace(0.1, 1, fraction_items)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        data += ((10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()
        if signed:
            data += (-(10 ** (-(max_exponent_bits - 1) + i)) * means).tolist()
    if additional_items > 0:
        boundaries = np.linspace(0.1, 1, additional_items + 1)
        means = (boundaries[:-1] + boundaries[1:]) / 2.0
        data += ((10 ** (-(max_exponent_bits - 1) + max_exponent_bits - 1)) * means).tolist()
        if signed:
            data += (
                -(10 ** (-(max_exponent_bits - 1) + max_exponent_bits - 1)) * means
            ).tolist()
    data.append(0)
    data.append(1.0)
    data.sort()
    if len(data) > 2**total_bits:
        raise ValueError(
            f"dynamic map has {len(data)} entries > {2**total_bits} codes; "
            "reduce max_exponent_bits (unsigned maps need more fraction space)"
        )
    return torch.tensor(data, dtype=torch.float32)


DYNAMIC_FP8_MAP = make_dynamic_map()


def _upper_wins(x: np.float32, lo: np.float32, hi: np.float32) -> bool:
    """Is `hi` strictly nearer `x` than `lo` in float32 (ties keep `lo`)?"""
    return bool(np.abs(np.float32(x - hi)) < np.abs(np.float32(x - lo)))


@functools.lru_cache(maxsize=None)
def _flip_points(code_bytes: bytes) -> np.ndarray:
    """For each pair of neighbouring codes, the least float32 in between
    that the argmin sends to the upper one (the predicate is monotone there:
    one rounded distance grows with x, the other shrinks)."""
    code = np.frombuffer(code_bytes, dtype=np.float32)
    flips = []
    with np.errstate(over="ignore"):
        for lo, hi in zip(code[:-1], code[1:]):
            x = np.float32((np.float64(lo) + np.float64(hi)) / 2)
            while x > lo and _upper_wins(np.nextafter(x, lo), lo, hi):
                x = np.nextafter(x, lo)
            while not _upper_wins(x, lo, hi):
                x = np.nextafter(x, hi)
            flips.append(x)
    return np.asarray(flips, dtype=np.float32)


def codebook_flips(code: torch.Tensor) -> torch.Tensor:
    """`code`'s flip points (see the module docstring), on `code`'s device."""
    host = code.detach().to("cpu", torch.float32).contiguous().numpy()
    if np.any(np.diff(host) <= 0):
        raise ValueError("a codebook must be strictly increasing")
    return torch.from_numpy(_flip_points(host.tobytes()).copy()).to(code.device)


def quantize_to_codebook(x: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook-entry indices, the first on ties (`nf4.py:87-90`)."""
    flips = codebook_flips(code).to(x.device)
    return torch.bucketize(x.float(), flips, right=True).to(torch.uint8)


def dequantize_codebook(idx: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    return code.to(idx.device)[idx.long()]


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`a * b + c` with one rounding to float32, where XLA's CPU code
    contracts a multiply-add (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


@dataclasses.dataclass
class NF4Tensor:
    """Block-quantized NF4 weight: codes packed 2 a byte along the
    flattened elements; absmax per block (double-quantized: uint8 codes of
    the dynamic map, with a per-256 group scale and a mean offset)."""

    packed: torch.Tensor  # uint8 [numel/2]
    absmax: torch.Tensor  # f32 [nblocks], or uint8 codes when double-quantized
    absmax_scale: Optional[torch.Tensor]  # f32 [nblocks/256] when double-quantized
    absmax_mean: Optional[torch.Tensor]  # f32 [] per-tensor offset (double quant)
    shape: tuple = ()
    block_size: int = 64


def nf4_quantize(w: torch.Tensor, block_size: int = 64, double_quant: bool = True) -> NF4Tensor:
    """`nf4.py:115-139`: pad to whole blocks (bnb pads too; dequant slices
    back), NF4 codes packed high nibble first, optional double quant."""
    from ..ops.kvcache import true_div

    flat1 = w.float().reshape(-1)
    pad = (-flat1.shape[0]) % block_size
    if pad:
        flat1 = torch.cat([flat1, flat1.new_zeros(pad)])
    flat = flat1.reshape(-1, block_size)
    absmax = flat.abs().amax(dim=1)
    scaled = flat / absmax[:, None].clamp(min=1e-12)
    codes = quantize_to_codebook(scaled, NF4_CODE).reshape(-1)
    packed = (codes[0::2] << 4) | codes[1::2]
    if double_quant:
        amean = true_div(absmax.sum(), absmax.shape[0])
        centered = absmax - amean
        gsize = min(256, centered.shape[0])
        gpad = (-centered.shape[0]) % gsize
        if gpad:
            centered = torch.cat([centered, centered.new_zeros(gpad)])
        g = centered.reshape(-1, gsize)
        gmax = g.abs().amax(dim=1, keepdim=True)
        acodes = quantize_to_codebook(g / gmax.clamp(min=1e-12), DYNAMIC_FP8_MAP)
        return NF4Tensor(packed, acodes.reshape(-1), gmax[:, 0], amean, tuple(w.shape),
                         block_size)
    return NF4Tensor(packed, absmax, None, None, tuple(w.shape), block_size)


def nf4_codes(t: NF4Tensor) -> torch.Tensor:
    """Unpacked 4-bit code stream (for entropy evaluation)."""
    hi = (t.packed >> 4).long()
    lo = (t.packed & 0xF).long()
    return torch.stack([hi, lo], dim=1).reshape(-1)


def nf4_dequantize(t: NF4Tensor) -> torch.Tensor:
    """`nf4.py:142-160`."""
    vals = NF4_CODE.to(t.packed.device)[nf4_codes(t)]
    if t.absmax_scale is not None:
        g = t.absmax.reshape(t.absmax_scale.shape[0], -1)
        absmax = fma32(dequantize_codebook(g, DYNAMIC_FP8_MAP), t.absmax_scale[:, None],
                       t.absmax_mean).reshape(-1)
    else:
        absmax = t.absmax
    blocks = vals.reshape(-1, t.block_size)
    out = blocks * absmax[: blocks.shape[0], None]
    numel = 1
    for d in t.shape:
        numel *= d
    return out.reshape(-1)[:numel].reshape(t.shape)
