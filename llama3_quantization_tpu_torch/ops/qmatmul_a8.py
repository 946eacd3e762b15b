"""W·A8 integer matmul: kernel B3 (`csrc/qmatmul_a8.cu`).

Port of the function the JAX package computes in three places:
`_qmm_v3_kernel` (`ops/pallas_qmatmul.py:268-320`, `fused_dequant_matmul`
with version 3), `s4w_matmul` (`ops/s4_matmul.py:186-261`, the s4 backend)
and `a8_matmul` (`ops/a8_matmul.py:76-124`, the a8 backend). Activations are
quantized per token to s8 (`quantize_activations_s8`, the KV cache's
`kv_quantize`), and

    y = s_x * sum_g s_g * (xq_g . c_g - xsum_g * z_g)

with s32 dots and activation sums per group, then an fp32 epilogue per
group. Every per-group integer is exact, so the three JAX formats differ
only in the fp32 order of the sum over groups. The port sums groups in
order, one rounding per operation, in the kernel and in its plain version
alike (`a8_plain`, whose s32 partials come from exact float64 dots).

Weights reach B3 as codes in one of five layouts (`LAYOUTS`): int8
containers ("s8"), unpacked unsigned 8-bit codes ("u8", what
`quantize_rtn(bits=8, pack=True)` stores; the dot is the exact promoted one
of JAX's `a8_matmul`), the packed unsigned 4/2-bit codes of `quant/pack.py`
("u4", "u2") or the s4 backend's signed 4-bit storage ("s4", see
`ops/s4_matmul.py`). The zero point is fp32 `[G, N]`, int8 `[G, N]` or
None. M <= 64 takes the GEMV form (counted per caller: "B3.v3", "B3.s4",
"B3.s8"); M > 64 the tiled form ("B3.gemm"). CPU tensors take the plain
version; CUDA tensors take the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..quant.pack import unpack_subbyte
from . import _build
from ._build import GEMV_MAX_M, TARGET_BLOCKS
from .kvcache import kv_quantize
from .launches import COUNTS

#: layout name -> (kernel code, values per byte, bits of the unpacked codes)
LAYOUTS = {"s8": (0, 1, 8), "u4": (1, 2, 4), "s4": (2, 2, 4), "u2": (3, 4, 2), "u8": (4, 1, 8)}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("qmatmul_a8")
    if not getattr(lib, "_l3q_typed", False):
        lib.l3q_a8_gemv.argtypes = [_P] * 6 + [_I, _P, _P] + [_I] * 10 + [_P]
        lib.l3q_a8_gemv.restype = _I
        lib.l3q_a8_gemm.argtypes = [_P] * 4 + [_I, _P, _P] + [_I] * 6 + [_P]
        lib.l3q_a8_gemm.restype = _I
        lib._l3q_typed = True
    return lib


def quantize_activations_s8(x: torch.Tensor):
    """Per-row (token) symmetric int8: (xq int8, scale f32 [..., 1]). The KV
    cache's `kv_quantize`, shared as the JAX package shares it
    (`a8_matmul.py:29-36`)."""
    return kv_quantize(x)


def codes_of(data: torch.Tensor, layout: str, k: int, gs: int) -> torch.Tensor:
    """Integer codes `[K, N]` of a weight in `layout`."""
    if layout in ("s8", "u8"):
        return data
    bits = LAYOUTS[layout][2]
    codes = unpack_subbyte(data, bits, k, gs)
    if layout == "s4":
        return (codes ^ 8).to(torch.int16) - 8
    return codes


def group_partials(xq: torch.Tensor, codes: torch.Tensor, gs: int):
    """The s32 integers of B3: dots `[G, M, N]` and activation sums `[M, G]`
    of each group, formed in float64 (exact: every partial is an integer
    below 2^53)."""
    m, k = xq.shape
    x3 = xq.double().reshape(m, k // gs, gs)
    dots = [x3[:, gi] @ codes[gi * gs:(gi + 1) * gs].double() for gi in range(k // gs)]
    return torch.stack(dots), x3.sum(dim=-1)


def a8_plain(xq, s_x, data, layout, scale, zero, gs: int, out_dtype) -> torch.Tensor:
    """B3's function with its rounding points: the exact group partials,
    then `acc += (f32(dot) - f32(xsum) * z) * s` over groups in order,
    `* s_x`."""
    dots, xsum = group_partials(xq, codes_of(data, layout, xq.shape[1], gs), gs)
    dots, xsum = dots.float(), xsum.float()
    acc = torch.zeros(dots.shape[1:], dtype=torch.float32, device=xq.device)
    for gi in range(dots.shape[0]):
        t = dots[gi]
        if zero is not None:
            t = t - xsum[:, gi:gi + 1] * zero[gi].float()
        acc = acc + t * scale[gi]
    return (acc * s_x).to(out_dtype)


def _check(xq, s_x, data, layout, scale, zero, gs: int) -> int:
    """Validate B3's operands on the card; return the pack factor."""
    m, k = xq.shape
    f = LAYOUTS[layout][1]
    n = data.shape[-1]
    dev = xq.device
    want = torch.int8 if layout == "s8" else torch.uint8
    if data.dtype != want:
        raise TypeError(f"B3 {layout} codes must be {want}, got {data.dtype}")
    if tuple(data.shape) != (k // f, n):
        raise ValueError(f"codes shape {tuple(data.shape)} != {(k // f, n)}")
    if k % gs or gs % f:
        raise ValueError(f"K={k}, group_size={gs} and pack factor {f} do not tile")
    g = k // gs
    if scale.dtype != torch.float32 or tuple(scale.shape) != (g, n):
        raise ValueError(f"scale must be float32 [{g}, {n}]")
    if zero is not None and (zero.dtype not in (torch.float32, torch.int8)
                             or tuple(zero.shape) != (g, n)):
        raise ValueError(f"zero must be float32 or int8 [{g}, {n}]")
    if xq.dtype != torch.int8 or s_x.dtype != torch.float32 or tuple(s_x.shape) != (m, 1):
        raise TypeError("activations must be int8 [M, K] with float32 scales [M, 1]")
    for name, t in (("xq", xq), ("s_x", s_x), ("codes", data), ("scale", scale), ("zero", zero)):
        if t is not None and (not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be contiguous on {dev}")
    return f


def _zmode(zero) -> int:
    if zero is None:
        return 0
    return 1 if zero.dtype == torch.float32 else 2


def gemv_split(k: int, n: int, m: int, gs: int, f: int):
    """(rc, seg, mt) of the GEMV form: byte rows per warp (16, 8 or 4: the
    largest that still gives the card enough blocks), the byte rows of one
    summed segment (a group, or 8 warps' rows inside one) and the rows per
    M tile (1, 2 or 4)."""
    rows, sub = k // f, gs // f
    mt = 1 if m == 1 else 2 if m == 2 else 4

    def tiles_group(r):  # 8 warps of r rows cover whole segments of one group
        return sub % (8 * r) == 0 if sub >= 8 * r else sub % r == 0 and (8 * r) % sub == 0

    ok = [r for r in (16, 8, 4) if tiles_group(r)]
    if not ok:
        raise ValueError(f"B3 needs group_size / {f} a multiple of 4, got {gs}")
    tiles = -(-n // 512) * -(-m // mt)
    rc = next((r for r in ok if tiles * -(-rows // (8 * r)) >= TARGET_BLOCKS), ok[-1])
    return rc, min(sub, 8 * rc), mt


def a8_gemv(xq, s_x, data, layout, scale, zero, gs: int, out_dtype, key: str) -> torch.Tensor:
    """B3's GEMV form on the card (M <= 64); counts one launch under `key`."""
    f = _check(xq, s_x, data, layout, scale, zero, gs)
    m, k = xq.shape
    n = data.shape[-1]
    if n % 16 or k % 4:
        raise ValueError(f"B3's GEMV form needs N % 16 == 0 and K % 4 == 0, got {k}, {n}")
    rc, seg, mt = gemv_split(k, n, m, gs, f)
    ysplit = -(-(k // f) // (8 * rc))
    chunks = ysplit * (8 * rc // seg)
    part = torch.empty((chunks, m, n), dtype=torch.int32, device=xq.device)
    xpart = torch.empty((chunks, m), dtype=torch.int32, device=xq.device)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    err = _lib().l3q_a8_gemv(
        xq.data_ptr(), data.data_ptr(), part.data_ptr(), xpart.data_ptr(), scale.data_ptr(),
        None if zero is None else zero.data_ptr(), _zmode(zero), s_x.data_ptr(), out.data_ptr(),
        _build.out_flag(out_dtype), m, k, n, gs, LAYOUTS[layout][0], rc, seg, ysplit, mt,
        _build.stream_ptr(xq.device),
    )
    _build.check(err, f"a8_gemv ({key})")
    COUNTS[key] += 1
    return out


def a8_gemm(xq, s_x, data, layout, scale, zero, gs: int, out_dtype) -> torch.Tensor:
    """B3's tiled form on the card (M > 64)."""
    _check(xq, s_x, data, layout, scale, zero, gs)
    m, k = xq.shape
    n = data.shape[-1]
    if k % 32 or gs % 32:
        raise ValueError(f"B3's tiled form needs K and group_size multiples of 32, got {k}, {gs}")
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    err = _lib().l3q_a8_gemm(
        xq.data_ptr(), data.data_ptr(), scale.data_ptr(),
        None if zero is None else zero.data_ptr(), _zmode(zero), s_x.data_ptr(), out.data_ptr(),
        _build.out_flag(out_dtype), m, k, n, gs, LAYOUTS[layout][0], _build.stream_ptr(xq.device),
    )
    _build.check(err, "a8_gemm (B3.gemm)")
    COUNTS["B3.gemm"] += 1
    return out


def w_a8_matmul(
    x2d: torch.Tensor,
    data: torch.Tensor,
    layout: str,
    scale: torch.Tensor,
    zero: Optional[torch.Tensor],
    gs: int,
    out_dtype,
    key: str,
) -> torch.Tensor:
    """`[M, K] x -> [M, N]` through B3: x quantized per token to s8, then
    the integer matmul on `data` in `layout`. CPU tensors take the plain
    version; CUDA tensors the GEMV form (M <= 64, counted under `key`) or
    the tiled form."""
    xq, s_x = quantize_activations_s8(x2d)
    if x2d.device.type == "cpu":
        return a8_plain(xq, s_x, data, layout, scale, zero, gs, out_dtype)
    if x2d.device.type != "cuda":
        raise ValueError(f"unsupported device {x2d.device}")
    if xq.shape[0] <= GEMV_MAX_M:
        return a8_gemv(xq, s_x, data, layout, scale, zero, gs, out_dtype, key)
    return a8_gemm(xq, s_x, data, layout, scale, zero, gs, out_dtype)
