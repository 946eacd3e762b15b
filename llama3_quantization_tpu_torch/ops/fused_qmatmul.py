"""Fused dequant-matmul `y = x @ dequant(W)`: kernels B1, B2 and B3.

Port of `llama3_quantization_tpu/ops/pallas_qmatmul.fused_dequant_matmul`.
B1 (`csrc/qmatmul.cu` `qmm_gemv_kernel`, the TPU `_qmm_v2_kernel`) serves
M <= 64 and applies scale and zero after the dot; B2 (`qmm_gemm_kernel`,
the TPU `_qmm_kernel` v1) serves M > 64 and dequantizes each weight tile
to bf16 before a bf16 MMA. Both cast x to bf16 and accumulate in fp32.
3-bit bit-plane weights always take B2, as the TPU wrapper sends them to v1.
`version=3` (or `L3Q_QMM_V=3`, read as JAX reads it) takes B3, the W·A8
integer kernel of `ops/qmatmul_a8.py`, on the packed weight and its fp32
zero point.

Each kernel has a plain PyTorch version here with the same rounding points
(`qmm_gemv_plain`, `qmm_gemm_plain`). The wrapper uses it for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..quant.pack import pack_factor, unpack_subbyte
from ..quant.qtensor import QuantizedTensor
from . import _build
from ._build import GEMV_MAX_M, TARGET_BLOCKS
from .launches import COUNTS
from .qmatmul_a8 import w_a8_matmul

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("qmatmul")
    if not getattr(lib, "_l3q_typed", False):
        lib.l3q_qmm_gemv.argtypes = [_P] * 6 + [_I] * 10 + [_P]
        lib.l3q_qmm_gemv.restype = _I
        lib.l3q_qmm_gemm.argtypes = [_P] * 6 + [_I] * 8 + [_P]
        lib.l3q_qmm_gemm.restype = _I
        lib._l3q_typed = True
    return lib


def _codes(qt: QuantizedTensor) -> torch.Tensor:
    """Integer codes `[K, N]` as stored (uint8, or signed int8 unpacked)."""
    if qt.packed:
        return unpack_subbyte(qt.data, qt.bits, qt.k, qt.group_size)
    return qt.data


def qmm_gemv_plain(x2d: torch.Tensor, qt: QuantizedTensor, out_dtype) -> torch.Tensor:
    """B1's function: `sum_g s_g * (x_g @ c_g) - s_g * z_g * sum(x_g)` with
    x rounded to bf16 and fp32 dots (pallas_qmatmul.py:214-233)."""
    gs = qt.group_size or qt.k
    g = qt.k // gs
    m = x2d.shape[0]
    x3 = x2d.to(torch.bfloat16).float().reshape(m, g, gs)
    c3 = _codes(qt).float().reshape(g, gs, qt.n)
    dot = torch.einsum("mgk,gkn->mgn", x3, c3)
    xsum = x3.sum(dim=-1)
    acc = dot * qt.scale[None] - xsum[..., None] * (qt.zero * qt.scale)[None]
    return acc.sum(dim=1).to(out_dtype)


def dequant_bf16(qt: QuantizedTensor) -> torch.Tensor:
    """B2's weight: `(bf16(code) - bf16(zero)) * bf16(scale)` rounded to
    bf16 (pallas_qmatmul.py:84-100)."""
    gs = qt.group_size or qt.k
    codes = _codes(qt).to(torch.bfloat16)
    zero = qt.zero.to(torch.bfloat16).repeat_interleave(gs, dim=0)
    scale = qt.scale.to(torch.bfloat16).repeat_interleave(gs, dim=0)
    return (codes - zero) * scale


def qmm_gemm_plain(x2d: torch.Tensor, qt: QuantizedTensor, out_dtype) -> torch.Tensor:
    """B2's function: bf16(x) @ bf16-dequantized W with fp32 accumulation."""
    w = dequant_bf16(qt).float()
    return torch.matmul(x2d.to(torch.bfloat16).float(), w).to(out_dtype)


#: the kernels' layout code of 3-bit bit planes `[3, K/8, N]`
PLANES3 = 3


def _is_planes(qt: QuantizedTensor) -> bool:
    return qt.packed and qt.bits == 3


def _check_weight(qt: QuantizedTensor, device) -> int:
    """Validate a weight for the kernels; return its layout code: values per
    byte (4, 2, 1), or PLANES3 for 3-bit bit planes."""
    f = pack_factor(qt.bits) if qt.packed else 1
    gs = qt.group_size or qt.k
    g = qt.k // gs
    if qt.packed and qt.bits not in (2, 3, 4):
        raise NotImplementedError(f"{qt.bits}-bit packed weights have no CUDA kernel")
    if qt.data.dtype not in (torch.uint8, torch.int8) or (qt.packed and qt.data.dtype != torch.uint8):
        raise TypeError(f"weight codes must be uint8 (packed) or int8/uint8, got {qt.data.dtype}")
    rows = 3 * qt.k // 8 if _is_planes(qt) else qt.k // f
    if tuple(qt.data.shape) != (rows, qt.n) or (_is_planes(qt) and qt.k % 8):
        raise ValueError(f"codes shape {tuple(qt.data.shape)} != {(rows, qt.n)}")
    for name, t in (("scale", qt.scale), ("zero", qt.zero)):
        if t.dtype != torch.float32 or tuple(t.shape) != (g, qt.n):
            raise ValueError(f"{name} must be float32 [{g}, {qt.n}]")
        if not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name} must be contiguous on {device}")
    if not qt.data.is_contiguous() or qt.data.device != device:
        raise ValueError(f"codes must be contiguous on {device}")
    if qt.k % gs or gs % f:
        raise ValueError(f"K={qt.k}, group_size={gs} and pack factor {f} do not tile")
    return PLANES3 if _is_planes(qt) else f


def _scratch(ksplit: int, m: int, n: int, device):
    """fp32 partials of a K split (None when there is no split)."""
    if ksplit == 1:
        return None
    return torch.empty((ksplit, m, n), dtype=torch.float32, device=device)


def qmm_gemv(x2d: torch.Tensor, qt: QuantizedTensor, out_dtype) -> torch.Tensor:
    """Kernel B1 on the card (M <= 64)."""
    f = _check_weight(qt, x2d.device)
    if f == PLANES3:
        raise NotImplementedError("B1 has no 3-bit plane form; 3-bit weights take B2")
    if qt.n % 16:
        raise ValueError(f"B1 needs N % 16 == 0, got N={qt.n}")
    out_bf16 = _build.out_flag(out_dtype)
    m = x2d.shape[0]
    xb = x2d.to(torch.bfloat16).contiguous()
    out = torch.empty((m, qt.n), dtype=out_dtype, device=x2d.device)
    gs = qt.group_size or qt.k
    mt = 1 if m == 1 else 2 if m == 2 else 4
    rows, sub = qt.k // f, gs // f
    # byte rows per warp: the largest of 16, 8, 4, 2, 1 that divides the
    # group and still gives the card enough blocks
    col_tiles = -(-qt.n // 512) * -(-m // mt)
    rcs = [r for r in (16, 8, 4, 2, 1) if sub % r == 0]
    rc = next((r for r in rcs if col_tiles * -(-rows // (8 * r)) >= TARGET_BLOCKS), rcs[-1])
    ksplit = -(-rows // (8 * rc))
    part = _scratch(ksplit, m, qt.n, x2d.device)
    err = _lib().l3q_qmm_gemv(
        xb.data_ptr(), qt.data.data_ptr(), qt.scale.data_ptr(), qt.zero.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        m, qt.k, qt.n, gs, f, int(qt.data.dtype == torch.int8), out_bf16, ksplit, rc, mt,
        _build.stream_ptr(x2d.device),
    )
    _build.check(err, "qmm_gemv (B1)")
    COUNTS["B1"] += 1
    return out


def qmm_gemm(x2d: torch.Tensor, qt: QuantizedTensor, out_dtype) -> torch.Tensor:
    """Kernel B2 on the card (M > 64)."""
    f = _check_weight(qt, x2d.device)
    gs = qt.group_size or qt.k
    if qt.k % 32 or gs % 32:
        raise ValueError(f"B2 needs K and group_size multiples of 32, got {qt.k}, {gs}")
    out_bf16 = _build.out_flag(out_dtype)
    m = x2d.shape[0]
    xb = x2d.to(torch.bfloat16).contiguous()
    out = torch.empty((m, qt.n), dtype=out_dtype, device=x2d.device)
    # the K split follows (K, N) alone, so a row's result does not depend
    # on how many rows share the call (batch-invariant prefills)
    tiles = -(-qt.n // 64)
    ksplit = 1 if 2 * tiles >= TARGET_BLOCKS else min(-(-TARGET_BLOCKS // tiles), qt.k // 32)
    part = _scratch(ksplit, m, qt.n, x2d.device)
    err = _lib().l3q_qmm_gemm(
        xb.data_ptr(), qt.data.data_ptr(), qt.scale.data_ptr(), qt.zero.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), m, qt.k, qt.n, gs, f,
        int(qt.data.dtype == torch.int8), out_bf16, ksplit, _build.stream_ptr(x2d.device),
    )
    _build.check(err, "qmm_gemm (B2)")
    COUNTS["B2.w3" if f == PLANES3 else "B2"] += 1
    return out


def qmm_v3(x2d: torch.Tensor, qt: QuantizedTensor, out_dtype) -> torch.Tensor:
    """The v3 route (`pallas_qmatmul.py:405-417`): x quantized per token to
    s8, B3 on the packed codes (or unpacked codes as int8) with the fp32
    zero."""
    if qt.packed:
        layout, data = {4: "u4", 2: "u2"}.get(qt.bits), qt.data
        if layout is None:
            raise NotImplementedError(f"v3 takes 4/2-bit packed weights, got {qt.bits}-bit")
    else:  # cast to int8 as `pallas_qmatmul.py:294` casts: uint8 codes above 127 wrap
        layout, data = "s8", qt.data.view(torch.int8)
    return w_a8_matmul(x2d, data, layout, qt.scale, qt.zero, qt.group_size or qt.k,
                       out_dtype, "B3.v3")


def fused_dequant_matmul(
    x: torch.Tensor, qt: QuantizedTensor, out_dtype=None, version: int = 0
) -> torch.Tensor:
    """`x @ dequant(qt)` for x of any leading shape.

    version 0 picks as JAX does: `L3Q_QMM_V` if set, else B1 for M <= 64
    and B2 above; 1 is B2, 2 is B1, 3 is B3 (W·A8). 3-bit plane weights
    always take B2. CPU tensors take the plain versions; CUDA tensors take
    the kernels."""
    if qt.zero is None:
        raise NotImplementedError("the fused kernels require zero-point storage")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2d = x.reshape(-1, qt.k)
    if _is_planes(qt):
        version = 1  # v2's per-bitfield dots assume the nibble layout
    if version == 0:
        env = os.environ.get("L3Q_QMM_V")
        version = int(env) if env else (2 if x2d.shape[0] <= GEMV_MAX_M else 1)
    cpu = x.device.type == "cpu"
    if version == 3:
        fn = qmm_v3
    elif version == 2:
        fn = qmm_gemv_plain if cpu else qmm_gemv
    else:
        fn = qmm_gemm_plain if cpu else qmm_gemm
    return fn(x2d, qt, out_dtype).reshape(*lead, qt.n)
