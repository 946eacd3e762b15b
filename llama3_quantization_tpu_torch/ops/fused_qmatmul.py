"""Fused dequant-matmul `y = x @ dequant(W)`: kernels B1, B2 and B3.

Port of `llama3_quantization_tpu/ops/pallas_qmatmul.fused_dequant_matmul`.
B1 (`csrc/qmatmul.cu` `qmm_gemv_kernel`, the TPU `_qmm_v2_kernel`) serves
M <= 64 and applies scale and zero after the dot (tensor-core dots, one
launch per call, its tiles and K split from `gemv_plan`); B2 (`qmm_gemm_kernel`,
the TPU `_qmm_kernel` v1) serves M > 64 and dequantizes each weight tile
to bf16 before a bf16 MMA, in a pipelined shared-memory ring. Both cast x to bf16 and accumulate in fp32.
3-bit bit-plane weights always take B2, as the TPU wrapper sends them to v1.
`version=3` (or `L3Q_QMM_V=3`, read as JAX reads it) takes B3, the W·A8
integer kernel of `ops/qmatmul_a8.py`, on the packed weight and its fp32
zero point.

Each kernel has a plain PyTorch version here with the same rounding points
(`qmm_gemv_plain`, `qmm_gemm_plain`). The wrapper uses it for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.

The shapes each kernel takes are one predicate beside it (`b1_takes`,
`b2_takes`), which its wrapper's raise reads, and which `ops/padding.py`
reads to pad a weight that one does not take to one that both take, once,
where the weights are prepared (`ops/matmul.prepare_decode_params`):
every group size, K and N fit after that, as they fit JAX's `_fused_qmm`.
"""

from __future__ import annotations

import ctypes
import functools
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
        lib.l3q_qmm_gemv.argtypes = [_P] * 5 + [_I] * 11 + [_P]
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


def b1_takes(m: int, k: int, n: int, gs: int, bits: int, packed: bool) -> bool:
    """Does B1 take `[M, K] x [K, N]` codes (group size `gs`)? 2/4-bit
    packed nibbles or 8-bit containers (unpacked codes, and the packed
    widths of one value per byte), 1 <= M <= 64, N % 16 == 0, and groups
    that `gemv_plan` tiles: gs % 16 == 0 and (gs / f) % 8 == 0 dividing K
    (f values per byte)."""
    if packed and bits == 3:
        return False  # 3-bit planes take B2
    f = pack_factor(bits) if packed else 1
    return (1 <= m <= GEMV_MAX_M and n % 16 == 0 and k % gs == 0 and gs % 16 == 0
            and gs % f == 0 and (gs // f) % 8 == 0)


def b2_takes(k: int, n: int, gs: int, bits: int, packed: bool) -> bool:
    """Does B2 take `[K, N]` codes (group size `gs`)? 2/3/4-bit packed or
    8-bit containers, K % 64 == 0, N % 16 == 0, and a run of 8 k rows (8 *
    f for f values per byte; 8 on 3-bit planes) inside a group."""
    f = pack_factor(bits) if packed else 1
    run = 8 if packed and bits == 3 else 8 * f
    return k % B2_KT == 0 and n % 16 == 0 and k % gs == 0 and gs % run == 0


def _check_weight(qt: QuantizedTensor, device) -> int:
    """Validate a weight's dtypes, layout and placement for the kernels;
    return its layout code: values per byte (4, 2, 1), or PLANES3 for 3-bit
    bit planes."""
    f = pack_factor(qt.bits) if qt.packed else 1
    gs = qt.group_size or qt.k
    g = qt.k // gs
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


@functools.lru_cache(maxsize=None)
def gemv_plan(k: int, n: int, gs: int, f: int) -> _build.GemvPlan:
    """B1's tiles, K split and order from (K, N, gs, f) alone, so that a
    row's result does not depend on how many rows share the call. A unit is
    16 byte rows of one group, or 8 where a group's bit field has 8 (L * f k
    values, a multiple of the MMA's 16); tiles, runs and split follow
    `_build.gemv_tiles`."""
    sub = gs // f
    if k % gs or gs % f or gs % 16 or sub % 8:
        raise ValueError(f"B1 needs group_size % 16 == 0 and group_size / {f} % 8 == 0 "
                         f"dividing K, got K={k}, group_size={gs}")
    return _build.gemv_tiles(n, k, gs, f, 16 if sub % 16 == 0 else 8, 2)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy where its data is not 16-byte aligned (cp.async)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def qmm_gemv(x2d: torch.Tensor, qt: QuantizedTensor, out_dtype) -> torch.Tensor:
    """Kernel B1 on the card (M <= 64): one launch, every packed byte read
    once whatever M is."""
    f = _check_weight(qt, x2d.device)
    if f == PLANES3:
        raise NotImplementedError("B1 has no 3-bit plane form; 3-bit weights take B2")
    m = x2d.shape[0]
    gs = qt.group_size or qt.k
    if not b1_takes(m, qt.k, qt.n, gs, qt.bits, qt.packed):
        raise ValueError(f"B1 (b1_takes) needs 1 <= M <= {GEMV_MAX_M}, N % 16 == 0 and "
                         f"group_size % 16 == 0 with 8-row bit fields dividing K; got M={m}, "
                         f"K={qt.k}, N={qt.n}, group_size={gs}, {qt.bits}-bit (prepare the "
                         f"weights with prepare_decode_params or pad_for_kernels)")
    for name, t in (("codes", qt.data), ("scale", qt.scale), ("zero", qt.zero)):
        if t.data_ptr() % 16:
            raise ValueError(f"B1 copies {name} in 16-byte chunks: it must be 16-byte aligned")
    plan = gemv_plan(qt.k, qt.n, gs, f)
    out_bf16 = _build.out_flag(out_dtype)
    xb = _aligned(x2d.to(torch.bfloat16).contiguous())
    out = torch.empty((m, qt.n), dtype=out_dtype, device=x2d.device)
    err = _lib().l3q_qmm_gemv(
        xb.data_ptr(), qt.data.data_ptr(), qt.scale.data_ptr(), qt.zero.data_ptr(),
        out.data_ptr(), m, qt.k, qt.n, gs, f, int(qt.data.dtype == torch.int8), out_bf16,
        plan.bn, plan.ksplit, plan.unit, plan.uw, _build.stream_ptr(x2d.device),
    )
    _build.check(err, "qmm_gemv (B1)")
    COUNTS["B1"] += 1
    return out


#: B2's tile: 128 rows, 128 columns, 64 k per pipeline stage
B2_BN, B2_KT = 128, 64


def b2_ksplit(k: int, n: int) -> int:
    """B2's K split, from (K, N) alone, so that a row's result does not
    depend on how many rows share the call (batch-invariant prefills): none
    when one 128-row tile of columns already covers 3/4 of the card's SMs,
    else enough splits for one block per SM."""
    tiles = -(-n // B2_BN)
    sms = TARGET_BLOCKS // 2
    return 1 if 4 * tiles >= 3 * sms else min(-(-sms // tiles), k // B2_KT)


def qmm_gemm(x2d: torch.Tensor, qt: QuantizedTensor, out_dtype) -> torch.Tensor:
    """Kernel B2 on the card (M > 64)."""
    f = _check_weight(qt, x2d.device)
    gs = qt.group_size or qt.k
    if not b2_takes(qt.k, qt.n, gs, qt.bits, qt.packed):
        raise ValueError(f"B2 (b2_takes) needs K % 64 == 0, N % 16 == 0 and a run of 8 k "
                         f"rows inside a group; got K={qt.k}, N={qt.n}, group_size={gs}, "
                         f"{qt.bits}-bit (prepare the weights with prepare_decode_params or "
                         f"pad_for_kernels)")
    out_bf16 = _build.out_flag(out_dtype)
    m = x2d.shape[0]
    xb = x2d.to(torch.bfloat16).contiguous()
    for name, t in (("x", xb), ("codes", qt.data), ("scale", qt.scale), ("zero", qt.zero)):
        if t.data_ptr() % 16:
            raise ValueError(f"B2 copies {name} in 16-byte chunks: it must be 16-byte aligned")
    out = torch.empty((m, qt.n), dtype=out_dtype, device=x2d.device)
    ksplit = b2_ksplit(qt.k, qt.n)
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
    if version == 3:
        return qmm_v3(x2d, qt, out_dtype).reshape(*lead, qt.n)
    if x.device.type == "cpu":
        fn = qmm_gemv_plain if version == 2 else qmm_gemm_plain
    else:
        fn = qmm_gemv if version == 2 else qmm_gemm
    return fn(x2d, qt, out_dtype).reshape(*lead, qt.n)
