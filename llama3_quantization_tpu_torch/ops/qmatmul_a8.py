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

Each form's shapes are one predicate (`b3_gemv_takes`, `b3_gemm_takes`),
which its wrapper's raise reads, and which `ops/padding.py` reads to pad a
weight that B3 does not take (groups to multiples of 32 k, N to a multiple
of 16) once, where the weights are prepared.
"""

from __future__ import annotations

import ctypes
import functools
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
        lib.l3q_a8_gemv.argtypes = [_P] * 4 + [_I, _P, _P] + [_I] * 9 + [_P]
        lib.l3q_a8_gemv.restype = _I
        lib.l3q_a8_gemm.argtypes = [_P] * 4 + [_I, _P, _P, _P] + [_I] * 8 + [_P]
        lib.l3q_a8_gemm.restype = _I
        lib._l3q_typed = True
    return lib


#: the process group over which a row-parallel linear's input is split along
#: K (`ops/collectives.row_parallel_input`): a token's scale is then its
#: absmax over every rank's K shard, as GSPMD reduces it over the full K
_K_GROUP = None


def quantize_activations_s8(x: torch.Tensor):
    """Per-row (token) symmetric int8: (xq int8, scale f32 [..., 1]). The KV
    cache's `kv_quantize`, shared as the JAX package shares it
    (`a8_matmul.py:29-36`)."""
    if _K_GROUP is None:
        return kv_quantize(x)
    from .collectives import all_reduce_max_

    return kv_quantize(x, all_reduce_max_(x.float().abs().amax(dim=-1, keepdim=True), _K_GROUP))


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


def b3_gemv_takes(m: int, k: int, n: int, gs: int, layout: str) -> bool:
    """Does B3's GEMV form take `[M, K] x [K, N]` codes in `layout`?
    1 <= M <= 64, N % 16 == 0, and groups of a multiple of 32 k dividing K
    (whole bit fields of the 32-deep MMA)."""
    f = LAYOUTS[layout][1]
    return 1 <= m <= GEMV_MAX_M and n % 16 == 0 and k % gs == 0 and gs % 32 == 0 and gs % f == 0


def b3_gemm_takes(k: int, n: int, gs: int, layout: str) -> bool:
    """Does B3's tiled form take `[K, N]` codes in `layout`? N % 16 == 0 and
    groups of a multiple of 32 k dividing K."""
    f = LAYOUTS[layout][1]
    return n % 16 == 0 and k % gs == 0 and gs % 32 == 0 and gs % f == 0


def b3_takes(m: int, k: int, n: int, gs: int, layout: str) -> bool:
    """Does the form of B3 that serves M rows take the shape?"""
    if m <= GEMV_MAX_M:
        return b3_gemv_takes(m, k, n, gs, layout)
    return b3_gemm_takes(k, n, gs, layout)


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


def _require_cuda(xq) -> None:
    if xq.device.type != "cuda":
        raise ValueError(f"B3's kernels run on a CUDA device, got {xq.device}")


def _zmode(zero) -> int:
    if zero is None:
        return 0
    return 1 if zero.dtype == torch.float32 else 2


#: column tiles B3's GEMV form wants: about one block an SM (132 on an H100)
GEMV_MIN_TILES = 128


@functools.lru_cache(maxsize=None)
def gemv_plan(k: int, n: int, gs: int, f: int) -> _build.GemvPlan:
    """Tiles and order of B3's GEMV form from (K, N, gs, f) alone. A unit
    is 32 byte rows of one group, or 16 / 8 where a group's bit field is
    shorter (L * f k values, a multiple of the MMA's 32). K does not split:
    one block folds every group term of its columns in order. The tile is
    the widest of 128, 64 and 32 columns that gives GEMV_MIN_TILES blocks,
    else 32 (measured on an H100: fewer, busier blocks beat both narrower
    tiles and a K split there); runs follow `_build.gemv_run`."""
    if k % gs or gs % 32 or gs % f:
        raise ValueError(f"B3's GEMV form needs group_size % 32 == 0 dividing K, "
                         f"got K={k}, group_size={gs}")
    sub = gs // f
    unit = next(u for u in (32, 16, 8) if sub % u == 0 and u * f % 32 == 0)
    bn = next((t for t in (128, 64, 32) if -(-n // t) >= GEMV_MIN_TILES), 32 if n >= 32 else 16)
    return _build.GemvPlan(bn, 1, 128 // bn, unit, _build.gemv_run(gs, f, unit, bn, 1))


def a8_gemv(xq, s_x, data, layout, scale, zero, gs: int, out_dtype, key: str) -> torch.Tensor:
    """B3's GEMV form on the card (M <= 64): one launch, every packed byte
    read once; counts one launch under `key`."""
    f = _check(xq, s_x, data, layout, scale, zero, gs)
    m, k = xq.shape
    n = data.shape[-1]
    if not b3_gemv_takes(m, k, n, gs, layout):
        raise ValueError(f"B3's GEMV form (b3_gemv_takes) needs 1 <= M <= {GEMV_MAX_M}, "
                         f"N % 16 == 0 and group_size % 32 == 0 dividing K; got M={m}, K={k}, "
                         f"N={n}, group_size={gs} (prepare the weights with "
                         f"prepare_decode_params or pad_for_kernels)")
    plan = gemv_plan(k, n, gs, f)
    _require_cuda(xq)
    for name, t in (("xq", xq), ("codes", data), ("scale", scale), ("zero", zero)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"B3 copies {name} in 16-byte chunks: it must be 16-byte aligned")
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    err = _lib().l3q_a8_gemv(
        xq.data_ptr(), data.data_ptr(), scale.data_ptr(),
        None if zero is None else zero.data_ptr(), _zmode(zero), s_x.data_ptr(), out.data_ptr(),
        _build.out_flag(out_dtype), m, k, n, gs, LAYOUTS[layout][0], plan.bn, plan.unit, plan.uw,
        _build.stream_ptr(xq.device),
    )
    _build.check(err, f"a8_gemv ({key})")
    COUNTS[key] += 1
    return out


#: k values per stage of the tiled form (one 128-byte row of its tiles)
GEMM_STAGE_K = 128


def gemm_plan(m: int, n: int, k: int, gs: int, f: int):
    """(tile, rows) of B3's tiled form, from the shapes alone: 128x128
    output tiles where they give the card at least 7/8 of a block per SM
    (one block fits an SM), else 64x64; and the packed byte rows of one
    pipeline stage. A stage holds every bit field of its byte rows: f *
    rows k values, 32, 64 or 128 (the producers split a stage's activation
    copies evenly). It either lies inside one group (rows divides gs / f)
    or holds whole groups (rows a multiple of gs / f dividing K / f), so
    each k step of 32 lies in one group. The most k per stage wins."""
    if k % gs or gs % 32 or n % 16:
        raise ValueError(f"B3's tiled form needs K % group_size == 0, group_size % 32 == 0 "
                         f"and N % 16 == 0, got K={k}, group_size={gs}, N={n}")
    tile = 128 if -(-m // 128) * -(-n // 128) >= 7 * TARGET_BLOCKS // 16 else 64
    sub = gs // f
    rows = max(r for r in (kv // f for kv in (32, 64, GEMM_STAGE_K))
               if sub % r == 0 or (r % sub == 0 and (k // gs) % (r // sub) == 0))
    return tile, rows


def a8_gemm(xq, s_x, data, layout, scale, zero, gs: int, out_dtype) -> torch.Tensor:
    """B3's tiled form on the card (M > 64)."""
    f = _check(xq, s_x, data, layout, scale, zero, gs)
    m, k = xq.shape
    n = data.shape[-1]
    if not b3_gemm_takes(k, n, gs, layout):
        raise ValueError(f"B3's tiled form (b3_gemm_takes) needs N % 16 == 0 and "
                         f"group_size % 32 == 0 dividing K; got K={k}, N={n}, group_size={gs} "
                         f"(prepare the weights with prepare_decode_params or pad_for_kernels)")
    tile, rows = gemm_plan(m, n, k, gs, f)
    _require_cuda(xq)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    # the activation sums per group (a zero point or u8 codes need them)
    xsg = (torch.empty((k // gs, -(-m // 128) * 128), dtype=torch.int32, device=xq.device)
           if zero is not None or layout == "u8" else None)
    err = _lib().l3q_a8_gemm(
        xq.data_ptr(), data.data_ptr(), scale.data_ptr(),
        None if zero is None else zero.data_ptr(), _zmode(zero), s_x.data_ptr(),
        None if xsg is None else xsg.data_ptr(), out.data_ptr(), _build.out_flag(out_dtype), m,
        k, n, gs, LAYOUTS[layout][0], tile, rows, _build.stream_ptr(xq.device),
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
    the tiled form, which raise outside `b3_takes`."""
    xq, s_x = quantize_activations_s8(x2d)
    if x2d.device.type == "cpu":
        return a8_plain(xq, s_x, data, layout, scale, zero, gs, out_dtype)
    if x2d.device.type != "cuda":
        raise ValueError(f"unsupported device {x2d.device}")
    if xq.shape[0] <= GEMV_MAX_M:
        return a8_gemv(xq, s_x, data, layout, scale, zero, gs, out_dtype, key)
    return a8_gemm(xq, s_x, data, layout, scale, zero, gs, out_dtype)
