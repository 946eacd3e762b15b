"""Weight-stream probes: kernel B8 (`csrc/w4_stream.cu`).

Port of the DMA-only Pallas kernels of the weight-stream microbenches:
`_dma_kernel` of `scripts/microbench_w4_variants.py` (packed W4 `[K/2, N]`,
"B8.w4") and of `scripts/microbench_w4_tiled.py` (tiles
`[K/bk, N/bn, bk/2, bn]`, "B8.tiled"), and the manual-DMA `kernel` of
`scripts/microbench_dma_depth.py` (int8 `[R, W]` in chunks with D copies in
flight, "B8.depth"). Each streams every byte of its array and returns, as
f32 `[1, N]`, the sum over blocks (chunks) of the block's first row: the
signed low nibble of each byte (row 0 of the block's int4 bitcast, the
Mosaic layout `byte r = c[2r] & 15 | c[2r+1] << 4`) or the byte itself.
Small integers summed in f32: the kernel equals its plain version exactly.

CPU tensors take the plain versions; CUDA tensors take the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import TARGET_BLOCKS
from .launches import COUNTS

_P = ctypes.c_void_p
_I = ctypes.c_int
#: bytes of one pipeline stage (`STAGE` in the kernel)
STAGE = 8192
#: the w4 forms' pipeline depth (stages in flight per block of threads)
W4_DEPTH = 4
DEPTHS = (1, 2, 4, 8)


def _lib():
    lib = _build.load("w4_stream")
    if not getattr(lib, "_l3q_typed", False):
        lib.l3q_w4_stream.argtypes = [_P, _P] + [_I] * 9 + [_P]
        lib.l3q_w4_stream.restype = _I
        lib._l3q_typed = True
    return lib


def low_nibbles(rows: torch.Tensor) -> torch.Tensor:
    """Signed low nibble of each int8 byte, as int16."""
    return ((rows.to(torch.int16) & 15) ^ 8) - 8


def w4_dma_plain(packed: torch.Tensor, bk: int) -> torch.Tensor:
    """Row 0 of every K block of packed W4 `[K/2, N]`, summed: `[1, N]`."""
    return low_nibbles(packed[:: bk // 2]).float().sum(dim=0, keepdim=True)


def w4_dma_tiled_plain(wt: torch.Tensor) -> torch.Tensor:
    """The same on tiles `[K/bk, N/bn, bk/2, bn]`: `[1, N]`."""
    nk, nn, _, bn = wt.shape
    return low_nibbles(wt[:, :, 0]).float().sum(dim=0).reshape(1, nn * bn)


def dma_depth_plain(x: torch.Tensor, chunk_rows: int) -> torch.Tensor:
    """Row 0 of every chunk of `chunk_rows` rows of int8 `[R, W]`: `[1, W]`."""
    return x[::chunk_rows].float().sum(dim=0, keepdim=True)


def _stream(src, rows, row_bytes, width, cols, chunk_rows, nibble, nn, depth, n_out, key):
    """Launch B8 over `rows` rows of `src`; counts one launch under `key`."""
    if src.dtype != torch.int8 or not src.is_contiguous():
        raise TypeError("B8 streams a contiguous int8 array")
    if width % 16 or STAGE % width or cols % width:
        raise ValueError(f"B8 needs a row width dividing {STAGE} in multiples of 16, got {width}")
    stage_rows = STAGE // width
    ctas_y = max(1, TARGET_BLOCKS * 2 // (cols // width))
    rows_per_cta = -(-rows // ctas_y)
    rows_per_cta = -(-rows_per_cta // stage_rows) * stage_rows
    out = torch.zeros((1, n_out), dtype=torch.float32, device=src.device)
    err = _lib().l3q_w4_stream(src.data_ptr(), out.data_ptr(), rows, row_bytes, width, cols,
                               chunk_rows, rows_per_cta, nibble, nn, depth,
                               _build.stream_ptr(src.device))
    _build.check(err, f"w4_stream ({key})")
    COUNTS[key] += 1
    return out


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA one."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cpu"


def w4_dma(packed: torch.Tensor, bk: int) -> torch.Tensor:
    """B8.w4: stream packed W4 `[K/2, N]` in K blocks of `bk` rows."""
    if on_cpu(packed):
        return w4_dma_plain(packed, bk)
    k2, n = packed.shape
    if k2 % (bk // 2):
        raise ValueError(f"K={2 * k2} is not a multiple of bk={bk}")
    width = next((w for w in (512, 256, 128, 64, 32, 16) if n % w == 0), None)
    if width is None:
        raise ValueError(f"B8 needs N % 16 == 0, got {n}")
    return _stream(packed, k2, n, width, n, bk // 2, 1, 0, W4_DEPTH, n, "B8.w4")


def w4_dma_tiled(wt: torch.Tensor) -> torch.Tensor:
    """B8.tiled: stream tiles `[K/bk, N/bn, bk/2, bn]`, one contiguous
    block per (K block, N block)."""
    if on_cpu(wt):
        return w4_dma_tiled_plain(wt)
    nk, nn, half, bn = wt.shape
    return _stream(wt, nk * nn * half, bn, bn, bn, half, 1, nn, W4_DEPTH, nn * bn, "B8.tiled")


def dma_depth(x: torch.Tensor, chunk_rows: int, depth: int) -> torch.Tensor:
    """B8.depth: stream int8 `[R, W]` with `depth` stages in flight per
    block of threads; chunks of `chunk_rows` rows."""
    if depth not in DEPTHS:
        raise ValueError(f"B8.depth takes a depth in {DEPTHS}, got {depth}")
    if on_cpu(x):
        return dma_depth_plain(x, chunk_rows)
    rows, width = x.shape
    return _stream(x, rows, width, width, width, chunk_rows, 0, 0, depth, width, "B8.depth")
