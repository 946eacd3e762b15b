"""Block-diagonal int4 dot probes: kernel B9 (`csrc/w4_bd.cu`).

Port of the int4-dot Pallas kernels of the weight-stream microbenches:
`_v4_kernel` of `scripts/microbench_w4_v4.py` and `_bd4_kernel` of
`scripts/microbench_w4_variants.py` ("B9.v4"), `_bd4_kernel` of
`scripts/microbench_w4_tiled.py` ("B9.tiled"), `_dot4_kernel`,
`_noscale_kernel` and `_cast8_kernel` of `microbench_w4_variants.py`
("B9.dot4", "B9.noscale", "B9.cast8") and `_kernel` of
`scripts/microbench_w4_multidma.py` ("B9.multi").

Weights are packed int4 `[K/2, N]` int8 in the TPU's bitcast layout: byte
row r holds rows 2r (low nibble) and 2r + 1 (high nibble), both signed
(`int4_weight`). Over K tiles j of `bk` rows (gt = bk / 128 groups) each
form takes the exact integer product P = A_j W_j of a row operand A_j with
the weight tile W_j, and adds an fp32 epilogue t_j of P to out `[1, N]`
(the forms' row operands and epilogues are listed in the kernel source);
t_j and out are summed in order, one rounding per operation, here and in
the kernel alike. The plain versions form P in float64 (exact: every
partial is an integer below 2^53).

The kernel's grid and split come from `bd_plan` (the shapes alone);
`bd_split_plain` walks the kernel's split on the CPU: every unit of 16
byte rows as one tensor-core step with the nibbles scaled by 16, the
partials added into the owner's P, the epilogue shifting the factor out.

CPU tensors take the plain version; CUDA tensors take the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from . import _build
from .launches import COUNTS
from .w4_stream import low_nibbles, on_cpu

GS = 128
FORMS = {"v4": 0, "dot4": 1, "cast8": 2, "noscale": 3, "multi": 4}
#: the forms whose epilogue multiplies by the group scales
SCALED = ("v4", "dot4", "cast8")

#: the H100's SMs: a plan gives the grid at least this many blocks where
#: the shape allows
MIN_BLOCKS = 132
#: columns of a block (eight consumer warps of 16: one 128-byte TMA box row)
BN = 128
#: byte rows of a ring stage at most (8 KB of codes), and the stages in flight
MAX_STAGE_ROWS = 64
RING = 4
#: blocks along K: one thread-block cluster, at most the portable size
MAX_SPLIT = 8

_P = ctypes.c_void_p
_I = ctypes.c_int


class BdPlan(NamedTuple):
    """Grid and order of a B9 launch, from the shapes alone."""

    bn: int    #: columns per block (eight warps of 16)
    ks: int    #: blocks along K (one cluster): rank q takes byte rows [q, q + 1) * bk / 2ks
               #: of every tile and owns the epilogue of columns [q, q + 1) * bn / ks
    sr: int    #: byte rows of a ring stage (one stream's, inside one rank's slice)
    ring: int  #: stages in flight per block


def bd_plan(k: int, n: int, bk: int, streams: int = 1) -> BdPlan:
    """Tiles and K split of B9 for packed weights `[K/2, N]` in S streams
    (the tiled layout's plan is the row-major one's). Blocks of 128 columns
    (every code row a full 128-byte line); the K split is the smallest that
    gives MIN_BLOCKS blocks, else the largest whose slices still hold a
    unit of 16 byte rows. Every form takes the same tiles (v4's stages lie
    inside one group: a group's 64 byte rows hold whole stages)."""
    rows_s = bk // 2 // streams
    best, ks = None, 1
    while ks <= MAX_SPLIT:
        sr = min(MAX_STAGE_ROWS, bk // 2 // ks, rows_s)
        if sr < 16:
            break
        best = BdPlan(BN, ks, sr, RING)
        if n // BN * ks >= MIN_BLOCKS:
            break
        ks *= 2
    if best is None:
        raise ValueError(f"B9 has no plan for K={k}, N={n}, bk={bk}, S={streams}")
    return best


def _lib():
    lib = _build.load("w4_bd")
    if not getattr(lib, "_l3q_typed", False):
        lib.l3q_w4_bd.argtypes = [_I] + [_P] * 10 + [_I] * 11 + [_P]
        lib.l3q_w4_bd.restype = _I
        lib._l3q_typed = True
    return lib


def int4_weight(packed: torch.Tensor) -> torch.Tensor:
    """Packed `[K/2, N]` int8 -> signed int4 values `[K, N]` (int16): row 2r
    the low nibble of byte row r, row 2r + 1 its high nibble."""
    hi = packed.to(torch.int16) >> 4
    return torch.stack([low_nibbles(packed), hi], dim=1).reshape(-1, packed.shape[-1])


def untile(wt: torch.Tensor) -> torch.Tensor:
    """Tiles `[K/bk, N/bn, bk/2, bn]` -> the row-major packed `[K/2, N]`."""
    nk, nn, half, bn = wt.shape
    return wt.permute(0, 2, 1, 3).reshape(nk * half, nn * bn)


def bd_plain(form: str, rows: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
             scale: Optional[torch.Tensor], bk: int) -> torch.Tensor:
    """B9's function. `ws`: packed weight per stream (one, except "multi");
    `rows`: the row operand per stream, or (xh, xl) `[1, K]` for "v4"."""
    n = ws[0].shape[-1]
    s_count, ks = len(ws), bk // len(ws)
    k = 2 * ws[0].shape[0] * s_count
    gt = bk // GS
    w = [int4_weight(x).double() for x in ws]
    acc = torch.zeros(n, dtype=torch.float32, device=ws[0].device)
    for j in range(k // bk):
        if form == "v4":
            wj = w[0][j * bk:(j + 1) * bk].reshape(gt, GS, n)
            xs = [x[0, j * bk:(j + 1) * bk].double().reshape(gt, GS) for x in rows]
            p = torch.cat([torch.einsum("gk,gkn->gn", x, wj) for x in xs])  # [2gt, N]
        else:
            p = sum(a[:, j * ks:(j + 1) * ks].double() @ wt[j * ks:(j + 1) * ks]
                    for a, wt in zip(rows, w))
        t = torch.zeros(n, dtype=torch.float32, device=acc.device)
        if form in ("v4", "dot4"):
            for r in range(gt):
                t = t + (16 * p[r] + p[gt + r]).float() * scale[j * gt + r]
        elif form == "cast8":
            for r in range(gt):
                t = t + p[r].float() * scale[j * gt + r]
        else:
            for r in range(p.shape[0]):
                t = t + p[r].float()
        acc = acc + t
    return acc[None]


def nibbles16(packed: torch.Tensor):
    """Packed int8 `[R, N]` -> (16 * low nibble, 16 * high nibble), int64:
    the s8 operands of the kernel's MMA ((w << 4) & 0xF0 and w & 0xF0)."""
    b = packed.to(torch.int64) & 0xFF
    s8 = lambda v: v - ((v & 0x80) << 1)  # noqa: E731
    return s8((b << 4) & 0xF0), s8(b & 0xF0)


def bd_split_plain(form: str, rows: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                   scale: Optional[torch.Tensor], bk: int, plan: BdPlan) -> torch.Tensor:
    """B9's function summed as the kernel under `plan` sums it: per tile,
    rank q's stages, each stage's units of 16 byte rows in order (k pairs
    2i, 2i + 1 against 16x the low and high nibbles of byte row i), the
    partials added into P (v4: flushed per stage to the group's two rows),
    then the epilogue on P with its factor 16 shifted out. Row-major
    weights."""
    n = ws[0].shape[-1]
    s_count = len(ws)
    k = 2 * ws[0].shape[0] * s_count
    gt = bk // GS
    tr, rows_s = bk // 2 // plan.ks, bk // 2 // s_count
    nib = [nibbles16(w) for w in ws]
    ops = [a.to(torch.int64) for a in rows]
    rp = 2 * gt if form == "v4" else ops[0].shape[0]
    acc = torch.zeros(n, dtype=torch.float32, device=ws[0].device)
    for j in range(k // bk):
        p16 = torch.zeros((rp, n), dtype=torch.int64, device=acc.device)
        for q in range(plan.ks):
            for i in range(tr // plan.sr):
                part = None
                for u in range(plan.sr // 16):
                    v = q * tr + i * plan.sr + u * 16
                    s, vr = divmod(v, rows_s)
                    lo, hi = (x[j * rows_s + vr: j * rows_s + vr + 16] for x in nib[s])
                    if form == "v4":
                        a = torch.cat([x[:, j * bk + 2 * v: j * bk + 2 * v + 32] for x in ops])
                    else:
                        k0 = j * (bk // s_count) + 2 * vr
                        a = ops[s][:, k0:k0 + 32]
                    d = a[:, 0::2] @ lo + a[:, 1::2] @ hi
                    part = d if part is None else part + d
                if form == "v4":  # a stage lies in one group
                    g = (q * tr + i * plan.sr) // 64
                    p16[g] += part[0]
                    p16[gt + g] += part[1]
                else:
                    p16 += part
        p = p16 >> 4
        t = torch.zeros(n, dtype=torch.float32, device=acc.device)
        if form in ("v4", "dot4"):
            for r in range(gt):
                t = t + (16 * p[r] + p[gt + r]).float() * scale[j * gt + r]
        elif form == "cast8":
            for r in range(gt):
                t = t + p[r].float() * scale[j * gt + r]
        else:
            for r in range(rp):
                t = t + p[r].float()
        acc = acc + t
    return acc[None]


def _launch(form, rows, ws, scale, bk, tiled, key):
    """Validate B9's operands on the card, launch, count one under `key`."""
    dev = ws[0].device
    streams = len(ws)
    if tiled:
        nk, nn, half, bn_t = ws[0].shape
        k, n = 2 * nk * half, nn * bn_t
    else:
        k, n, bn_t = 2 * ws[0].shape[0] * streams, ws[0].shape[1], 0
    for t in list(ws) + list(rows) + ([] if scale is None else [scale]):
        if not t.is_contiguous() or t.device != dev or t.data_ptr() % 16:
            raise ValueError(f"B9 operands must be contiguous and 16-byte aligned on {dev}")
    if any(t.dtype != torch.int8 for t in list(ws) + list(rows)):
        raise TypeError("B9 takes int8 weights and row operands")
    if form in SCALED and (scale.dtype != torch.float32 or tuple(scale.shape) != (k // GS, n)):
        raise ValueError(f"scale must be float32 [{k // GS}, {n}]")
    if (n % 128 or k % bk or bk < 256 or bk > 2048 or bk & (bk - 1) or streams not in (1, 2, 4)
            or bn_t % 128):
        raise ValueError(f"B9 needs N % 128 == 0 (tiles too) and bk a power of two in "
                         f"[256, 2048] dividing K, 1, 2 or 4 streams; got K={k}, N={n}, "
                         f"bk={bk}, S={streams}")
    nrows = 2 * (bk // GS) // streams if form != "cast8" else bk // GS
    a_ld = rows[0].shape[-1]
    if form != "v4" and (rows[0].shape[0] < nrows or a_ld % 16):
        raise ValueError(f"B9 {form} needs {nrows} rows of a multiple of 16 bytes")
    wp = [t.data_ptr() for t in ws] + [None] * (4 - streams)
    ap = [t.data_ptr() for t in rows] + [None] * (4 - len(rows))
    plan = bd_plan(k, n, bk, streams)
    out = torch.empty((1, n), dtype=torch.float32, device=dev)
    err = _lib().l3q_w4_bd(FORMS[form], *wp, *ap, None if scale is None else scale.data_ptr(),
                           out.data_ptr(), k, n, bk, bn_t, streams, nrows, a_ld, *plan,
                           _build.stream_ptr(dev))
    _build.check(err, f"w4_bd ({key})")
    COUNTS[key] += 1
    return out


def w4_bd(xh: torch.Tensor, xl: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, bk: int,
          tiled: bool = False) -> torch.Tensor:
    """B9.v4 (B9.tiled for tiles `[K/bk, N/bn, bk/2, bn]`): the shipped v4
    kernel; xh, xl int8 `[1, K]` in [-8, 7] (x = 16 xh + xl), scale f32
    `[K/128, N]`."""
    if on_cpu(w):
        return bd_plain("v4", (xh, xl), (untile(w) if tiled else w,), scale, bk)
    return _launch("v4", (xh, xl), (w,), scale, bk, tiled, "B9.tiled" if tiled else "B9.v4")


def w4_dot4(bd: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, bk: int) -> torch.Tensor:
    """B9.dot4: rows 0..2gt of `bd` int8 `[>= 2gt, K]` (int4 values) for
    every tile, as the script's block index does."""
    if on_cpu(w):
        return bd_plain("dot4", (bd[: 2 * (bk // GS)],), (w,), scale, bk)
    return _launch("dot4", (bd,), (w,), scale, bk, False, "B9.dot4")


def w4_noscale(bd: torch.Tensor, w: torch.Tensor, bk: int) -> torch.Tensor:
    """B9.noscale: dot4's product, summed over its 2gt rows without scales."""
    if on_cpu(w):
        return bd_plain("noscale", (bd[: 2 * (bk // GS)],), (w,), None, bk)
    return _launch("noscale", (bd,), (w,), None, bk, False, "B9.noscale")


def w4_cast8(bd: torch.Tensor, scale: torch.Tensor, w: torch.Tensor, bk: int) -> torch.Tensor:
    """B9.cast8: rows 0..gt of s8 `bd` `[>= gt, K]` against the int4 weight
    widened to s8, group scales on the gt rows."""
    if on_cpu(w):
        return bd_plain("cast8", (bd[: bk // GS],), (w,), scale, bk)
    return _launch("cast8", (bd,), (w,), scale, bk, False, "B9.cast8")


def w4_multi(bds: Sequence[torch.Tensor], ws: Sequence[torch.Tensor], bk: int) -> torch.Tensor:
    """B9.multi: S weight streams `[K/2S, N]` with their rows `[2gt/S, K/S]`;
    per tile P = sum over streams, summed over its rows."""
    if on_cpu(ws[0]):
        return bd_plain("multi", bds, ws, None, bk)
    return _launch("multi", bds, ws, None, bk, False, "B9.multi")
