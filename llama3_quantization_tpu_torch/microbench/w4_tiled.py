"""The tile-contiguous weight layout on the card (port of
`scripts/microbench_w4_tiled.py`): the weight stored `[K/bk, N/bn, bk/2, bn]`,
so each (K block, N block) is one contiguous chunk. Variants, each timed
over L = 8 weight copies inside one CUDA graph:

  dma — stream the tiles, one row read per block (B8.tiled)
  bd4 — the v4 kernel on the tiles (B9.tiled)

Usage: python -m llama3_quantization_tpu_torch.microbench.w4_tiled
       [K] [N] [BK] [BN] [dma|bd4 ...] [--device cpu] [--steps N]
"""

from __future__ import annotations

import sys

from ..ops.w4_bd import w4_bd
from ..ops.w4_stream import w4_dma_tiled
from ._timing import (GS, generator, header, parse, rand_bytes, rand_ints, rand_scales, rate_line,
                      time_calls)

VARIANTS = ("dma", "bd4")
L = 8


def main(argv=None):
    a, which, dev, steps = parse(argv, "w4_tiled", [("K", 4096), ("N", 28672), ("BK", 2048),
                                                   ("BN", 512)], steps=64)
    k, n, bk, bn = a["K"], a["N"], a["BK"], a["BN"]
    which = which or list(VARIANTS)
    nk, nn = k // bk, n // bn
    gen = generator(dev)
    wt = rand_bytes(gen, (L, nk, nn, bk // 2, bn), dev)
    scale = rand_scales(gen, (L, k // GS, n), dev)
    xh = rand_ints(gen, -8, 8, (L, 1, k), dev)
    xl = rand_ints(gen, -8, 8, (L, 1, k), dev)

    header(dev)
    print(f"[{k}x{n}] bk={bk} bn={bn} tiled grid=({nn},{nk})")
    calls = {
        "dma": (w4_dma_tiled, [(wt[i],) for i in range(L)]),
        "bd4": (lambda h, lo, s, w: w4_bd(h, lo, s, w, bk, tiled=True),
                [(xh[i], xl[i], scale[i], wt[i]) for i in range(L)]),
    }
    out = {}
    for name in which:
        fn, sets = calls[name]
        out[name] = time_calls(fn, sets, steps, dev)
        print(rate_line(name, out[name], k * n / 2, dev), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
