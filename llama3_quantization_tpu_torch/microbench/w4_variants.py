"""The cost structure of the v4 packed-W4 formulation on the card (port of
`scripts/microbench_w4_variants.py`). Variants, each timed over L = 8 weight
copies inside one CUDA graph:

  dma     — stream the weight, read one row per block (B8.w4): the ceiling
  dot4    — a given dense int4 row operand, int4 x int4 dot (B9.dot4)
  bd4     — the v4 kernel: block-diagonal xh / xl rows (B9.v4)
  cast8   — the weight widened to s8, an s8 row operand of gt rows (B9.cast8)
  noscale — dot4's product without the scale epilogue (B9.noscale)

Usage: python -m llama3_quantization_tpu_torch.microbench.w4_variants
       [K] [N] [BK] [BN] [variant...] [--device cpu] [--steps N]
"""

from __future__ import annotations

import sys

from ..ops.w4_bd import w4_bd, w4_cast8, w4_dot4, w4_noscale
from ..ops.w4_stream import w4_dma
from ._timing import (GS, generator, header, parse, rand_bytes, rand_ints, rand_scales, rate_line,
                      time_calls)

VARIANTS = ("dma", "dot4", "bd4", "cast8", "noscale")
L = 8


def main(argv=None):
    a, which, dev, steps = parse(argv, "w4_variants", [("K", 4096), ("N", 28672), ("BK", 2048),
                                                      ("BN", 512)], steps=64)
    k, n, bk, bn = a["K"], a["N"], a["BK"], a["BN"]
    which = which or list(VARIANTS)
    g = k // GS
    gen = generator(dev)
    packed = rand_bytes(gen, (L, k // 2, n), dev)
    scale = rand_scales(gen, (L, g, n), dev)
    bd2 = rand_ints(gen, -8, 8, (L, 2 * g, k), dev)
    bd1 = rand_ints(gen, -120, 120, (L, g, k), dev)
    xh = rand_ints(gen, -8, 8, (L, 1, k), dev)
    xl = rand_ints(gen, -8, 8, (L, 1, k), dev)

    header(dev)
    print(f"[{k}x{n}] bk={bk} bn={bn} grid=({n // bn},{k // bk})")
    calls = {
        "dma": (lambda w: w4_dma(w, bk), [(packed[i],) for i in range(L)]),
        "dot4": (lambda b, s, w: w4_dot4(b, s, w, bk), [(bd2[i], scale[i], packed[i]) for i in range(L)]),
        "bd4": (lambda h, lo, s, w: w4_bd(h, lo, s, w, bk),
                [(xh[i], xl[i], scale[i], packed[i]) for i in range(L)]),
        "cast8": (lambda b, s, w: w4_cast8(b, s, w, bk), [(bd1[i], scale[i], packed[i]) for i in range(L)]),
        "noscale": (lambda b, w: w4_noscale(b, w, bk), [(bd2[i], packed[i]) for i in range(L)]),
    }
    out = {}
    for name in which:
        fn, sets = calls[name]
        out[name] = time_calls(fn, sets, steps, dev)
        print(rate_line(name, out[name], k * n / 2, dev), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
