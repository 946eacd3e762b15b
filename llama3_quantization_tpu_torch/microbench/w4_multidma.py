"""One weight stream against several (port of
`scripts/microbench_w4_multidma.py`): the packed weight split along K into
S separate arrays `[K/2S, N]`, each with its own row operand
`[2gt/S, K/S]`; per tile one int4 dot per stream, summed (B9.multi). Timed
over L = 8 weight copies inside one CUDA graph.

Usage: python -m llama3_quantization_tpu_torch.microbench.w4_multidma
       [K] [N] [BK] [BN] [S...] [--device cpu] [--steps N]
"""

from __future__ import annotations

import sys

from ..ops.w4_bd import w4_multi
from ._timing import GS, generator, header, parse, rand_bytes, rand_ints, share, time_calls

L = 8


def main(argv=None):
    a, rest, dev, steps = parse(argv, "w4_multidma", [("K", 4096), ("N", 28672), ("BK", 2048),
                                                     ("BN", 512)], steps=64)
    k, n, bk, bn = a["K"], a["N"], a["BK"], a["BN"]
    streams = [int(s) for s in rest] or [1, 2, 4]
    header(dev)
    print(f"[{k}x{n}] bk={bk} bn={bn}")
    out = {}
    for s in streams:
        ks, rows = k // s, 2 * (bk // GS) // s
        if rows < 1:
            continue
        gen = generator(dev)
        ws = [rand_bytes(gen, (L, ks // 2, n), dev) for _ in range(s)]
        bds = [rand_ints(gen, -8, 8, (L, rows, ks), dev) for _ in range(s)]
        sets = [tuple(b[i] for b in bds) + tuple(w[i] for w in ws) for i in range(L)]
        dt = time_calls(lambda *t, s=s: w4_multi(t[:s], t[s:], bk), sets, steps, dev)
        out[f"S={s}"] = dt
        print(f"  S={s}: {dt * 1e6:7.1f} us/call, {k * n / 2 / dt / 1e9:5.0f} GB/s packed bytes"
              f"{share(k * n / 2, dt, dev)}", flush=True)
        del ws, bds
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
