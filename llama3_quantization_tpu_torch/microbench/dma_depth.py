"""Copy-pipeline depth on the card (port of `scripts/microbench_dma_depth.py`):
an int8 array of MB megabytes, width 1024, streamed in chunks of CHUNK_KB
with D stages of `cp.async` copies in flight per block of threads (B8.depth),
for each depth. Timed as 20 calls inside one CUDA graph, as the script
times 20 calls.

Usage: python -m llama3_quantization_tpu_torch.microbench.dma_depth
       [MB] [CHUNK_KB] [DEPTH...] [--device cpu] [--steps N]
"""

from __future__ import annotations

import sys

from ..ops.w4_stream import dma_depth
from ._timing import generator, header, parse, rand_bytes, share, time_calls

WIDTH = 1024


def main(argv=None):
    a, rest, dev, steps = parse(argv, "dma_depth", [("MB", 64), ("CHUNK_KB", 512)], steps=20)
    mb, chunk_kb = a["MB"], a["CHUNK_KB"]
    depths = [int(d) for d in rest] or [1, 2, 4, 8]
    total_rows = mb * 1024 * 1024 // WIDTH
    chunk_rows = chunk_kb * 1024 // WIDTH
    x = rand_bytes(generator(dev), (total_rows, WIDTH), dev)
    nbytes = total_rows * WIDTH
    header(dev)
    out = {}
    for depth in depths:
        dt = time_calls(lambda d=depth: dma_depth(x, chunk_rows, d), [()], steps, dev)
        out[f"depth={depth}"] = dt
        print(f"  depth={depth}: {dt * 1e3:.4f} ms for {mb} MB -> {nbytes / dt / 1e9:5.0f} GB/s"
              f"{share(nbytes, dt, dev)}", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
