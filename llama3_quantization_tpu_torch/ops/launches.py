"""Launch counts of the port's CUDA kernels.

Each wrapper adds one to its kernel's count where it launches the kernel,
and nowhere else; a run reads the counts to show which kernels it went
through. Keys are the kernel ids of the TPU kernel table in PERF.md; the
forms of one kernel each have their own key: B2 on 3-bit planes; B3's GEMV
form by caller (v3 on a QuantizedTensor, the s4 backend, the a8 backend)
and its tiled form; B5 on the int4 cache and with m/l statistics; B6 on
an fp32 cache (`B6` is the bf16 cache); the weight-stream probes of the
microbenches by form: B8 (the stream alone: row-major, tiled, by depth), B9
(int4 dots: v4, dot4, cast8, noscale, tiled, multi-stream) and B10 (u8
unpack: dot2, cat, bf16).

`ROUTES` counts the calls that did not reach a kernel with their shapes as
the model gives them: "pad" the matmuls on a weight padded to the
kernels' tiles (`ops/padding.py`; the kernel's own count also moves),
`.eager` the attention calls whose shape a decode or flash kernel's
predicate (`b5_takes`, `b6_takes`, `b7_takes`) turned away to the eager
attention. A full-width path reads 0 in all of them.
"""

from __future__ import annotations

from typing import Dict

COUNTS: Dict[str, int] = {
    "B1": 0, "B2": 0, "B2.w3": 0, "B3.v3": 0, "B3.s4": 0, "B3.s8": 0, "B3.gemm": 0,
    "B5": 0, "B5.stats": 0, "B5.int4": 0, "B5.int4.stats": 0, "B6": 0, "B6.f32": 0, "B7": 0,
    "B8.w4": 0, "B8.tiled": 0, "B8.depth": 0, "B9.v4": 0, "B9.dot4": 0, "B9.cast8": 0,
    "B9.noscale": 0, "B9.tiled": 0, "B9.multi": 0, "B10.dot2": 0, "B10.cat": 0, "B10.bf16": 0,
}
ROUTES = ("pad", "B5.eager", "B6.eager", "B7.eager")
COUNTS.update({key: 0 for key in ROUTES})


def reset() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def snapshot() -> Dict[str, int]:
    return dict(COUNTS)
