"""Launch counts of the port's CUDA kernels.

Each wrapper adds one to its kernel's count where it launches the kernel,
and nowhere else; a run reads the counts to show which kernels it went
through. Keys are the kernel ids of the TPU kernel table in PERF.md; B5's
forms each have their own key (int4 cache, m/l statistics).
"""

from __future__ import annotations

from typing import Dict

COUNTS: Dict[str, int] = {
    "B1": 0, "B2": 0, "B5": 0, "B5.stats": 0, "B5.int4": 0, "B5.int4.stats": 0, "B7": 0,
}


def reset() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def snapshot() -> Dict[str, int]:
    return dict(COUNTS)
