"""Device selection for the port's entry points.

Entry points take an explicit `device` that defaults to the card. A caller
that wants the CPU says so; a missing card never silently becomes the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
