"""Carry a parameter tree of the JAX package into the port.

`params_from_numpy(tree)` takes the JAX tree already flattened to numpy:
nested dicts of numpy arrays, with each `QuantizedTensor` given as a dict
of its fields and meta (`data`, `scale`, `zero`, `bits`, `group_size`,
`k`, `n`, `packed`, `sym`, optionally `g_idx` and `out_dtype`; a GPTQ
act-order result carries its `g_idx`). Lists and tuples (JAX's act-stats
list) are walked too, so OmniQuant's LWC/LET aux trees and SmoothQuant's
activation statistics come across the same way. Layouts and dtypes are
kept as they are, bf16 included.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .device import resolve_device
from .quant.qtensor import QuantizedTensor

_QT_FIELDS = ("data", "scale", "zero", "bits")

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def tensor_from_numpy(arr, device) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")  # owned and writable
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _qtensor(d: Mapping[str, Any], device) -> QuantizedTensor:
    def opt(name):
        val = d.get(name)
        return None if val is None else tensor_from_numpy(val, device)

    out_dtype = d.get("out_dtype", "bfloat16")
    return QuantizedTensor(
        data=tensor_from_numpy(d["data"], device),
        scale=tensor_from_numpy(d["scale"], device),
        zero=opt("zero"),
        bits=int(d["bits"]),
        group_size=None if d.get("group_size") is None else int(d["group_size"]),
        sym=bool(d.get("sym", False)),
        k=int(d["k"]),
        n=int(d["n"]),
        packed=bool(d["packed"]),
        out_dtype=_DTYPES[str(out_dtype)],
        g_idx=opt("g_idx"),
    )


def params_from_numpy(tree: Mapping[str, Any], device="cuda"):
    """Nested dict of numpy arrays (JAX layout) -> the port's parameters."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, Mapping):
            if all(f in node for f in _QT_FIELDS):
                return _qtensor(node, dev)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return tensor_from_numpy(node, dev)

    return walk(tree)
