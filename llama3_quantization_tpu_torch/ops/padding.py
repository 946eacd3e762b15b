"""Weights padded to the kernels' tiles, made once where the weights are prepared.

JAX's `_fused_qmm` pads K to whole tiles of groups and takes any N and any
group size (`ops/pallas_qmatmul.py:362-388`). The port's kernels read a
group in whole runs of bit fields (B1 and B2: 8 * f k rows for f values
per byte; B3: 32 k), K in 64-row tiles (B2) and N in 16-column tiles.
`pad_qtensor` makes a weight that one of them does not take fit all
three:

- each group gets zero codes at its end, up to a multiple of 32 rows;
- K gets whole zero groups (scale 1, zero point 0) up to a multiple of 64;
- N gets zero columns (scale 1, zero point 0) up to a multiple of 16.

`PaddedWeight` holds the padded weight beside the shape it stands for:
`ops/matmul.qmatmul` puts zero x columns where the padded codes are and
slices the output back to N. A zero x column times any dequantized code
adds an exact 0 to every dot and every activation sum (s8 activations
too: padding does not move a row's absolute maximum), so the padded call
computes the same function on every route.

`pad_for_kernels` pads the weights of a parameter tree on the card that
need it, once, outside the loops that use them (`compute_ppl`,
`TorchLM`, and through `ops/matmul.prepare_decode_params` the generate
loops and the serving engine). The model's layer stacks
(`forward_hidden`, the decode steps) and `lm_head` call it too, so that
a direct call on a tree nobody prepared still runs (padding once per
call); on a prepared tree, or one whose shapes fit, it changes nothing
and costs a walk of the tree. The kernels' wrappers raise on a weight
that does not fit. CPU weights are left as they are: the plain versions
take every shape.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from ..quant.pack import pack_factor, pack_subbyte, unpack_subbyte
from ..quant.qtensor import QuantizedTensor
from .fused_qmatmul import B2_KT, b1_takes, b2_takes
from .launches import COUNTS
from .qmatmul_a8 import b3_gemm_takes

#: a padded group's rows: whole runs of B1's and B2's bit fields (8 * f <=
#: 32 for f <= 4) and of B3's 32-deep MMA
GROUP_RUN = 32
#: N is padded to whole 16-column tiles
N_TILE = 16


def kernels_take(qt: QuantizedTensor) -> bool:
    """Does every kernel that may serve `qt` take its shape, at any M?
    B2 always; B1 unless it holds 3-bit planes; B3 (the v3, a8 and s4
    routes; 3-bit codes reach it as s4 nibbles)."""
    return _shape_fits(qt.k, qt.n, qt.group_size or qt.k, qt.bits, qt.packed)


@functools.lru_cache(maxsize=None)
def _shape_fits(k: int, n: int, gs: int, bits: int, packed: bool) -> bool:
    planes = packed and bits == 3
    f = pack_factor(bits) if packed else 1
    layout = "s4" if planes else {1: "s8", 2: "u4", 4: "u2"}[f]
    return (b2_takes(k, n, gs, bits, packed)
            and (planes or b1_takes(1, k, n, gs, bits, packed))
            and b3_gemm_takes(k, n, gs, layout))


def _pad_codes(codes: torch.Tensor, g: int, gs: int, gp: int, k: int, n: int) -> torch.Tensor:
    """Codes `[K, N]` in groups of `gs` -> `[k, n]` in groups of `gp`: zero
    codes at each group's end, then zero rows and columns at the ends."""
    grouped = F.pad(codes.reshape(g, gs, -1), (0, 0, 0, gp - gs))
    return F.pad(grouped.reshape(g * gp, -1), (0, n - codes.shape[-1], 0, k - g * gp))


def pad_qtensor(qt: QuantizedTensor) -> QuantizedTensor:
    """`qt` (layer-stacked or not) padded as the module docstring says; the
    result's `k`, `n` and `group_size` are the padded ones."""
    if qt.g_idx is not None:
        raise ValueError("act-order (g_idx) weights take the dequant route; nothing to pad")
    gs = qt.group_size or qt.k
    g = qt.k // gs
    gp = -(-gs // GROUP_RUN) * GROUP_RUN
    tile = math.lcm(B2_KT, gp)
    k = -(-(g * gp) // tile) * tile
    n = -(-qt.n // N_TILE) * N_TILE

    def pad_layer(data: torch.Tensor) -> torch.Tensor:
        if not qt.packed:
            return _pad_codes(data, g, gs, gp, k, n)
        codes = _pad_codes(unpack_subbyte(data, qt.bits, qt.k, gs), g, gs, gp, k, n)
        return pack_subbyte(codes, qt.bits, gp)

    lead = qt.data.shape[:-2]
    layers = qt.data.reshape(-1, *qt.data.shape[-2:])
    data = torch.stack([pad_layer(d) for d in layers]).reshape(*lead, -1, n)

    def pad_groups(t: torch.Tensor, value: float) -> torch.Tensor:
        return F.pad(t, (0, n - qt.n, 0, k // gp - g), value=value).contiguous()

    return dataclasses.replace(
        qt, data=data.contiguous(), scale=pad_groups(qt.scale, 1.0),
        zero=None if qt.zero is None else pad_groups(qt.zero, 0.0),
        group_size=gp, k=k, n=n,
    )


@dataclasses.dataclass
class PaddedWeight:
    """A weight padded by `pad_qtensor` (a `QuantizedTensor`, or the
    `S4Weight` made from one), with the shape it stands for: `k`, `n` and
    `group_size` are the unpadded ones."""

    w: Any
    k: int
    n: int
    group_size: int

    def layer(self, i: int) -> "PaddedWeight":
        """Layer `i` of a layer-stacked weight (views, no copy)."""
        return dataclasses.replace(self, w=self.w.layer(i))

    def pad_x(self, x: torch.Tensor) -> torch.Tensor:
        """`x [..., K]` with zero columns where the padded weight has its
        padded codes: at each group's end and after the last group."""
        lead = x.shape[:-1]
        g, gp = self.k // self.group_size, self.w.group_size
        xg = F.pad(x.reshape(*lead, g, self.group_size), (0, gp - self.group_size))
        return F.pad(xg.reshape(*lead, g * gp), (0, self.w.k - g * gp))

    def matmul(self, x: torch.Tensor, matmul: Callable) -> torch.Tensor:
        """`matmul(x', w')[..., :N]` on the padded x and weight; counted as
        "pad" in `ops/launches.py`."""
        COUNTS["pad"] += 1
        return matmul(self.pad_x(x), self.w)[..., : self.n]


def on_card(t: torch.Tensor) -> bool:
    """Is `t` where the kernels run (a CUDA device)?"""
    return t.device.type == "cuda"


def pad_weight(qt: QuantizedTensor):
    """`qt` itself where every kernel takes its shape, off the card, or with
    act-order groups; else its `PaddedWeight`."""
    if not on_card(qt.data) or qt.g_idx is not None or kernels_take(qt):
        return qt
    return PaddedWeight(pad_qtensor(qt), qt.k, qt.n, qt.group_size or qt.k)


def map_weights(tree, fn: Callable):
    """`tree` with `fn` applied to every `QuantizedTensor` and
    `PaddedWeight` in it; the same objects where nothing changed."""
    if isinstance(tree, (QuantizedTensor, PaddedWeight)):
        return fn(tree)
    if isinstance(tree, dict):
        out = {k: map_weights(v, fn) for k, v in tree.items()}
        return tree if all(out[k] is tree[k] for k in tree) else out
    return tree


def pad_for_kernels(tree):
    """A parameter tree whose weights on the card every kernel takes: each
    `QuantizedTensor` that one does not take replaced by its
    `PaddedWeight` (`pad_weight`). Call it once, outside the loops that
    use the tree; it returns `tree` itself where nothing needs padding."""
    return map_weights(tree, lambda w: pad_weight(w) if isinstance(w, QuantizedTensor) else w)
