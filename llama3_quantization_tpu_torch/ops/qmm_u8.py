"""u8-native unpack probes: kernel B10 (`csrc/qmm_u8.cu`).

Port of `_u8_kernel` / `u8_qmm` of `scripts/microbench_unpack.py`: s8
activations `[8, K]` against packed unsigned 4-bit codes `[K/2, N]` in the
group-local layout of `quant/pack.py` (group size 128), fp32 scale and zero
`[K/128, N]`, out fp32 `[8, N]`, in three formulations ("B10.dot2",
"B10.cat", "B10.bf16"):

- dot2 and cat: `sum_g (f32(dot_g) - f32(xsum_g) * z_g) * s_g` in group
  order, dot_g and xsum_g exact: the integers and the epilogue of B3 on "u4"
  codes without the activation scale, so their plain version is B3's
  (`qmatmul_a8.a8_plain` with s_x = 1) and the kernel equals it bit for bit;
- bf16: `sum_g bf16(x_g) @ ((bf16(c) - bf16(z_g)) * bf16(s_g))`, each group's
  dot accumulated in fp32.

CPU tensors take the plain version; CUDA tensors take the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant.pack import unpack_subbyte
from . import _build
from .launches import COUNTS
from .qmatmul_a8 import a8_plain

GS = 128
BM = 8
VARIANTS = {"dot2": 0, "cat": 1, "bf16": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("qmm_u8")
    if not getattr(lib, "_l3q_typed", False):
        lib.l3q_qmm_u8.argtypes = [_I] + [_P] * 5 + [_I, _I, _P]
        lib.l3q_qmm_u8.restype = _I
        lib._l3q_typed = True
    return lib


def u8_qmm_plain(xq, packed, scale, zero, variant: str) -> torch.Tensor:
    """B10's function for each variant (any number of rows)."""
    m, k = xq.shape
    if variant in ("dot2", "cat"):
        ones = torch.ones((m, 1), dtype=torch.float32, device=xq.device)
        return a8_plain(xq, ones, packed, "u4", scale, zero, GS, torch.float32)
    codes = unpack_subbyte(packed, 4, k, GS).to(torch.bfloat16)
    g = k // GS
    w = (codes.reshape(g, GS, -1) - zero.to(torch.bfloat16)[:, None]) * scale.to(torch.bfloat16)[:, None]
    x = xq.to(torch.bfloat16).float().reshape(m, g, GS)
    acc = torch.zeros((m, packed.shape[-1]), dtype=torch.float32, device=xq.device)
    for gi in range(g):
        acc = acc + x[:, gi] @ w[gi].float()
    return acc


def u8_qmm(xq: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
           variant: str = "dot2") -> torch.Tensor:
    """`xq` s8 `[8, K]` against u4 codes `packed` `[K/2, N]` through B10
    (`variant` dot2, cat or bf16); fp32 `[8, N]`."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {sorted(VARIANTS)}, got {variant!r}")
    if xq.device.type == "cpu":
        return u8_qmm_plain(xq, packed, scale, zero, variant)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    m, k = xq.shape
    n = packed.shape[-1]
    if m != BM or xq.dtype != torch.int8:
        raise ValueError(f"B10 takes s8 activations [{BM}, K], got {xq.dtype} {tuple(xq.shape)}")
    if packed.dtype != torch.uint8 or tuple(packed.shape) != (k // 2, n):
        raise ValueError(f"codes must be uint8 [{k // 2}, {n}]")
    for name, t in (("scale", scale), ("zero", zero)):
        if t.dtype != torch.float32 or tuple(t.shape) != (k // GS, n):
            raise ValueError(f"{name} must be float32 [{k // GS}, {n}]")
    if k % GS or n % 64:
        raise ValueError(f"B10 needs K % 128 == 0 and N % 64 == 0, got {k}, {n}")
    for name, t in (("xq", xq), ("codes", packed), ("scale", scale), ("zero", zero)):
        if not t.is_contiguous() or t.device != xq.device:
            raise ValueError(f"{name} must be contiguous on {xq.device}")
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    err = _lib().l3q_qmm_u8(VARIANTS[variant], xq.data_ptr(), packed.data_ptr(),
                            scale.data_ptr(), zero.data_ptr(), out.data_ptr(), k, n,
                            _build.stream_ptr(xq.device))
    key = f"B10.{variant}"
    _build.check(err, f"qmm_u8 ({key})")
    COUNTS[key] += 1
    return out
