"""int8-KV single-token GQA flash decode: kernel B4/B5.

Port of `flash_decode_gqa_s8` / `flash_decode_gqa_s8_stacked`
(`llama3_quantization_tpu/ops/decode_attention.py:214,295`) for the int8
cache. The kernel is `csrc/decode_attention.cu`; `decode_s8_plain` is its
plain PyTorch version with the same blocking and rounding points: q and
the per-block `p * v_s` are quantized to s8 (round half to even), both dots
are exact integer dots, and the T blocks run in order with an online
softmax. The stacked form B5 is B4 on the layer view `cache[l]`.

The wrapper uses the plain version for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .launches import COUNTS

NEG = -1e30  # finite mask value: keeps the online recurrence NaN-free

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("decode_attention")
    if not getattr(lib, "_l3q_typed", False):
        lib.l3q_decode_s8.argtypes = (
            [_P, _I, _P, _P, _P, _P, _P, _P, _I] + [_I] * 6 + [ctypes.c_float, _P]
        )
        lib.l3q_decode_s8.restype = _I
        lib._l3q_typed = True
    return lib


def s8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 batched matmul `a @ b`.

    Each product is at most 127*127 and at most 1024 terms are summed, so
    every partial sum stays below 2^24 and fp32 (or TF32, whose 10-bit
    mantissa holds any int8) carries it exactly."""
    if a.shape[-1] > 1024:
        raise ValueError("s8_dot is exact only for contractions of <= 1024 terms")
    return torch.matmul(a.float(), b.float()).to(torch.int32)


def block_size(t: int, block_t: int = 1024) -> int:
    return min(block_t, t)


def decode_s8_plain(q, k_q, k_s, v_q, v_s, mask, out_dtype=torch.bfloat16, block_t=1024):
    """B4's function. q [B, 1, Hq, D]; k_q/v_q int8 [B, G, T, D]; k_s/v_s
    fp32 [B, G, T, 1]; mask fp32 [B, T] (finite). Returns [B, 1, Hq, D]."""
    b, s, hq, d = q.shape
    g, t = k_q.shape[1], k_q.shape[2]
    rep = hq // g
    bt = block_size(t, block_t)
    if s != 1 or t % bt:
        raise ValueError(f"single-token decode with T % block == 0 (T={t}, block={bt})")
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(b, g, rep, d).float()
    qs = qf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    qc = torch.round(qf / qs).clamp(-127, 127).to(torch.int8)
    qsc = qs * scale
    ks = k_s.reshape(b, g, 1, t)
    vs = v_s.reshape(b, g, 1, t)
    msk = mask.float()[:, None, None, :]
    m = torch.full((b, g, rep, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, g, rep, d), dtype=torch.float32, device=q.device)
    for t0 in range(0, t, bt):
        sl = slice(t0, t0 + bt)
        s32 = s8_dot(qc, k_q[:, :, sl].transpose(-1, -2))  # [B, G, rep, bt]
        sc = s32.float() * qsc * ks[..., sl] + msk[..., sl]
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        pv_f = p * vs[..., sl]
        ps = pv_f.abs().amax(dim=-1, keepdim=True).clamp(min=1e-20) / 127.0
        pc = torch.round(pv_f / ps).clamp(-127, 127).to(torch.int8)
        pv32 = s8_dot(pc, v_q[:, :, sl])  # [B, G, rep, D]
        acc = acc * alpha + pv32.float() * ps
    out = acc / l.clamp(min=1e-30)
    return out.reshape(b, 1, hq, d).to(out_dtype)


def decode_s8(q, k_q, k_s, v_q, v_s, mask, out_dtype=torch.bfloat16, block_t=1024):
    """Kernel B4 on the card (same arguments as `decode_s8_plain`)."""
    b, s, hq, d = q.shape
    g, t = k_q.shape[1], k_q.shape[2]
    rep = hq // g
    bt = block_size(t, block_t)
    dev = q.device
    if s != 1 or hq % g or rep not in (1, 2, 4, 8):
        raise ValueError(f"B4 takes one token and rep in (1, 2, 4, 8); got S={s}, rep={hq / g}")
    if d % 16 or d > 256 or t % bt:
        raise ValueError(f"B4 needs D % 16 == 0, D <= 256 and T % block == 0 (D={d}, T={t})")
    if q.dtype not in (torch.bfloat16, torch.float32) or not q.is_contiguous():
        raise TypeError("q must be contiguous bfloat16 or float32")
    for name, x, dt, shape in (
        ("k_q", k_q, torch.int8, (b, g, t, d)), ("v_q", v_q, torch.int8, (b, g, t, d)),
        ("k_s", k_s, torch.float32, (b, g, t, 1)), ("v_s", v_s, torch.float32, (b, g, t, 1)),
        ("mask", mask, torch.float32, (b, t)),
    ):
        if x.dtype != dt or tuple(x.shape) != shape or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name} must be contiguous {dt} {shape} on {dev}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"output dtype must be bfloat16 or float32, got {out_dtype}")
    out = torch.empty((b, 1, hq, d), dtype=out_dtype, device=dev)
    err = _lib().l3q_decode_s8(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_q.data_ptr(), k_s.data_ptr(),
        v_q.data_ptr(), v_s.data_ptr(), mask.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), b, g, rep, t, d, bt,
        float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)),
        _build.stream_ptr(dev),
    )
    _build.check(err, "decode_s8 (B4/B5)")
    COUNTS["B5"] += 1
    return out


def flash_decode_gqa_s8(q, k_q, k_s, v_q, v_s, mask, out_dtype=torch.bfloat16, block_t=1024):
    """Per-layer int8-KV decode (B4): plain on the CPU, the kernel on CUDA."""
    if q.device.type == "cpu":
        return decode_s8_plain(q, k_q, k_s, v_q, v_s, mask, out_dtype, block_t)
    if q.device.type == "cuda":
        return decode_s8(q, k_q, k_s, v_q, v_s, mask, out_dtype, block_t)
    raise ValueError(f"unsupported device {q.device}")


def flash_decode_gqa_s8_stacked(
    q, k_q, k_s, v_q, v_s, mask, layer: int, out_dtype=torch.bfloat16, block_t=1024
):
    """B5: B4 on layer `layer` of the stacked cache `[L, B, G, T, *]`, read
    in place through the layer views."""
    return flash_decode_gqa_s8(
        q, k_q[layer], k_s[layer], v_q[layer], v_s[layer], mask, out_dtype, block_t
    )
