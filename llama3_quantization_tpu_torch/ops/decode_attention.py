"""Single-token GQA flash decode: kernels B4/B5 (quantized KV) and B6 (fp KV).

B4/B5 port `flash_decode_gqa_s8` / `flash_decode_gqa_s8_stacked`
(`llama3_quantization_tpu/ops/decode_attention.py:214,295`) for the int8
cache and the T-pair-packed int4 cache, with or without the online-softmax
statistics m/l that the windowed decode merges (`return_stats`). The kernel
is `csrc/decode_attention.cu`; `decode_s8_plain` is its plain PyTorch
version with the same blocking and rounding points: q and the per-block
`p * v_s` are quantized to s8 (round half to even) against amax 127 for
int8 and 119 for int4 (`:133-135`), both dots are exact integer dots, and
the T blocks run in order with an online softmax. The stacked form B5 is B4
on the layer view `cache[l]`.

The TPU feeds int4 codes to its MXU by splitting each s8 activation into
two int4 rows (`_split_s8_rows`, `:78-84`); that dot is exact, so the plain
version dots the unpacked s8 codes and gets the same integers.

B6 ports `flash_decode_gqa` / `flash_decode_gqa_stacked` (`:443,389`), the
flash decode over a bf16 or fp32 cache: fp32 scores and online softmax, p
cast to the cache dtype before PV, the output in the cache dtype. Its kernel
is `csrc/decode_fp.cu`; `decode_fp_plain` runs the same T blocks with the
same rounding points.

The wrappers use the plain version for CPU tensors; for CUDA tensors they
launch the kernel or raise. Each form has its own launch count: `B5`,
`B5.stats`, `B5.int4`, `B5.int4.stats`, and `B6` (bf16 cache) / `B6.f32`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .kvcache import kv4_unpack_codes, true_div
from .launches import COUNTS

NEG = -1e30  # finite mask value: keeps the online recurrence NaN-free

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    lib = _build.load("decode_attention")
    if not getattr(lib, "_l3q_typed", False):
        lib.l3q_decode_s8.argtypes = (
            [_P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P] + [_I] * 7 + [_F, _F, _P]
        )
        lib.l3q_decode_s8.restype = _I
        lib._l3q_typed = True
    return lib


def _lib_fp():
    lib = _build.load("decode_fp")
    if not getattr(lib, "_l3q_typed", False):
        lib.l3q_decode_fp.argtypes = [_P] * 5 + [_I] * 7 + [_F, _P]
        lib.l3q_decode_fp.restype = _I
        lib._l3q_typed = True
    return lib


def launch_key(int4: bool, stats: bool) -> str:
    """The launch-count key of one kernel form."""
    return "B5" + (".int4" if int4 else "") + (".stats" if stats else "")


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


def _amax(int4: bool) -> float:
    # int4 operands must split exactly into two int4 rows: bound codes to 119
    return 119.0 if int4 else 127.0


def decode_s8_plain(q, k_q, k_s, v_q, v_s, mask, out_dtype=torch.bfloat16, block_t=1024,
                    return_stats=False):
    """B4's function. q [B, 1, Hq, D]; k_q/v_q int8 [B, G, T, D] or the
    int4 pack uint8 [B, G, T/2, D]; k_s/v_s fp32 [B, G, T, 1]; mask fp32
    [B, T] (finite). Returns o [B, 1, Hq, D], and with `return_stats` also
    the running max m and sum l, fp32 [B, G, rep]."""
    b, s, hq, d = q.shape
    int4 = k_q.dtype == torch.uint8
    if int4:
        k_q, v_q = kv4_unpack_codes(k_q), kv4_unpack_codes(v_q)
    amax = _amax(int4)
    g, t = k_q.shape[1], k_q.shape[2]
    rep = hq // g
    bt = block_size(t, block_t)
    if s != 1 or t % bt:
        raise ValueError(f"single-token decode with T % block == 0 (T={t}, block={bt})")
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(b, g, rep, d).float()
    qs = true_div(qf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8), amax)
    qc = torch.round(qf / qs).clamp(-amax, amax).to(torch.int8)
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
        ps = true_div(pv_f.abs().amax(dim=-1, keepdim=True).clamp(min=1e-20), amax)
        pc = torch.round(pv_f / ps).clamp(-amax, amax).to(torch.int8)
        pv32 = s8_dot(pc, v_q[:, :, sl])  # [B, G, rep, D]
        acc = acc * alpha + pv32.float() * ps
    out = (acc / l.clamp(min=1e-30)).reshape(b, 1, hq, d).to(out_dtype)
    if return_stats:
        return out, m[..., 0], l[..., 0]
    return out


def decode_s8(q, k_q, k_s, v_q, v_s, mask, out_dtype=torch.bfloat16, block_t=1024,
              return_stats=False):
    """Kernel B4 on the card (same arguments as `decode_s8_plain`)."""
    b, s, hq, d = q.shape
    int4 = k_q.dtype == torch.uint8
    g, t = k_q.shape[1], k_s.shape[2]
    rows = t // 2 if int4 else t
    rep = hq // g
    bt = block_size(t, block_t)
    dev = q.device
    if s != 1 or hq % g or rep not in (1, 2, 4, 8):
        raise ValueError(f"B4 takes one token and rep in (1, 2, 4, 8); got S={s}, rep={hq / g}")
    if d % 16 or d > 256 or t % bt or (int4 and bt % 2):
        raise ValueError(f"B4 needs D % 16 == 0, D <= 256 and T % block == 0 (D={d}, T={t})")
    if q.dtype not in (torch.bfloat16, torch.float32) or not q.is_contiguous():
        raise TypeError("q must be contiguous bfloat16 or float32")
    code_dtype = torch.uint8 if int4 else torch.int8
    for name, x, dt, shape in (
        ("k_q", k_q, code_dtype, (b, g, rows, d)), ("v_q", v_q, code_dtype, (b, g, rows, d)),
        ("k_s", k_s, torch.float32, (b, g, t, 1)), ("v_s", v_s, torch.float32, (b, g, t, 1)),
        ("mask", mask, torch.float32, (b, t)),
    ):
        if x.dtype != dt or tuple(x.shape) != shape or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name} must be contiguous {dt} {shape} on {dev}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"output dtype must be bfloat16 or float32, got {out_dtype}")
    out = torch.empty((b, 1, hq, d), dtype=out_dtype, device=dev)
    m = l = None
    if return_stats:
        m = torch.empty((b, g, rep), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
    err = _lib().l3q_decode_s8(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_q.data_ptr(), k_s.data_ptr(),
        v_q.data_ptr(), v_s.data_ptr(), mask.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), None if m is None else m.data_ptr(),
        None if l is None else l.data_ptr(), b, g, rep, t, d, bt, int(int4),
        float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)), _amax(int4),
        _build.stream_ptr(dev),
    )
    _build.check(err, "decode_s8 (B4/B5)")
    COUNTS[launch_key(int4, return_stats)] += 1
    return (out, m, l) if return_stats else out


def flash_decode_gqa_s8(q, k_q, k_s, v_q, v_s, mask, out_dtype=torch.bfloat16, block_t=1024,
                        return_stats=False):
    """Per-layer quantized-KV decode (B4): plain on the CPU, the kernel on CUDA."""
    if q.device.type == "cpu":
        return decode_s8_plain(q, k_q, k_s, v_q, v_s, mask, out_dtype, block_t, return_stats)
    if q.device.type == "cuda":
        return decode_s8(q, k_q, k_s, v_q, v_s, mask, out_dtype, block_t, return_stats)
    raise ValueError(f"unsupported device {q.device}")


def flash_decode_gqa_s8_stacked(
    q, k_q, k_s, v_q, v_s, mask, layer: int, out_dtype=torch.bfloat16, block_t=1024,
    return_stats=False,
):
    """B5: B4 on layer `layer` of the stacked cache `[L, B, G, T(/2), *]`,
    read in place through the layer views."""
    return flash_decode_gqa_s8(
        q, k_q[layer], k_s[layer], v_q[layer], v_s[layer], mask, out_dtype, block_t,
        return_stats,
    )


def fp_launch_key(dtype) -> str:
    """The launch-count key of B6 on a cache of `dtype`."""
    return "B6" if dtype == torch.bfloat16 else "B6.f32"


def decode_fp_plain(q, k, v, mask, block_t=512):
    """B6's function. q [B, 1, Hq, D] in the cache dtype; k/v bf16 or fp32
    [B, G, T, D]; mask fp32 [B, T] (finite). fp32 scores scaled by the fp32
    constant 1/sqrt(D) (a multiply), online softmax over T blocks in order,
    p cast to the cache dtype for PV, `acc / l` cast to q's dtype. Returns
    o [B, 1, Hq, D]."""
    b, s, hq, d = q.shape
    g, t = k.shape[1], k.shape[2]
    rep = hq // g
    bt = block_size(t, block_t)
    if s != 1 or t % bt:
        raise ValueError(f"single-token decode with T % block == 0 (T={t}, block={bt})")
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(b, g, rep, d).float()
    msk = mask.float()[:, None, None, :]
    m = torch.full((b, g, rep, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, g, rep, d), dtype=torch.float32, device=q.device)
    for t0 in range(0, t, bt):
        sl = slice(t0, t0 + bt)
        sc = torch.matmul(qf, k[:, :, sl].float().transpose(-1, -2)) * scale + msk[..., sl]
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), v[:, :, sl].float())
    return (acc / l).to(q.dtype).reshape(b, 1, hq, d)


def decode_fp(q, k, v, mask, block_t=512):
    """Kernel B6 on the card (same arguments as `decode_fp_plain`)."""
    b, s, hq, d = q.shape
    g, t = k.shape[1], k.shape[2]
    rep = hq // g
    bt = block_size(t, block_t)
    dev = q.device
    if s != 1 or hq % g or rep not in (1, 2, 4, 8):
        raise ValueError(f"B6 takes one token and rep in (1, 2, 4, 8); got S={s}, rep={hq / g}")
    if d % 8 or d > 256 or t % bt:
        raise ValueError(f"B6 needs D % 8 == 0, D <= 256 and T % block == 0 (D={d}, T={t})")
    dt = k.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"B6 takes a bfloat16 or float32 cache, got {dt}")
    for name, x, xdt, shape in (
        ("q", q, dt, (b, 1, hq, d)), ("k", k, dt, (b, g, t, d)), ("v", v, dt, (b, g, t, d)),
        ("mask", mask, torch.float32, (b, t)),
    ):
        if x.dtype != xdt or tuple(x.shape) != shape or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name} must be contiguous {xdt} {shape} on {dev}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("B6 loads k and v rows as 16-byte vectors: 16-byte aligned buffers")
    out = torch.empty((b, 1, hq, d), dtype=dt, device=dev)
    err = _lib_fp().l3q_decode_fp(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        int(dt == torch.bfloat16), b, g, rep, t, d, bt,
        float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)), _build.stream_ptr(dev),
    )
    _build.check(err, "decode_fp (B6)")
    COUNTS[fp_launch_key(dt)] += 1
    return out


def flash_decode_gqa(q, k, v, mask, block_t=512):
    """Per-layer fp-cache decode (B6): plain on the CPU, the kernel on CUDA."""
    if q.device.type == "cpu":
        return decode_fp_plain(q, k, v, mask, block_t)
    if q.device.type == "cuda":
        return decode_fp(q, k, v, mask, block_t)
    raise ValueError(f"unsupported device {q.device}")


def flash_decode_gqa_stacked(q, k, v, mask, layer: int, block_t=512):
    """B6 on layer `layer` of the stacked fp cache `[L, B, G, T, D]`, read in
    place through the layer views."""
    return flash_decode_gqa(q, k[layer], v[layer], mask, block_t)
