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
on the layer view `cache[l]`. The kernel splits each T block over a
thread-block cluster (`s8_split_plan`); `decode_s8_split_plain` is that
algorithm in PyTorch, which differs from `decode_s8_plain` only in the
order of the fp32 sum l.

The TPU feeds int4 codes to its MXU by splitting each s8 activation into
two int4 rows (`_split_s8_rows`, `:78-84`); that dot is exact, so the plain
version dots the unpacked s8 codes and gets the same integers.

B6 ports `flash_decode_gqa` / `flash_decode_gqa_stacked` (`:443,389`), the
flash decode over a bf16 or fp32 cache: fp32 scores and online softmax, p
cast to the cache dtype before PV, the output in the cache dtype. Its kernel
is `csrc/decode_fp.cu`, split along T into chunks (`fp_split_chunk`) with
each chunk's p formed against the running max of the TPU kernel's T blocks;
`decode_fp_plain` runs the same T blocks in order with the same rounding
points, and `decode_fp_split_plain` is the split algorithm in PyTorch.

`xla_decode_gqa_s8(_stacked)` ports the codes-direct int8 route
(`:491-586`), JAX's default int8 route on a TPU, which is XLA code outside
any Pallas kernel: plain tensor ops on either device, selected by
`models.transformer.set_decode_attn("xla")`.

The kernels hold rep 1, 2, 4 and 8 query heads per K/V head
(`DECODE_REPS`); the CUDA wrappers take any rep up to 8 by padding each
group's query rows with zeros up to the next form (3 -> 4, 5/6/7 -> 8, as
JAX pads them to 8, `:123,243,325`) and slicing o, m and l back. That is
exact: every row's s8 quantization, softmax and PV are its own, so a zero
row changes no other row.

The wrappers use the plain version for CPU tensors; for CUDA tensors they
launch the kernel or raise. `b5_takes` and `b6_takes` are the ranges of
shapes the kernels take, which their raises and the decode gates in
`models/transformer.py` and `models/windowed.py` read. Each form has its own launch count: `B5`,
`B5.stats`, `B5.int4`, `B5.int4.stats`, and `B6` (bf16 cache) / `B6.f32`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

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
            [_P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P] + [_I] * 8 + [_F, _F, _P]
        )
        lib.l3q_decode_s8.restype = _I
        lib._l3q_typed = True
    return lib


def _lib_fp():
    lib = _build.load("decode_fp")
    if not getattr(lib, "_l3q_typed", False):
        lib.l3q_decode_fp.argtypes = [_P] * 6 + [_I] * 8 + [_F, _P]
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


def s8_dot_long(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`s8_dot` over a contraction of any length: the int32 sum of exact
    dots over chunks of at most 1024 terms, itself exact."""
    n = a.shape[-1]
    out = s8_dot(a[..., :1024], b[..., :1024, :])
    for c0 in range(1024, n, 1024):
        out = out + s8_dot(a[..., c0 : c0 + 1024], b[..., c0 : c0 + 1024, :])
    return out


def block_size(t: int, block_t: int = 1024) -> int:
    return min(block_t, t)


#: query heads per K/V head that the decode kernels' layouts hold; the
#: wrappers pad any other rep up to 8 to the next of them (`padded_rep`)
DECODE_REPS = (1, 2, 4, 8)
MAX_DECODE_REP = 8


def padded_rep(rep: int) -> int:
    """The kernel form that serves `rep` query heads per K/V head."""
    return next(r for r in DECODE_REPS if r >= rep)


def _pad_rep(q: torch.Tensor, g: int, rp: int) -> torch.Tensor:
    """q [B, 1, G * rep, D] -> [B, 1, G * rp, D]: each group's query rows
    followed by zero rows."""
    b, s, hq, d = q.shape
    rep = hq // g
    if rp == rep:
        return q
    qg = q.reshape(b, s, g, rep, d)
    return torch.cat([qg, qg.new_zeros((b, s, g, rp - rep, d))], dim=3).reshape(b, s, g * rp, d)


def _unpad_rep(o: torch.Tensor, g: int, rep: int) -> torch.Tensor:
    """o [B, 1, G * rp, D] -> [B, 1, G * rep, D]."""
    b, s, hp, d = o.shape
    if hp == g * rep:
        return o
    return o.reshape(b, s, g, hp // g, d)[:, :, :, :rep].reshape(b, s, g * rep, d)


def b5_takes(hq: int, g: int, d: int, t: int, block_t: int, int4: bool) -> bool:
    """Does B4/B5 take one token of `hq` query heads over `g` K/V heads of
    head dim `d` against a cache of `t` tokens in T blocks of `block_t`?
    rep = hq / g of at most 8 (the wrapper pads it to a form of
    DECODE_REPS), D % 16 == 0 and D <= 256, T a whole number of blocks (of
    an even length on the int4 pack)."""
    bt = block_size(t, block_t)
    return (g > 0 and hq % g == 0 and hq // g <= MAX_DECODE_REP and d % 16 == 0 and d <= 256
            and bt > 0 and t % bt == 0 and not (int4 and bt % 2))


def b6_takes(hq: int, g: int, d: int, t: int, block_t: int, dtype) -> bool:
    """Does B6 take one token of `hq` query heads over `g` K/V heads of
    head dim `d` against a `dtype` cache of `t` tokens in T blocks of
    `block_t`? rep of at most 8 (padded to a form of DECODE_REPS), D % 8 ==
    0 and D <= 256, T a whole number of blocks, a bf16 or fp32 cache."""
    bt = block_size(t, block_t)
    return (g > 0 and hq % g == 0 and hq // g <= MAX_DECODE_REP and d % 8 == 0 and d <= 256
            and bt > 0 and t % bt == 0 and dtype in (torch.bfloat16, torch.float32))


def _amax(int4: bool) -> float:
    # int4 operands must split exactly into two int4 rows: bound codes to 119
    return 119.0 if int4 else 127.0


class S8SplitPlan(NamedTuple):
    """How B4/B5's kernel splits each T block: one thread-block cluster of
    `cluster` blocks per (b, g) pair, block r taking the `slice`
    consecutive tokens from r * slice of every T block."""

    cluster: int  #: blocks per (b, g) pair (one cluster)
    slice: int    #: tokens of each T block per block (bt / cluster)


#: the largest cluster the plan gives (8, the portable size on an H100: the
#: kernel also takes 16, slower at B = 8 in the cluster sweep of
#: `chip_smoke.py --kernel-bench`) and the fewest tokens of a slice (one
#: 16-row MMA operand)
S8_MAX_CLUSTER = 8
S8_MIN_SLICE = 16


def s8_split_plan(t: int, bt: int, d: int, int4: bool) -> S8SplitPlan:
    """The split of B4/B5 for a cache of `t` tokens in T blocks of `bt`, head
    dim `d`: the largest cluster S <= S8_MAX_CLUSTER whose slices bt / S are
    whole multiples of 16 tokens (so even: no int4 T-pair is split), down
    to S = 1 (one slice of the whole block, any length). Made from these four
    alone, never from B: a row's o, m and l do not depend on how many
    slots the batch holds."""
    if bt <= 0 or t % bt or d % 16 or (int4 and bt % 2):
        raise ValueError(f"no B4/B5 split for T={t}, block={bt}, D={d}, int4={int4}")
    s = S8_MAX_CLUSTER
    while s > 1 and bt % (s * S8_MIN_SLICE):
        s //= 2
    return S8SplitPlan(s, bt // s)


def _s8_prologue(q, k_q, k_s, v_s, mask, block_t):
    """What the plain B4 versions share: whether the cache is the int4 pack,
    its amax, the T block, the s8 q codes and their score scale qs /
    sqrt(D), and the per-token scales and mask shaped to broadcast against
    [B, G, rep, T]."""
    b, s, hq, d = q.shape
    int4 = k_q.dtype == torch.uint8
    amax = _amax(int4)
    g, t = k_s.shape[1], k_s.shape[2]
    rep = hq // g
    bt = block_size(t, block_t)
    if s != 1 or t % bt:
        raise ValueError(f"single-token decode with T % block == 0 (T={t}, block={bt})")
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(b, g, rep, d).float()
    qs = true_div(qf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8), amax)
    qc = torch.round(qf / qs).clamp(-amax, amax).to(torch.int8)
    return (int4, amax, bt, qc, qs * scale, k_s.reshape(b, g, 1, t), v_s.reshape(b, g, 1, t),
            mask.float()[:, None, None, :])


def _s8_epilogue(q, acc, m, l, codes, sums, out_dtype, return_stats, return_codes):
    b, _, hq, d = q.shape
    out = (acc / l.clamp(min=1e-30)).reshape(b, 1, hq, d).to(out_dtype)
    res = (out,)
    if return_stats:
        res += (m[..., 0], l[..., 0])
    if return_codes:
        res += (torch.cat(codes, dim=-1), torch.stack(sums, dim=-2))
    return res if len(res) > 1 else out


def decode_s8_plain(q, k_q, k_s, v_q, v_s, mask, out_dtype=torch.bfloat16, block_t=1024,
                    return_stats=False, return_codes=False):
    """B4's function. q [B, 1, Hq, D]; k_q/v_q int8 [B, G, T, D] or the
    int4 pack uint8 [B, G, T/2, D]; k_s/v_s fp32 [B, G, T, 1]; mask fp32
    [B, T] (finite). Returns o [B, 1, Hq, D], and with `return_stats` also
    the running max m and sum l, fp32 [B, G, rep]; with `return_codes`
    also every T block's probability codes, int8 [B, G, rep, T], and its
    s32 PV sums, int32 [B, G, rep, T / bt, D]."""
    int4, amax, bt, qc, qsc, ks, vs, msk = _s8_prologue(q, k_q, k_s, v_s, mask, block_t)
    if int4:
        k_q, v_q = kv4_unpack_codes(k_q), kv4_unpack_codes(v_q)
    t = ks.shape[-1]
    m = torch.full(qsc.shape, NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*qc.shape[:3], q.shape[-1]), dtype=torch.float32, device=q.device)
    codes, sums = [], []
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
        codes.append(pc)
        sums.append(pv32)
        acc = acc * alpha + pv32.float() * ps
    return _s8_epilogue(q, acc, m, l, codes, sums, out_dtype, return_stats, return_codes)


def decode_s8_split_plain(q, k_q, k_s, v_q, v_s, mask, out_dtype=torch.bfloat16, block_t=1024,
                          return_stats=False, return_codes=False):
    """The kernel's split algorithm in PyTorch (not on any path: the tests
    and `chip_smoke.py` hold it against `decode_s8_plain`). Same arguments
    and results. Each T block is cut into the plan's slices: per-slice row
    maxima and amaxima of `p * v_s`, whose maxima are the block's (so m,
    every probability code and every s32 PV sum are `decode_s8_plain`'s
    bit for bit); the block's l is the slice sums of p added in rank
    order, its PV sum the slices' s32 partials added in rank order."""
    int4, amax, bt, qc, qsc, ks, vs, msk = _s8_prologue(q, k_q, k_s, v_s, mask, block_t)
    if int4:
        k_q, v_q = kv4_unpack_codes(k_q), kv4_unpack_codes(v_q)
    b, g, rep, _ = qc.shape
    t, d = ks.shape[-1], q.shape[-1]
    n, sl = s8_split_plan(t, bt, d, int4)
    m = torch.full(qsc.shape, NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, g, rep, d), dtype=torch.float32, device=q.device)
    codes, sums = [], []
    for t0 in range(0, t, bt):
        sl_ = slice(t0, t0 + bt)
        s32 = s8_dot(qc, k_q[:, :, sl_].transpose(-1, -2))
        sc = s32.float() * qsc * ks[..., sl_] + msk[..., sl_]
        smax = sc.reshape(b, g, rep, n, sl).amax(dim=-1)  # 1. slice row maxima
        m_new = torch.maximum(m, smax.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        lp = p.reshape(b, g, rep, n, sl).sum(dim=-1)  # 2. slice sums, added in rank order
        lb = lp[..., 0]
        for r in range(1, n):
            lb = lb + lp[..., r]
        l = l * alpha + lb[..., None]
        m = m_new
        pv_f = p * vs[..., sl_]
        pa = pv_f.abs().reshape(b, g, rep, n, sl).amax(dim=-1).amax(dim=-1, keepdim=True)
        ps = true_div(pa.clamp(min=1e-20), amax)
        pc = torch.round(pv_f / ps).clamp(-amax, amax).to(torch.int8)
        part = s8_dot(pc.reshape(b, g, rep, n, sl).transpose(2, 3),  # 3. PV partials
                      v_q[:, :, sl_].reshape(b, g, n, sl, d))     # [B, G, S, rep, D]
        pv32 = part[:, :, 0]
        for r in range(1, n):
            pv32 = pv32 + part[:, :, r]
        codes.append(pc)
        sums.append(pv32)
        acc = acc * alpha + pv32.float() * ps
    return _s8_epilogue(q, acc, m, l, codes, sums, out_dtype, return_stats, return_codes)


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
    if s != 1 or not b5_takes(hq, g, d, t, block_t, int4):
        raise ValueError(f"B4 takes one token, rep <= {MAX_DECODE_REP}, D % 16 == 0, D <= 256 and "
                         f"T % block == 0 (b5_takes); got S={s}, rep={hq / g}, D={d}, T={t}")
    if q.dtype not in (torch.bfloat16, torch.float32) or not q.is_contiguous():
        raise TypeError("q must be contiguous bfloat16 or float32")
    plan = s8_split_plan(t, bt, d, int4)
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
    if k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError("B4 reads k_q and v_q as TMA boxes: 16-byte aligned buffers")
    rp = padded_rep(rep)
    qp = _pad_rep(q, g, rp)
    out = torch.empty((b, 1, g * rp, d), dtype=out_dtype, device=dev)
    m = l = None
    if return_stats:
        m = torch.empty((b, g, rp), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
    err = _lib().l3q_decode_s8(
        qp.data_ptr(), int(q.dtype == torch.bfloat16), k_q.data_ptr(), k_s.data_ptr(),
        v_q.data_ptr(), v_s.data_ptr(), mask.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), None if m is None else m.data_ptr(),
        None if l is None else l.data_ptr(), b, g, rp, t, d, bt, plan.cluster, int(int4),
        float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)), _amax(int4),
        _build.stream_ptr(dev),
    )
    _build.check(err, "decode_s8 (B4/B5)")
    COUNTS[launch_key(int4, return_stats)] += 1
    out = _unpad_rep(out, g, rep)
    return (out, m[..., :rep], l[..., :rep]) if return_stats else out


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


def _xla_s8_core(qg, kq, ks, vq, vs, mask):
    """The codes-direct route's math (`decode_attention.py:491-524`): qg
    [B, G, rep, D] fp32; kq/vq int8 [B, G, T, D]; ks/vs fp32 [B, G, T];
    mask fp32 [B, T]. The PV dot over the codes of `xla_s8_probs` is exact
    in s32, and o = pv32 * ps / max(l, 1e-30). Returns (o [B, G, rep, D],
    m, l), m and l fp32 [B, G, rep]."""
    pc, ps, m, l = xla_s8_probs(qg, kq, ks, vs, mask)
    pv32 = s8_dot_long(pc, vq)  # [B, G, rep, D]: contracts T
    o = pv32.float() * ps / l.clamp(min=1e-30)[..., None]
    return o, m, l


def xla_s8_probs(qg, kq, ks, vs, mask):
    """The codes-direct route up to its PV dot: q is quantized per row to
    s8 against max(amax, 1e-8) / 127, the QK dot is exact in s32, the
    scores `s32 * (qs * scale) * ks + mask` take one softmax over the whole
    T, and the probabilities `p * vs` are requantized per row against
    max(amax, 1e-20) / 127. Returns (pc int8 [B, G, rep, T], ps fp32
    [B, G, rep, 1], m, l)."""
    d = qg.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qs = true_div(qg.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8), 127.0)
    qc = torch.round(qg / qs).clamp(-127, 127).to(torch.int8)
    s32 = s8_dot(qc, kq.transpose(-1, -2))  # [B, G, rep, T]: contracts D
    s = s32.float() * (qs * scale) * ks[:, :, None, :] + mask[:, None, None, :]
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    pv_f = p * vs[:, :, None, :]
    ps = true_div(pv_f.abs().amax(dim=-1, keepdim=True).clamp(min=1e-20), 127.0)
    pc = torch.round(pv_f / ps).clamp(-127, 127).to(torch.int8)
    return pc, ps, m, l


def xla_decode_gqa_s8(q, k_q, k_s, v_q, v_s, mask, out_dtype=torch.bfloat16,
                      return_stats=False):
    """The codes-direct int8-KV decode (`decode_attention.py:527-555`), the
    JAX package's default int8 route on a TPU, where it is XLA code outside
    any Pallas kernel: plain tensor ops here, on either device. q
    [B, 1, Hq, D]; k_q/v_q int8 [B, G, T, D]; k_s/v_s fp32 [B, G, T, 1];
    mask fp32 [B, T]. Returns o [B, 1, Hq, D] in `out_dtype`, and with
    `return_stats` also m and l fp32 [B, G, rep]."""
    b, s, hq, d = q.shape
    if s != 1 or k_q.dtype != torch.int8:
        raise ValueError(f"single-token decode over int8 codes (S={s}, codes {k_q.dtype})")
    g, t = k_q.shape[1], k_q.shape[2]
    qg = q.reshape(b, g, hq // g, d).float()
    o, m, l = _xla_s8_core(qg, k_q, k_s.reshape(b, g, t), v_q, v_s.reshape(b, g, t),
                           mask.float())
    out = o.reshape(b, 1, hq, d).to(out_dtype)
    return (out, m, l) if return_stats else out


def xla_decode_gqa_s8_stacked(q, k_q, k_s, v_q, v_s, mask, layer: int,
                              out_dtype=torch.bfloat16, return_stats=False):
    """`xla_decode_gqa_s8` on layer `layer` of the stacked int8 cache
    `[L, B, G, T, *]` (`decode_attention.py:558-586`), through the layer
    views."""
    return xla_decode_gqa_s8(q, k_q[layer], k_s[layer], v_q[layer], v_s[layer], mask,
                             out_dtype, return_stats)


def fp_launch_key(dtype) -> str:
    """The launch-count key of B6 on a cache of `dtype`."""
    return "B6" if dtype == torch.bfloat16 else "B6.f32"


def decode_fp_plain(q, k, v, mask, block_t=512, return_p=False):
    """B6's function. q [B, 1, Hq, D] in the cache dtype; k/v bf16 or fp32
    [B, G, T, D]; mask fp32 [B, T] (finite). fp32 scores scaled by the fp32
    constant 1/sqrt(D) (a multiply), online softmax over T blocks in order,
    p cast to the cache dtype for PV, `acc / l` cast to q's dtype. Returns
    o [B, 1, Hq, D], and with `return_p` also the rounded p fp32
    [B, G, rep, T] that entered PV."""
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
    ps = []
    for t0 in range(0, t, bt):
        sl = slice(t0, t0 + bt)
        sc = _fp_scores(qf, k[:, :, sl], msk[..., sl], scale)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        pr = p.to(v.dtype).float()
        ps.append(pr)
        acc = acc * alpha + torch.matmul(pr, v[:, :, sl].float())
    out = (acc / l).to(q.dtype).reshape(b, 1, hq, d)
    return (out, torch.cat(ps, dim=-1)) if return_p else out


def _fp_scores(qf, k_blk, msk_blk, scale):
    """fp32 scores of one T block: `f32(q . k^T) * scale + mask`."""
    return torch.matmul(qf, k_blk.float().transpose(-1, -2)) * scale + msk_blk


#: streaming multiprocessors of an H100: the split B6 wants this many blocks
SMS = 132


def fp_split_chunk(bg: int, t: int, bt: int) -> int:
    """Tokens per block of the split B6: halve the T block `bt` while the
    grid of `bg * t / c` blocks stays below one per SM, down to 16 tokens.
    Depends on (B * G, T) only."""
    c = bt
    while c % 2 == 0 and c >= 32 and bg * (t // c) < SMS:
        c //= 2
    return c


def decode_fp_split_plain(q, k, v, mask, block_t=512, return_p=False):
    """The split B6's algorithm in PyTorch, with its chunking (not on the
    main path: the tests and `chip_smoke.py` hold it against
    `decode_fp_plain`). Same arguments. Scores per T block as
    `decode_fp_plain` forms them, row maxima per chunk of
    `fp_split_chunk` tokens; each chunk's p = exp(s - m_prefix) with
    m_prefix the running max up to the end of its T block (from -1e30), so
    the rounded p are the sequential ones bit for bit; l and PV partials
    per chunk; combined with weights exp(m_prefix - M) in chunk order."""
    b, s, hq, d = q.shape
    g, t = k.shape[1], k.shape[2]
    rep = hq // g
    bt = block_size(t, block_t)
    if s != 1 or t % bt:
        raise ValueError(f"single-token decode with T % block == 0 (T={t}, block={bt})")
    c = fp_split_chunk(b * g, t, bt)
    nc, per = t // c, bt // c
    scale = 1.0 / math.sqrt(d)
    qf = q.reshape(b, g, rep, d).float()
    msk = mask.float()[:, None, None, :]
    sc = torch.cat([_fp_scores(qf, k[:, :, t0 : t0 + bt], msk[..., t0 : t0 + bt], scale)
                    for t0 in range(0, t, bt)], dim=-1).reshape(b, g, rep, nc, c)
    cmax = sc.amax(dim=-1)  # 1. chunk row maxima [B, G, rep, NC]
    bmax = cmax.reshape(b, g, rep, nc // per, per).amax(dim=-1)
    mp = torch.cummax(bmax.clamp(min=NEG), dim=-1).values.repeat_interleave(per, dim=-1)
    p = torch.exp(sc - mp[..., None])  # 2. the sequential kernel's p
    lp = p.sum(dim=-1)
    pr = p.to(v.dtype).float()
    pvp = torch.einsum("bgrnc,bgncd->bgrnd", pr, v.float().reshape(b, g, nc, c, d))
    w = torch.exp(mp - mp[..., -1:])  # 3. combine
    acc, l = pvp[..., 0, :] * w[..., 0, None], lp[..., 0] * w[..., 0]
    for i in range(1, nc):
        acc = acc + pvp[..., i, :] * w[..., i, None]
        l = l + lp[..., i] * w[..., i]
    out = (acc / l[..., None]).to(q.dtype).reshape(b, 1, hq, d)
    return (out, pr.reshape(b, g, rep, t)) if return_p else out


def decode_fp(q, k, v, mask, block_t=512):
    """Kernel B6 on the card (same arguments as `decode_fp_plain`)."""
    b, s, hq, d = q.shape
    g, t = k.shape[1], k.shape[2]
    rep = hq // g
    bt = block_size(t, block_t)
    dev = q.device
    dt = k.dtype
    if s != 1 or not b6_takes(hq, g, d, t, block_t, dt):
        raise ValueError(f"B6 takes one token, rep <= {MAX_DECODE_REP}, D % 8 == 0, D <= 256, "
                         f"T % block == 0 and a bfloat16 or float32 cache (b6_takes); got "
                         f"S={s}, rep={hq / g}, D={d}, T={t}, {dt}")
    for name, x, xdt, shape in (
        ("q", q, dt, (b, 1, hq, d)), ("k", k, dt, (b, g, t, d)), ("v", v, dt, (b, g, t, d)),
        ("mask", mask, torch.float32, (b, t)),
    ):
        if x.dtype != xdt or tuple(x.shape) != shape or not x.is_contiguous() or x.device != dev:
            raise ValueError(f"{name} must be contiguous {xdt} {shape} on {dev}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("B6 loads k and v rows as 16-byte vectors: 16-byte aligned buffers")
    c = fp_split_chunk(b * g, t, bt)
    nc = t // c
    rp = padded_rep(rep)
    qp = _pad_rep(q, g, rp)
    out = torch.empty((b, 1, g * rp, d), dtype=dt, device=dev)
    # scores, chunk maxima, m_prefix, l partials, PV partials (decode_fp.cu)
    scratch = torch.empty(b * g * rp * (t + 3 * nc + nc * d), dtype=torch.float32, device=dev)
    err = _lib_fp().l3q_decode_fp(
        qp.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), int(dt == torch.bfloat16), b, g, rp, t, d, bt, c,
        float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)), _build.stream_ptr(dev),
    )
    _build.check(err, "decode_fp (B6)")
    COUNTS[fp_launch_key(dt)] += 1
    return _unpad_rep(out, g, rep)


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
