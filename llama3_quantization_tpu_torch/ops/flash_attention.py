"""Causal full-sequence attention: kernel B7.

Replaces the Pallas TPU flash-attention kernel that
`llama3_quantization_tpu/models/transformer._flash_attention` calls when
S >= 128. The kernel is `csrc/flash_attention.cu` (bf16 operands, fp32
online softmax, grouped K/V read in place); `attention_plain` is its plain
PyTorch version: the JAX package's eager `_attention` under a causal mask,
which is what JAX itself runs off the TPU.

Differentiating through it replaces the library's `jax.custom_vjp`
(`flash_attention.py:204-318`), which on a TPU runs three more kernels:
the forward with `save_residuals=True` (B7.stats: B7's launch also writing
each row's max m and unnormalised sum l), then `_flash_attention_dkv_kernel`
(B7.dkv) and `_flash_attention_dq_kernel` (B7.dq), both in
`csrc/flash_attention_bwd.cu`: TMA rings and `wgmma` products, as B7's
forward. B7.dkv runs a block per (128 keys, K/V group, batch), two
warpgroups of 64 keys holding dK and dV in fp32 across the group's rep
heads while 64-row Q and dO tiles stream through a ring; B7.dq a block per
(128 q rows, head, batch), K and V tiles of 64 keys streaming past Q and
dO. `python3 chip_smoke.py --kernel-bench` times both (and B7.stats) at
OmniQuant's shape beside SDPA. `FlashAttentionFn` is that gradient:
`flash_attention` takes it only when grad is enabled and an input requires
grad, so inference, eval and serving keep B7's launch as it was.
`attention_stats_plain` and `flash_attention_bwd_plain` are the plain
versions, with the library's rounding points (p and ds rounded to the
operands' dtype before their products, masked logits at its
DEFAULT_MASK_VALUE); di = sum(o * do) is a torch reduction, as the library
computes it outside its kernels (`:273-275`). The library rounds each
repeated head's dk/dv to the input dtype before `jnp.repeat`'s transpose
sums them; the port sums a group's rep heads in fp32 and rounds once.

The wrappers use the plain versions for CPU tensors; for CUDA tensors they
launch the kernel or raise. `b7_takes` is the range of shapes they take,
which their raises and the gate in `models/transformer.py` both read.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .launches import COUNTS

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_l3q_typed", False):
        lib.l3q_flash_attn_fwd.argtypes = [_P] * 6 + [_I] * 6 + [ctypes.c_float, _P]
        lib.l3q_flash_attn_fwd.restype = _I
        lib._l3q_typed = True
    return lib


def _lib_bwd():
    lib = _build.load("flash_attention_bwd")
    if not getattr(lib, "_l3q_typed", False):
        lib.l3q_flash_attn_bwd_dkv.argtypes = [_P] * 9 + [_I] * 5 + [ctypes.c_float, _P]
        lib.l3q_flash_attn_bwd_dkv.restype = _I
        lib.l3q_flash_attn_bwd_dq.argtypes = [_P] * 8 + [_I] * 5 + [ctypes.c_float, _P]
        lib.l3q_flash_attn_bwd_dq.restype = _I
        lib._l3q_typed = True
    return lib


#: the library's DEFAULT_MASK_VALUE (`flash_attention.py:29`)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def causal_mask(s: int, t: Optional[int] = None, offset: int = 0, device="cpu") -> torch.Tensor:
    """Additive causal mask [s, t]; query i attends key j iff j <= i + offset."""
    t = t or s
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(t, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(kj <= qi, zero, torch.full_like(zero, -math.inf))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B, S, H, D], k/v [B, S, G, D] -> causal attention [B, S, H, D]:
    fp32 scores and softmax, probabilities cast to q's dtype before PV."""
    b, s, h, d = q.shape
    g = k.shape[2]
    qg = q.reshape(b, s, g, h // g, d)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(), k.float())
    scores = scores / math.sqrt(d) + causal_mask(s, device=q.device)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", probs.float(), v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


#: blocks a launch wants before 128-row q tiles pay (one per H100 SM)
FULL_GRID = 132


def q_tile(b: int, s: int, h: int) -> int:
    """Query rows per block of B7: 128, or 64 where 128-row tiles would
    leave SMs idle (S = 128 at batch 1 gives 32 blocks of 128 rows)."""
    return 128 if -(-s // 128) * h * b >= FULL_GRID else 64


def b7_takes(h: int, g: int, d: int) -> bool:
    """Does B7 take H query heads over G K/V heads of head dim D? D of 64
    or 128 (its wgmma tiles) and H a multiple of G."""
    return d in (64, 128) and g > 0 and h % g == 0


def _check_b7(q, k, v, *more):
    b, s, h, d = q.shape
    g = k.shape[2]
    if not b7_takes(h, g, d) or k.shape != (b, s, g, d) or v.shape != k.shape:
        raise ValueError(f"B7 takes D in (64, 128) and grouped K/V (b7_takes); "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    devs = {x.device for x in (q, k, v, *more)}
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"B7 runs on one CUDA device; got {sorted(map(str, devs))}")
    return b, s, h, g, d


def _scale(d: int) -> float:
    """The fp32 constant 1 / sqrt(D) the kernels multiply by."""
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))


def _fwd_cuda(q, k, v, stats: bool):
    b, s, h, g, d = _check_b7(q, k, v)
    qb, kb, vb = (x.to(torch.bfloat16).contiguous() for x in (q, k, v))
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device)
    m = l = None
    if stats:
        m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    err = _lib().l3q_flash_attn_fwd(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(),
        None if m is None else m.data_ptr(), None if l is None else l.data_ptr(), b, s, h, g, d,
        q_tile(b, s, h), _scale(d), _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attn_fwd (B7" + (".stats)" if stats else ")"))
    COUNTS["B7.stats" if stats else "B7"] += 1
    return out.to(q.dtype), m, l


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel B7 on the card. Operands are rounded to bf16 (the activation
    dtype of the main path); the output is in q's dtype."""
    return _fwd_cuda(q, k, v, stats=False)[0]


def flash_attention_stats_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """B7.stats on the card: B7's output, and each row's max m of the
    scaled logits and sum l of exp(s - m), fp32 [B, H, S]."""
    return _fwd_cuda(q, k, v, stats=True)


def attention_stats_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """B7.stats' function: `attention_plain`'s output, and the max m of
    each row's scaled logits and the sum l of exp(s - m) over its visible
    keys, fp32 [B, H, S] (the residuals `l`, `m` of the library's forward
    with `save_residuals=True`)."""
    b, s, h, d = q.shape
    g = k.shape[2]
    qg = q.reshape(b, s, g, h // g, d)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(), k.float())
    scores = scores / math.sqrt(d) + causal_mask(s, device=q.device)
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    l = e.sum(dim=-1)
    probs = (e / l[..., None]).to(q.dtype)
    out = torch.einsum("bgrst,btgd->bsgrd", probs.float(), v.float())
    return (out.reshape(b, s, h, d).to(q.dtype), m.reshape(b, h, s), l.reshape(b, h, s))


def flash_attention_bwd_plain(q, k, v, o, do, m, l):
    """The backward kernels' function (B7.dkv and B7.dq): q/o/do
    [B, S, H, D], k/v [B, S, G, D], m/l fp32 [B, H, S] -> (dq, dk, dv) in
    the inputs' dtypes. p = exp(s * scale + mask - m) * (1 / l) with masked
    logits at MASK_VALUE; dv = p^T do and dk = ds^T q with p and ds rounded
    to do's dtype, dq = ds k with ds rounded to k's dtype, every product in
    fp32; a group's rep heads summed in fp32 (`:796-1290`)."""
    b, s, h, d = q.shape
    g = k.shape[2]
    rep = h // g
    scale = _scale(d)
    qf = q.reshape(b, s, g, rep, d).float()
    dof = do.reshape(b, s, g, rep, d).float()
    di = (o.float() * do.float()).sum(dim=-1).reshape(b, s, g, rep).permute(0, 2, 3, 1)
    mg, lg = m.reshape(b, g, rep, s), l.reshape(b, g, rep, s)
    qi = torch.arange(s, device=q.device)
    masked = qi[None, :] > qi[:, None]  # [S, T]: key past the row
    logits = torch.einsum("bsgrd,btgd->bgrst", qf, k.float()) * scale
    logits = logits + torch.where(masked, MASK_VALUE, 0.0)
    p = torch.exp(logits - mg[..., None]) * (1.0 / lg)[..., None]
    dp = torch.einsum("bsgrd,btgd->bgrst", dof, v.float())
    ds = (dp - di[..., None]) * p * scale
    p_r, ds_r = p.to(do.dtype).float(), ds.to(do.dtype).float()
    dv = torch.einsum("bgrst,bsgrd->btgd", p_r, dof)
    dk = torch.einsum("bgrst,bsgrd->btgd", ds_r, qf)
    dq = torch.einsum("bgrst,btgd->bsgrd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def backward_terms(q, k, v, o, do, m, l):
    """The largest single term of each gradient row before cancellation,
    the scale that a check of B7.dkv and B7.dq against
    `flash_attention_bwd_plain` holds a row to where its terms cancel (not
    on any path): with |ds|' = (|dp| + |di|) * p * scale, the size of ds
    before dp - di cancels, dq [B, S, H] max_j |ds_ij|' * max|k|; dk and
    dv [B, S, G] max over the group's rows i of |ds_ij|' * max|q| and of
    p_ij * max|do|. Both versions sum dp and di in other fp32 orders and
    round p and ds to bf16, so ds can differ by an ulp of |dp| + |di| and
    land on the other side of a rounding tie; a dq row's ds sum to 0, and
    row 0's ds is exactly 0 up to that rounding, so a row can be far
    smaller than its terms."""
    b, s, h, d = q.shape
    g = k.shape[2]
    rep = h // g
    qf, dof = (x.reshape(b, s, g, rep, d).float() for x in (q, do))
    di = (o.float() * do.float()).sum(dim=-1).reshape(b, s, g, rep).permute(0, 2, 3, 1)
    lg = torch.einsum("bsgrd,btgd->bgrst", qf, k.float()) * _scale(d)
    lg = lg + causal_mask(s, device=q.device)
    p = torch.exp(lg - m.reshape(b, g, rep, s)[..., None]) / l.reshape(b, g, rep, s)[..., None]
    del lg
    dp = torch.einsum("bsgrd,btgd->bgrst", dof, v.float()).abs()
    ds = (dp + di.abs()[..., None]) * p * _scale(d)
    del dp
    fq = ds.amax(dim=-1).permute(0, 3, 1, 2).reshape(b, s, h) * float(k.float().abs().max())
    fk = ds.amax(dim=(2, 3)).transpose(1, 2) * float(q.float().abs().max())
    del ds
    fv = p.amax(dim=(2, 3)).transpose(1, 2) * float(do.float().abs().max())
    return fq, fk, fv


def flash_attention_bwd_cuda(q, k, v, o, do, m, l):
    """B7.dkv and B7.dq on the card (same arguments and results as
    `flash_attention_bwd_plain`). Operands are rounded to bf16; di =
    sum(o * do) in fp32 is a torch reduction, as in the library."""
    b, s, h, g, d = _check_b7(q, k, v, o, do, m, l)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}; got {tuple(x.shape)}")
    for name, x in (("m", m), ("l", l)):
        if x.dtype != torch.float32 or tuple(x.shape) != (b, h, s):
            raise ValueError(f"{name} must be float32 {(b, h, s)}; got {x.dtype} {tuple(x.shape)}")
    qb, kb, vb, dob = (x.to(torch.bfloat16).contiguous() for x in (q, k, v, do))
    di = (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()  # [B, H, S]
    mc, lc = m.contiguous(), l.contiguous()
    dq = torch.empty_like(qb)
    dk, dv = torch.empty_like(kb), torch.empty_like(vb)
    lib, st, scale = _lib_bwd(), _build.stream_ptr(q.device), _scale(d)
    ins = (qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), dob.data_ptr(), mc.data_ptr(),
           lc.data_ptr(), di.data_ptr())
    err = lib.l3q_flash_attn_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), b, s, h, g, d, scale, st)
    _build.check(err, "flash_attn_bwd_dkv (B7.dkv)")
    COUNTS["B7.dkv"] += 1
    err = lib.l3q_flash_attn_bwd_dq(*ins, dq.data_ptr(), b, s, h, g, d, scale, st)
    _build.check(err, "flash_attn_bwd_dq (B7.dq)")
    COUNTS["B7.dq"] += 1
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _on(x: torch.Tensor, cpu, cuda):
    if x.device.type == "cpu":
        return cpu
    if x.device.type == "cuda":
        return cuda
    raise ValueError(f"unsupported device {x.device}")


class FlashAttentionFn(torch.autograd.Function):
    """Causal attention with B7's gradient (the library's `jax.custom_vjp`,
    `flash_attention.py:204-318`): the forward runs B7.stats and keeps q,
    k, v, o, m and l; the backward runs B7.dkv and B7.dq. Plain versions on
    CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, m, l = _on(q, attention_stats_plain, flash_attention_stats_cuda)(q, k, v)
        ctx.save_for_backward(q, k, v, o, m, l)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        return _on(q, flash_attention_bwd_plain, flash_attention_bwd_cuda)(q, k, v, o, do, m, l)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention over the full sequence: plain on the CPU, B7 on
    CUDA; under autograd (grad enabled and an input requiring grad)
    through `FlashAttentionFn`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v)
    return _on(q, attention_plain, flash_attention_cuda)(q, k, v)
