"""Causal full-sequence attention: kernel B7.

Replaces the Pallas TPU flash-attention kernel that
`llama3_quantization_tpu/models/transformer._flash_attention` calls when
S >= 128. The kernel is `csrc/flash_attention.cu` (bf16 operands, fp32
online softmax, grouped K/V read in place); `attention_plain` is its plain
PyTorch version: the JAX package's eager `_attention` under a causal mask,
which is what JAX itself runs off the TPU.

The wrapper uses the plain version for CPU tensors; for CUDA tensors it
launches the kernel or raises. `b7_takes` is the range of shapes it takes,
which its raise and the gate in `models/transformer.py` both read.
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
        lib.l3q_flash_attn_fwd.argtypes = [_P] * 4 + [_I] * 6 + [ctypes.c_float, _P]
        lib.l3q_flash_attn_fwd.restype = _I
        lib._l3q_typed = True
    return lib


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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel B7 on the card. Operands are rounded to bf16 (the activation
    dtype of the main path); the output is in q's dtype."""
    b, s, h, d = q.shape
    g = k.shape[2]
    if not b7_takes(h, g, d) or k.shape != (b, s, g, d) or v.shape != k.shape:
        raise ValueError(f"B7 takes D in (64, 128) and grouped K/V (b7_takes); "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (k.device == v.device == q.device) or q.device.type != "cuda":
        raise ValueError(f"B7 runs on one CUDA device; got {q.device}, {k.device}, {v.device}")
    qb, kb, vb = (x.to(torch.bfloat16).contiguous() for x in (q, k, v))
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device)
    scale = float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))
    err = _lib().l3q_flash_attn_fwd(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(), b, s, h, g, d,
        q_tile(b, s, h), scale, _build.stream_ptr(q.device),
    )
    _build.check(err, "flash_attn_fwd (B7)")
    COUNTS["B7"] += 1
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention over the full sequence: plain on the CPU, B7 on CUDA."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v)
    raise ValueError(f"unsupported device {q.device}")
