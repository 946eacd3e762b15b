"""Causal full-sequence attention: kernel B7.

Replaces the Pallas TPU flash-attention kernel that
`llama3_quantization_tpu/models/transformer._flash_attention` calls when
S >= 128. The kernel is `csrc/flash_attention.cu` (bf16 operands, fp32
online softmax, grouped K/V read in place); `attention_plain` is its plain
PyTorch version: the JAX package's eager `_attention` under a causal mask,
which is what JAX itself runs off the TPU.

The wrapper uses the plain version for CPU tensors; for CUDA tensors it
launches the kernel or raises.
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
        lib.l3q_flash_attn_fwd.argtypes = [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P]
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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel B7 on the card. Operands are rounded to bf16 (the activation
    dtype of the main path); the output is in q's dtype."""
    b, s, h, d = q.shape
    g = k.shape[2]
    if d not in (64, 128) or h % g or k.shape != (b, s, g, d) or v.shape != k.shape:
        raise ValueError(f"B7 takes D in (64, 128) and grouped K/V; got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    qb, kb, vb = (x.to(torch.bfloat16).contiguous() for x in (q, k, v))
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device)
    scale = float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))
    err = _lib().l3q_flash_attn_fwd(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), out.data_ptr(), b, s, h, g, d, scale,
        _build.stream_ptr(q.device),
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
