"""Quantized KV cache (port of `llama3_quantization_tpu/ops/kvcache.py`).

The cache is a preallocated heads-major buffer stacked over layers. int8:
`[L, B, Hkv, T, D]` codes. int4: `[L, B, Hkv, T/2, D]` uint8, two
T-adjacent tokens per byte (`kv4_pack`: byte row r holds token 2r in the low
nibble and token 2r+1 in the high nibble). Both keep fp32 per-(token, head)
scales `[L, B, Hkv, T, 1]`. K/V are quantized once when written: symmetric,
`scale = max(absmax / 127, 1e-8)` (int8) or `max(absmax / 7, 1e-8)`
(int4), codes rounded half to even. Writes update the buffers IN PLACE;
int4 writes read-modify-write the shared byte rows.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

CACHE_KEYS = ("k_q", "k_s", "v_q", "v_s")

Pos = Union[int, torch.Tensor]

_DIVISORS: Dict[tuple, torch.Tensor] = {}


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """`x / c` rounded as one IEEE division on every device, as JAX and the
    kernels round it. PyTorch's CUDA kernel multiplies by the reciprocal of
    a Python-scalar divisor, which is off by one ulp for some x and moves
    codes that sit on a rounding tie; a 0-dim device tensor divides."""
    key = (x.device, x.dtype, c)
    d = _DIVISORS.get(key)
    if d is None:
        d = _DIVISORS[key] = torch.full((), c, dtype=x.dtype, device=x.device)
    return x / d


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (codes int8 [..., D], scale f32 [..., 1]), symmetric."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = true_div(absmax, 127.0).clamp(min=1e-8)
    codes = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return codes, scale


def kv_dequantize(codes: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (codes.float() * scale).to(dtype)


def kv4_codes(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (signed codes int8 in [-7, 7], scale f32 [..., 1])."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = true_div(absmax, 7.0).clamp(min=1e-8)
    codes = torch.round(xf / scale).clamp(-7, 7).to(torch.int8)
    return codes, scale


def kv4_pack(codes: torch.Tensor) -> torch.Tensor:
    """Signed codes [..., T, D] (T even) -> packed uint8 [..., T/2, D]:
    byte row r = (c[2r] & 15) | (c[2r+1] << 4), along the token axis."""
    lo = codes[..., 0::2, :].view(torch.uint8) & 0xF
    hi = (codes[..., 1::2, :].view(torch.uint8) & 0xF) << 4
    return lo | hi


def kv4_unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """Packed uint8 [..., T/2, D] -> signed int8 codes [..., T, D]."""
    lo = ((packed & 0xF) ^ 8).to(torch.int8) - 8
    hi = ((packed >> 4) ^ 8).to(torch.int8) - 8
    inter = torch.stack([lo, hi], dim=-2)  # [..., T/2, 2, D]
    return inter.reshape(*packed.shape[:-2], packed.shape[-2] * 2, packed.shape[-1])


def kv4_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., T, D] (T even) -> (packed uint8 [..., T/2, D], scale [..., T, 1])."""
    codes, scale = kv4_codes(x)
    return kv4_pack(codes), scale


def kv4_dequantize(packed: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Packed [..., T/2, D] + scale [..., T, 1] -> [..., T, D]."""
    return (kv4_unpack_codes(packed).float() * scale).to(dtype)


def init_quantized_kv_cache(
    cfg, batch: int, max_len: int, device, bits: int = 8
) -> Dict[str, torch.Tensor]:
    """Zeroed codes and unit scales, `[L, B, Hkv, T(/2), *]`."""
    if bits == 4:
        if max_len % 2:
            raise ValueError("int4 KV cache needs an even max_len")
        rows, dtype = max_len // 2, torch.uint8
    elif bits == 8:
        rows, dtype = max_len, torch.int8
    else:
        raise ValueError("KV cache bits must be 4 or 8")
    lead = (cfg.num_layers, batch, cfg.num_kv_heads)
    shape = lead + (rows, cfg.head_dim_)
    sshape = lead + (max_len, 1)
    return {
        "k_q": torch.zeros(shape, dtype=dtype, device=device),
        "k_s": torch.ones(sshape, dtype=torch.float32, device=device),
        "v_q": torch.zeros(shape, dtype=dtype, device=device),
        "v_s": torch.ones(sshape, dtype=torch.float32, device=device),
    }


def _nibble_merge(old: torch.Tensor, codes: torch.Tensor, par: Pos) -> torch.Tensor:
    """Write int4 `codes` into the low (par 0) or high (par 1) nibble of
    the bytes `old`, keeping the other nibble."""
    cu = codes.view(torch.uint8) & 0xF
    lo, hi = (old & 0xF0) | cu, (old & 0x0F) | (cu << 4)
    if isinstance(par, int):
        return lo if par == 0 else hi
    return torch.where(par == 0, lo, hi)


def _kv4_write(buf: torch.Tensor, codes: torch.Tensor, pos: int) -> None:
    """Write signed int4 codes [B, H, S, D] into the T-packed buffer
    [B, H, T/2, D] at token position `pos`, in place (`kvcache.py:108-141`):
    one nibble per byte for a single token, else unpack the covering byte
    rows, splice at any parity, and repack."""
    s = codes.shape[2]
    tp = buf.shape[2]
    if s == 1:
        row = buf[:, :, pos // 2 : pos // 2 + 1]
        row.copy_(_nibble_merge(row, codes, pos % 2))
        return
    r = min(s // 2 + 1, tp)
    r0 = min(max(pos // 2, 0), tp - r)
    rows = buf[:, :, r0 : r0 + r]
    unpacked = kv4_unpack_codes(rows)
    off = min(max(pos - 2 * r0, 0), 2 * r - s)  # dynamic_update_slice clamps
    unpacked[:, :, off : off + s] = codes
    rows.copy_(kv4_pack(unpacked))


def cache_update(layer_cache, k_new: torch.Tensor, v_new: torch.Tensor, pos: Pos):
    """Quantize K/V `[B, S, H, D]` and write them IN PLACE into one layer's
    cache `(k_q, k_s, v_q, v_s)`, `[B, H, T(/2), *]`, at `pos`: an int (S
    tokens from there) or a per-row vector `[B]` (S == 1, each row at its
    own slot). int4 caches (uint8 codes) are told apart by dtype."""
    kq, ks, vq, vs = layer_cache
    int4 = kq.dtype == torch.uint8
    quantize = kv4_codes if int4 else kv_quantize
    for buf, sbuf, new in ((kq, ks, k_new), (vq, vs, v_new)):
        codes, scale = quantize(new.transpose(1, 2))  # [B, H, S, *]
        if torch.is_tensor(pos) and pos.dim() == 1:
            rows = torch.arange(buf.shape[0], device=buf.device)
            if int4:
                old = buf[rows, :, pos // 2, :]  # [B, H, D]
                par = (pos % 2)[:, None, None]
                buf[rows, :, pos // 2, :] = _nibble_merge(old, codes[:, :, 0], par)
            else:
                buf[rows, :, pos, :] = codes[:, :, 0]
            sbuf[rows, :, pos, :] = scale[:, :, 0]
            continue
        s = codes.shape[2]
        if int4:
            _kv4_write(buf, codes, pos)
        else:
            buf[:, :, pos : pos + s] = codes
        sbuf[:, :, pos : pos + s] = scale
    return layer_cache


def layer_view(cache: Dict[str, torch.Tensor], layer: int) -> Tuple[torch.Tensor, ...]:
    """(k_q, k_s, v_q, v_s) of one layer, `[B, H, T(/2), *]` views (no copy)."""
    return tuple(cache[k][layer] for k in CACHE_KEYS)


def cache_update_stacked(
    cache: Dict[str, torch.Tensor], layer: int, k_new: torch.Tensor, v_new: torch.Tensor, pos: Pos
) -> Dict[str, torch.Tensor]:
    """`cache_update` on layer `layer` of the stacked cache, through its
    views. Returns the same dict."""
    cache_update(layer_view(cache, layer), k_new, v_new, pos)
    return cache


def cache_read(layer_cache, dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantized full K/V, heads-major `[B, H, T, D]`."""
    kq, ks, vq, vs = layer_cache
    deq = kv4_dequantize if kq.dtype == torch.uint8 else kv_dequantize
    return deq(kq, ks, dtype), deq(vq, vs, dtype)
