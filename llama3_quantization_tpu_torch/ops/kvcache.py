"""int8 KV cache (int8 parts of `llama3_quantization_tpu/ops/kvcache.py`).

The cache is a preallocated heads-major buffer stacked over layers,
`[L, B, Hkv, T, D]` int8 codes with fp32 per-(token, head) scales
`[L, B, Hkv, T, 1]`. K/V are quantized once when written: symmetric,
`scale = max(absmax / 127, 1e-8)`, codes rounded half to even. Writes
update the buffers IN PLACE. The int4 T-pair pack is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

CACHE_KEYS = ("k_q", "k_s", "v_q", "v_s")


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (codes int8 [..., D], scale f32 [..., 1]), symmetric."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = (absmax / 127.0).clamp(min=1e-8)
    codes = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return codes, scale


def kv_dequantize(codes: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (codes.float() * scale).to(dtype)


def init_quantized_kv_cache(cfg, batch: int, max_len: int, device) -> Dict[str, torch.Tensor]:
    """Zeroed int8 codes and unit scales, `[L, B, Hkv, max_len, *]`."""
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim_)
    sshape = shape[:-1] + (1,)
    return {
        "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_s": torch.ones(sshape, dtype=torch.float32, device=device),
        "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
        "v_s": torch.ones(sshape, dtype=torch.float32, device=device),
    }


def cache_update_stacked(
    cache: Dict[str, torch.Tensor], layer: int, k_new: torch.Tensor, v_new: torch.Tensor, pos: int
) -> Dict[str, torch.Tensor]:
    """Quantize K/V `[B, S, H, D]` and write them IN PLACE into the stacked
    cache at (layer, pos .. pos + S). Returns the same dict."""
    s = k_new.shape[1]
    for name, new in (("k", k_new), ("v", v_new)):
        codes, scale = kv_quantize(new.transpose(1, 2))  # [B, H, S, *]
        cache[f"{name}_q"][layer, :, :, pos : pos + s] = codes
        cache[f"{name}_s"][layer, :, :, pos : pos + s] = scale
    return cache


def layer_view(cache: Dict[str, torch.Tensor], layer: int) -> Tuple[torch.Tensor, ...]:
    """(k_q, k_s, v_q, v_s) of one layer, `[B, H, T, *]` views (no copy)."""
    return tuple(cache[k][layer] for k in CACHE_KEYS)


def cache_read(layer_cache, dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantized full K/V views, heads-major `[B, H, T, D]`."""
    kq, ks, vq, vs = layer_cache
    return kv_dequantize(kq, ks, dtype), kv_dequantize(vq, vs, dtype)
