"""Window write-combined decode (port of `llama3_quantization_tpu/models/windowed.py`).

K decode steps in one call, with the main cache read in place and never
written during the window: each step writes its K/V only into small
per-window buffers `[L, B, H, KW, *]` indexed by the step, and attention is
the online-softmax merge (`_merge_attn`) of

- kernel B5 with `return_stats=True` over the main cache, whose mask is
  frozen at `pos0 - 1` (`windowed.py:480-488`): slots from `pos0` on hold
  stale data until the merge, and the window segment supplies every newer
  token;
- exact fp32 attention over the window segment (`_window_attn`), plain
  PyTorch as in JAX, which computes it outside any Pallas kernel.

After the window, `merge_window_into_cache` writes each window token to
its sink+ring slot (`p` if `p < sink`, else `sink + (p - sink) mod
(T - sink)`); int4 nibbles compose in the shared byte rows. It gives the
same bytes as the TPU's bounded-scratch piece merge and its whole-cache
gather merge (`windowed.py:263-439`), which are two forms of that mapping.

Scope as in JAX: quantized stacked caches (int8 / int4), single-token
steps, sink tokens, no enabled q/k/v/p hook (the `act` hook runs in the
window's linears). Callers fall back to per-step decode otherwise
(`windowed_ok`: an fp cache never takes it) and when a window would evict
(see `greedy_generate` and `ServingEngine._dispatch_window`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from ..ops.decode_attention import NEG, block_size, flash_decode_gqa_s8_stacked
from ..ops.kvcache import CACHE_KEYS, kv4_codes, kv_quantize, true_div
from ..ops.matmul import prepare_decode_params, qlinear
from .configs import ModelConfig
from .transformer import (
    NO_QUANT,
    RuntimeQuantConfig,
    _check_arch,
    _decode_kernel_ok,
    _kernel_mask,
    _layer_params,
    _mlp_block,
    _ring_write_and_mask,
    apply_rope,
    decode_block_t,
    embed,
    final_norm,
    lm_head,
    qkv_proj,
    rms_norm,
    rope_cos_sin,
    sample_logits,
)

#: window write-combining switch (True = whenever applicable; False =
#: always the per-step decode paths)
_WINDOWED = True


def set_windowed_decode(on: bool) -> None:
    global _WINDOWED
    if not isinstance(on, bool):
        raise TypeError(f"set_windowed_decode takes a bool, got {on!r}")
    _WINDOWED = on


def windowed_ok(
    cfg: ModelConfig, cache: Dict[str, torch.Tensor], rq: RuntimeQuantConfig = NO_QUANT,
    sink_tokens: int = 0,
) -> bool:
    """Is the window write-combined decode applicable? (`windowed.py:85-123`
    as it runs with the decode kernel: a llama stack over a quantized
    cache whose length the kernel's T blocks tile, no enabled q/k/v/p
    hook.) The ring-crossing gate lives in the callers, as in JAX."""
    if not _WINDOWED or cfg.arch != "llama" or cfg.is_moe or cfg.parallel_block:
        return False
    if sorted(cache) != sorted(CACHE_KEYS) or not _decode_kernel_ok(rq):
        return False
    t = cache["k_s"].shape[3]
    return t % block_size(t, decode_block_t(t)) == 0


def _merge_attn(o1, m1, l1, o2, m2, l2):
    """Online-softmax merge of two normalized attention segments.

    o*: [B, G, rep, D] f32; m*/l*: [B, G, rep] f32. A segment whose m is
    far below the other's (an all-masked main cache: m = -1e30) drops out
    through exp(m - m*)."""
    m_star = torch.maximum(m1, m2)
    w1 = l1 * torch.exp(m1 - m_star)
    w2 = l2 * torch.exp(m2 - m_star)
    denom = (w1 + w2).clamp(min=1e-30)
    return (o1 * w1[..., None] + o2 * w2[..., None]) / denom[..., None]


def _window_attn(q, wk, wks, wv, wvs, wmask):
    """Exact attention over the window segment.

    q [B, G, rep, D] f32; wk/wv [B, H, KW, D] int8 codes; wks/wvs
    [B, H, KW, 1] f32; wmask [1, 1, 1, KW] additive. Returns normalized
    (o, m, l) for `_merge_attn`."""
    d = q.shape[-1]
    kf = wk.float() * wks
    s = true_div(torch.einsum("bgrd,bgjd->bgrj", q, kf), math.sqrt(d)) + wmask
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    vf = wv.float() * wvs
    o = torch.einsum("bgrj,bgjd->bgrd", p, vf) / l.clamp(min=1e-30)[..., None]
    return o, m, l


def _attn_block_windowed(p, x, cfg, rq, cos_sin, main_mask, cache, w_bufs, widx, layer, block_t):
    """Attention = B5 (main cache, read in place) merged with exact
    attention over the window. Writes this step's K/V codes into slot
    `widx` of the layer's window buffers."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q, k, v = qkv_proj(p, x, cfg, rq.act)  # fused qkv as `windowed.py:172-177`
    cos, sin = cos_sin
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    quantize = kv4_codes if cache["k_q"].dtype == torch.uint8 else kv_quantize
    wk, wks, wv, wvs = (buf[layer] for buf in w_bufs)  # [B, H, KW, *] views
    for codes_buf, scale_buf, new in ((wk, wks, k), (wv, wvs, v)):
        codes, scale = quantize(new.transpose(1, 2))  # [B, H, 1, *]
        codes_buf[:, :, widx : widx + 1] = codes
        scale_buf[:, :, widx : widx + 1] = scale

    g = cfg.num_kv_heads
    rep = cfg.num_heads // g
    o1, m1, l1 = flash_decode_gqa_s8_stacked(
        q, *(cache[key] for key in CACHE_KEYS), main_mask, layer,
        out_dtype=torch.float32, block_t=block_t, return_stats=True,
    )
    o1 = o1.reshape(b, g, rep, hd)
    kw = wk.shape[2]
    wmask = torch.where(torch.arange(kw, device=x.device) <= widx, 0.0, -math.inf)
    o2, m2, l2 = _window_attn(q.reshape(b, g, rep, hd).float(), wk, wks, wv, wvs,
                              wmask.float()[None, None, None, :])
    attn = _merge_attn(o1, m1, l1, o2, m2, l2).reshape(b, s, cfg.num_heads * hd).to(x.dtype)
    return qlinear(attn, p["o"]["w"], p["o"].get("b"), rq.act)


def _decode_step_windowed(params, cache, w_bufs, tokens, pos, widx, main_mask, cfg, rq, block_t):
    """One windowed decode step at per-row positions `pos` [B]: h through
    the layer stack; the main cache is only read."""
    h = embed(params, tokens)
    cos_sin = rope_cos_sin(pos[:, None], cfg.head_dim_, cfg.rope_theta, h.dtype, cfg.rope_scaling_)
    for i in range(cfg.num_layers):
        lp = _layer_params(params["layers"], i)
        x = rms_norm(h, lp["ln1"]["w"], cfg.rms_norm_eps, lp["ln1"].get("b"))
        h = h + _attn_block_windowed(lp, x, cfg, rq, cos_sin, main_mask, cache, w_bufs, widx, i,
                                     block_t)
        mlp_in = rms_norm(h, lp["ln2"]["w"], cfg.rms_norm_eps, lp["ln2"].get("b"))
        h = h + _mlp_block(lp, mlp_in, rq)
    return lm_head(params, final_norm(params, h, cfg), cfg)


def _positions(pos0: Union[int, torch.Tensor], b: int, device) -> torch.Tensor:
    """Absolute positions [B] (int64) on `device` from an int or a [B] tensor."""
    if torch.is_tensor(pos0):
        return pos0.to(device=device, dtype=torch.long).expand(b)
    return torch.full((b,), int(pos0), dtype=torch.long, device=device)


def _ring_slots(pos0: torch.Tensor, kw: int, t: int, sink: int) -> torch.Tensor:
    """Sink+ring slot [B, KW] of each window token."""
    p = pos0[:, None] + torch.arange(kw, device=pos0.device)
    return torch.where(p < sink, p, sink + torch.remainder(p - sink, t - sink))


def _scatter_tokens(buf: torch.Tensor, win: torch.Tensor, slots: torch.Tensor) -> None:
    """buf [L, B, H, T, X] <- win [L, B, H, KW, X] at token slots [B, KW]."""
    rows = torch.arange(buf.shape[1], device=buf.device)[:, None]
    buf[:, rows, :, slots] = win.permute(1, 3, 0, 2, 4)


def _scatter_nibbles(buf: torch.Tensor, win: torch.Tensor, slots: torch.Tensor) -> None:
    """Packed int4 buf [L, B, H, T/2, D] <- signed codes win [L, B, H, KW, D]
    at token slots [B, KW]. Each written byte row gets both of its nibbles
    at once: the window token's own, and its partner slot's (the adjacent
    window token when that token lands in the same byte row, else the old
    nibble). Two window tokens that share a row thus write the same byte."""
    row, par = slots // 2, (slots % 2)[:, :, None, None, None]
    rows = torch.arange(buf.shape[1], device=buf.device)[:, None]
    old = buf[:, rows, :, row]  # [B, KW, L, H, D]
    code = win.permute(1, 3, 0, 2, 4).view(torch.uint8) & 0xF
    same_prev = torch.zeros_like(slots, dtype=torch.bool)
    same_prev[:, 1:] = slots[:, :-1] == slots[:, 1:] - 1
    same_next = torch.zeros_like(same_prev)
    same_next[:, :-1] = slots[:, 1:] == slots[:, :-1] + 1
    prev_code = torch.cat([code[:, :1], code[:, :-1]], dim=1)
    next_code = torch.cat([code[:, 1:], code[:, -1:]], dim=1)
    lo = torch.where(par == 0, code,
                     torch.where(same_prev[:, :, None, None, None], prev_code, old & 0xF))
    hi = torch.where(par == 1, code,
                     torch.where(same_next[:, :, None, None, None], next_code, old >> 4))
    buf[:, rows, :, row] = lo | (hi << 4)


def merge_window_into_cache(
    cache: Dict[str, torch.Tensor], w_bufs, pos0, cfg: ModelConfig, sink: int = 0
) -> Dict[str, torch.Tensor]:
    """Write the window buffers into the ring cache IN PLACE, once per KW
    tokens. `pos0` (int or [B]) is the absolute position of the window's
    first token. Needs KW < T - sink (distinct slots)."""
    wk, wks, wv, wvs = w_bufs
    t = cache["k_s"].shape[3]
    kw = wk.shape[3]
    if kw >= t - sink:
        raise ValueError(f"a window of {kw} tokens does not fit the ring width {t - sink}")
    slots = _ring_slots(_positions(pos0, cache["k_s"].shape[1], cache["k_s"].device), kw, t, sink)
    codes = _scatter_nibbles if cache["k_q"].dtype == torch.uint8 else _scatter_tokens
    codes(cache["k_q"], wk, slots)
    codes(cache["v_q"], wv, slots)
    _scatter_tokens(cache["k_s"], wks, slots)
    _scatter_tokens(cache["v_s"], wvs, slots)
    return cache


def decode_window(
    params,
    cache: Dict[str, torch.Tensor],
    tok0: torch.Tensor,  # [B, 1]
    pos0,  # int or [B]: position of tok0
    n_steps: int,
    cfg: ModelConfig,
    rq: RuntimeQuantConfig = NO_QUANT,
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    sink_tokens: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """`n_steps` greedy (or sampled, from `generator`) tokens with
    write-combined cache updates, on the cache's device. Returns (tokens
    [B, n_steps], the cache, merged in place). Under the "s4" backend the
    weights are prepared once per window (`windowed.py:458`); already
    prepared params pass through unchanged."""
    _check_arch(cfg)
    params = prepare_decode_params(params)
    dev = cache["k_s"].device
    if tok0.device != dev:
        raise ValueError(f"tokens on {tok0.device}, cache on {dev}")
    b = tok0.shape[0]
    L, g, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim_
    kw = n_steps
    t = cache["k_s"].shape[3]
    if kw >= t - sink_tokens:
        # a window spanning the whole ring width would alias slots in the
        # merge; callers chunk n_steps below the ring width instead
        raise ValueError(f"decode_window n_steps={n_steps} must be < ring width {t - sink_tokens}")
    block_t = decode_block_t(t)
    posv = _positions(pos0, b, dev)
    _, mask0 = _ring_write_and_mask(posv - 1, 1, t, sink_tokens, dev)
    main_mask = _kernel_mask(mask0, b, t)
    # pos0 == 0: nothing in the main cache is visible
    main_mask = torch.where(posv[:, None] >= 1, main_mask, NEG)
    w_bufs = (
        torch.zeros((L, b, g, kw, hd), dtype=torch.int8, device=dev),
        torch.ones((L, b, g, kw, 1), dtype=torch.float32, device=dev),
        torch.zeros((L, b, g, kw, hd), dtype=torch.int8, device=dev),
        torch.ones((L, b, g, kw, 1), dtype=torch.float32, device=dev),
    )
    tok, pos, out = tok0.to(torch.long), posv, []
    for i in range(n_steps):
        logits = _decode_step_windowed(params, cache, w_bufs, tok, pos, i, main_mask, cfg, rq,
                                       block_t)
        nxt = sample_logits(logits[:, -1, :], generator, temperature, top_k, top_p)
        out.append(nxt)
        tok, pos = nxt[:, None], pos + 1
    merge_window_into_cache(cache, w_bufs, posv, cfg, sink_tokens)
    return torch.stack(out, dim=1), cache
