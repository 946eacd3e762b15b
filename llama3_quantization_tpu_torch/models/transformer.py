"""Llama decoder forward and quantized-KV decode (port of the llama parts
of `llama3_quantization_tpu/models/transformer.py`).

Plain functions over the parameter tree of `models/params.py`. The layer
stack is a Python loop over the stacked `[L, ...]` tensors (views, no
copies). Routing depends on shapes and on four switches that mirror the
JAX package's (`transformer.py:150-165,280-431`), `set_flash`,
`set_decode_kernel`, `set_decode_attn` (default from `L3Q_DECODE_ATTN`, as
JAX reads it) and `set_stacked_decode` (which has nothing to choose
here, see below); at their defaults it follows the JAX package as it runs
with `set_decode_kernel("interpret")`:

- full-sequence attention takes kernel B7 (`ops/flash_attention.py`) when
  S >= 128, no q/k/v/p hook is set and B7 takes the heads' shape
  (`b7_takes`), the eager path otherwise (`transformer.py:160-162,203-204`);
  `set_flash(False)` sends it all to the eager path;
- a single-token decode step takes the decode kernel of its cache with
  `block_t = 1024 if T % 1024 == 0 else 512` (`:496,511,579`) where the
  kernel takes the shape (`b5_takes`, `b6_takes`; the eager path
  otherwise, as JAX's gate sends what its kernels cannot take there,
  `:367-394`): B4/B5 (`ops/decode_attention.py`) on the int8 or int4
  cache, B6 on the fp cache (`init_kv_cache(quantized=False)`, the
  default, bf16 or fp32) -- the layer-stacked form, but on the fp cache
  the per-layer form with a `[B, T]` mask for per-row positions
  (`decode_step_multi`, `:532-592`). Both forms read the stacked cache in
  place through layer views and give the same bits (JAX's per-layer form
  slices the cache per layer), so `set_stacked_decode`, which picks
  between them in JAX (`:394-431`), only checks its mode here. A shape
  turned away is counted (`B5.eager`, `B6.eager`, `B7.eager` in
  `ops/launches.py`). JAX's decode kernels take any rep (they pad the
  query rows to 8, `decode_attention.py:123,243,325`); B4/B5 and B6 take
  any rep up to 8 (their wrappers pad it to a form of 1, 2, 4 or 8), and
  a rep above 8 decodes eagerly (no port configuration has one);
- `set_decode_kernel(False)` sends every cached step, on all three caches,
  to the eager attention over the read-back cache and turns the windowed
  decode off (JAX `:374`, `windowed.py:112-123`): the route JAX takes
  wherever its gate is False, on the CPU by default. True and "auto" (the
  default) keep the kernel routing. The port has no "interpret" mode: on
  the CPU its kernels' plain versions play that part;
- `set_decode_attn("xla")` sends the int8 cache's single-token steps, and
  the windowed decode's main segment, to the codes-direct route
  (`ops/decode_attention.xla_decode_gqa_s8*`, JAX `decode_attention.py:
  491-586`); "kernel" and "auto" (the default) keep B5, and the int4 cache
  always takes B5 (JAX `:317`). On a TPU, JAX's "auto" picks the
  codes-direct route for int8 and its XLA einsum for the fp cache; the port
  deliberately keeps its kernels (B5, B6) there;
- an enabled q/k/v/p hook of `RuntimeQuantConfig`, and any prefill into the
  cache (S > 1, the speculative verify too), take the eager attention over
  the dequantized or upcast cache (`:373-376,566,593,603-607`);
- `greedy_generate` on an int4 cache takes the windowed decode
  (`models/windowed.py`) while the dispatch stays inside the ring.

`RuntimeQuantConfig` carries the runtime fake-quant hooks (`:37-64`): `act`
on every linear input, q/k before QK^T, p after the softmax, v before PV.
The KV cache is updated IN PLACE.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.decode_attention import (
    NEG,
    b5_takes,
    b6_takes,
    flash_decode_gqa,
    flash_decode_gqa_s8_stacked,
    flash_decode_gqa_stacked,
    xla_decode_gqa_s8_stacked,
)
from ..ops.flash_attention import b7_takes, causal_mask, flash_attention
from ..ops.kvcache import (
    CACHE_KEYS,
    cache_read,
    cache_update_stacked,
    init_quantized_kv_cache,
    layer_view,
    true_div,
)
from ..ops.launches import COUNTS
from ..ops.matmul import prepare_decode_params, qlinear
from ..ops.padding import PaddedWeight, pad_for_kernels, pad_weight
from ..ops.s4_matmul import S4Weight
from ..quant.qtensor import QuantizedTensor
from ..quant.quantizer import QuantSpec, fake_quant_dynamic
from .configs import ModelConfig

Params = Dict[str, Any]

#: full-sequence attention takes the flash kernel from this length on
FLASH_MIN_SEQ = 128


@dataclasses.dataclass(frozen=True)
class RuntimeQuantConfig:
    """Runtime fake-quant hooks, the reference's act / q / k / v / p
    quantizer dicts (`transformer.py:37-58`); weight quantization is a
    storage property of the parameter tree."""

    act: Optional[QuantSpec] = None  # linear-layer inputs
    q: Optional[QuantSpec] = None  # query before QK^T
    k: Optional[QuantSpec] = None  # key before QK^T
    v: Optional[QuantSpec] = None  # value before PV
    p: Optional[QuantSpec] = None  # softmax probabilities before PV

    @staticmethod
    def off() -> "RuntimeQuantConfig":
        return RuntimeQuantConfig()


NO_QUANT = RuntimeQuantConfig.off()


def _maybe_fq(x: torch.Tensor, spec: Optional[QuantSpec]) -> torch.Tensor:
    if spec is None or not spec.enabled:
        return x
    return fake_quant_dynamic(x, spec)


#: full-sequence flash switch (`transformer.py:150-165`): "auto" (the
#: default) and True = B7 wherever `b7_takes` holds (True never forces B7
#: onto a shape it cannot take); False = the eager `_attention`, where JAX
#: sends it off the TPU
_FLASH: Union[bool, str] = "auto"


def set_flash(mode) -> None:
    """True | False | "auto" (the default); see `_FLASH`."""
    global _FLASH
    if mode not in (True, False, "auto"):
        raise ValueError(f"set_flash takes True, False or 'auto', got {mode!r}")
    _FLASH = mode


def _flash_ok(rq: RuntimeQuantConfig) -> bool:
    """B7's gate before shapes: not under `set_flash(False)`, and no
    attention hook, since B7 hosts none: any q/k/v/p spec, enabled or not,
    keeps the full-sequence forward eager (`transformer.py:160-162`)."""
    return _FLASH is not False and all(spec is None for spec in (rq.q, rq.k, rq.v, rq.p))


#: decode-kernel switch (`transformer.py:280-294`): True and "auto" route
#: single-token cached steps to the decode kernels, False to the eager path
_DECODE_KERNEL: Union[bool, str] = "auto"
#: int8-KV decode attention (`transformer.py:297-321`): "xla" = the
#: codes-direct route, "kernel" and "auto" = B5 (the port's "auto"); the
#: default comes from `L3Q_DECODE_ATTN`, read at import as JAX reads it
_DECODE_ATTN = os.environ.get("L3Q_DECODE_ATTN", "auto")
if _DECODE_ATTN not in ("auto", "xla", "kernel"):
    raise ValueError(f"L3Q_DECODE_ATTN takes auto, xla or kernel, got {_DECODE_ATTN!r}")


def set_decode_kernel(mode) -> None:
    """True | False | "auto" (the default); see the module docstring."""
    global _DECODE_KERNEL
    if mode not in (True, False, "auto"):  # no "interpret": see the module docstring
        raise ValueError(f"set_decode_kernel takes True, False or 'auto', got {mode!r}")
    _DECODE_KERNEL = mode


def set_decode_attn(mode) -> None:
    """"auto" (the default) | "xla" | "kernel"; see the module docstring."""
    global _DECODE_ATTN
    if mode not in ("auto", "xla", "kernel"):
        raise ValueError(f"set_decode_attn takes 'auto', 'xla' or 'kernel', got {mode!r}")
    _DECODE_ATTN = mode


def set_stacked_decode(mode) -> None:
    """JAX's layer-stacked decode switch (`transformer.py:394-404`), kept
    for its API: True | False | "auto". The port's two forms give the same
    bits (see the module docstring), so it checks the mode and changes
    nothing."""
    if mode not in (True, False, "auto"):
        raise ValueError(f"set_stacked_decode takes True, False or 'auto', got {mode!r}")


def _use_xla_attn(codes_dtype) -> bool:
    """Does an int8 cache take the codes-direct route? (int4 never.)"""
    return codes_dtype == torch.int8 and _DECODE_ATTN == "xla"


def _decode_route_ok(rq: RuntimeQuantConfig, s: int = 1) -> bool:
    """The decode gate before shapes: a single-token step, not under
    `set_decode_kernel(False)`, hosting no enabled q/k/v/p hook
    (`transformer.py:374-376`)."""
    if _DECODE_KERNEL is False or s != 1:
        return False
    return not any(sp is not None and sp.enabled for sp in (rq.q, rq.k, rq.v, rq.p))


def _decode_shape_ok(cache: Dict[str, torch.Tensor], hq: int) -> bool:
    """Does the decode kernel of `cache` (B5 on int8 / int4 codes, B6 on
    an fp cache) take one token of `hq` query heads against it?"""
    t = cache_len(cache)
    bt = decode_block_t(t)
    if "k" in cache:
        _, _, g, _, d = cache["k"].shape
        return b6_takes(hq, g, d, t, bt, cache["k"].dtype)
    _, _, g, _, d = cache["k_q"].shape
    return b5_takes(hq, g, d, t, bt, cache["k_q"].dtype == torch.uint8)


def _decode_kernel_ok(rq: RuntimeQuantConfig, cache: Dict[str, torch.Tensor], s: int,
                      hq: int) -> bool:
    """The decode kernels (B5, B6) and the windowed decode: the route's gate
    and the kernel's shapes (`transformer.py:367-394`; the codes-direct
    route needs only `_decode_route_ok`)."""
    return _decode_route_ok(rq, s) and _decode_shape_ok(cache, hq)


def _stacked_decode_ok(rq: RuntimeQuantConfig, cache: Dict[str, torch.Tensor], s: int,
                       hq: int) -> bool:
    """Does a step take the layer-stacked decode form (`transformer.py:
    407-431`)? Wherever the decode kernel serves it. The port has no decode
    mesh."""
    return _decode_kernel_ok(rq, cache, s, hq)


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float, dtype, scaling=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [*, S] -> cos/sin [*, S, head_dim] (HF llama convention,
    with HF's "linear" and "llama3" `rope_scaling`)."""
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim))
    if scaling is not None:
        kind, factor, low_ff, high_ff, old_max = scaling
        if kind == "linear":
            inv_freq = inv_freq / factor
        elif kind == "llama3":
            wavelen = 2 * math.pi / inv_freq
            low_wl, high_wl = old_max / low_ff, old_max / high_ff
            scaled = torch.where(wavelen > low_wl, inv_freq / factor, inv_freq)
            smooth = (old_max / wavelen - low_ff) / (high_ff - low_ff)
            smoothed = (1 - smooth) * scaled / factor + smooth * scaled
            medium = (wavelen >= high_wl) & (wavelen <= low_wl)
            inv_freq = torch.where(medium, smoothed, scaled)
        else:
            raise ValueError(f"unsupported rope scaling type {kind!r}")
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [B or 1, S, D]."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[..., None, :] + rotated * sin[..., None, :]


def _attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, G, D], or [B, G, T, D] with kv_heads_major
    v: torch.Tensor,
    mask: torch.Tensor,  # [S, T] additive fp32, or per-row [B, S, T]
    rq: RuntimeQuantConfig = NO_QUANT,
    kv_heads_major: bool = False,
) -> torch.Tensor:
    """Eager GQA attention: fp32 scores and softmax, probabilities cast to
    q's dtype before PV, with the hooks' fake quant of q and k before QK^T,
    of the probabilities before the cast and of v before PV
    (`transformer.py:184-227`)."""
    b, s, h, d = q.shape
    g = k.shape[1] if kv_heads_major else k.shape[2]
    q = _maybe_fq(q, rq.q)
    k = _maybe_fq(k, rq.k)  # last-axis (D) reduction: layout-independent
    qg = q.reshape(b, s, g, h // g, d)
    kd = "bgtd" if kv_heads_major else "btgd"
    scores = true_div(torch.einsum(f"bsgrd,{kd}->bgrst", qg.float(), k.float()), math.sqrt(d))
    scores = scores + (mask[:, None, None] if mask.dim() == 3 else mask)
    probs = _maybe_fq(torch.softmax(scores, dim=-1), rq.p).to(q.dtype)
    v = _maybe_fq(v, rq.v)
    out = torch.einsum(f"bgrst,{kd}->bsgrd", probs.float(), v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def full_attention(q, k, v, mask, cfg: ModelConfig, rq: RuntimeQuantConfig = NO_QUANT):
    """Causal attention over the full sequence (no cache): B7 at S >=
    FLASH_MIN_SEQ where its gate and `b7_takes` let it, the eager
    `_attention` otherwise (`transformer.py:203-204`, `allow_flash=True`).
    Differentiable on both routes: under autograd B7 runs with its gradient
    kernels (`ops/flash_attention.FlashAttentionFn`)."""
    use_flash = q.shape[1] >= FLASH_MIN_SEQ and _flash_ok(rq)
    if use_flash and not b7_takes(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_):
        COUNTS["B7.eager"] += 1
        use_flash = False
    return flash_attention(q, k, v) if use_flash else _attention(q, k, v, mask, rq)


def _kernel_mask(mask: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """[s=1, T] or per-row [B, 1, T] additive mask -> finite contiguous
    [B, T] for the decode kernel (row b keeps its own mask)."""
    m = mask[:, 0] if mask.dim() == 3 else mask[-1:].expand(b, t)
    return m.float().clamp(min=NEG).contiguous()


def _layer_params(layers: Params, i: int) -> Params:
    """Layer `i` of the stacked layer tree (views, no copies)."""
    out = {}
    for name, entry in layers.items():
        out[name] = {
            key: (val.layer(i) if isinstance(val, (QuantizedTensor, S4Weight, PaddedWeight))
                  else val[i])
            for key, val in entry.items()
        }
    return out


def qkv_proj(p: Params, h: torch.Tensor, cfg: ModelConfig, act: Optional[QuantSpec] = None):
    """q [B, S, H, D], k and v [B, S, Hkv, D]: one dot on the fused `qkv`
    entry (`quant/serving.fuse_for_decode`, `transformer.py:456-462`), or
    three; `act` is the input's fake-quant spec."""
    b, s, _ = h.shape
    hd = cfg.head_dim_
    if "qkv" in p:
        nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        qkv = qlinear(h, p["qkv"]["w"], p["qkv"].get("b"), act)
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
    else:
        q, k, v = (qlinear(h, p[n]["w"], p[n].get("b"), act) for n in ("q", "k", "v"))
    return (q.reshape(b, s, cfg.num_heads, hd), k.reshape(b, s, cfg.num_kv_heads, hd),
            v.reshape(b, s, cfg.num_kv_heads, hd))


def decode_block_t(t: int) -> int:
    """The decode kernels' T block for a cache of `t` tokens (`:496,511`)."""
    return 1024 if t % 1024 == 0 else 512


def _write_cache(buf: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write `new` [B, S, H, D] into the heads-major fp cache view
    [B, H, T, D] at `pos`, IN PLACE, cast to the cache dtype: an int (S
    tokens from there) or per-row slots [B] (S == 1) (`transformer.py:243-253`)."""
    new = new.transpose(1, 2).to(buf.dtype)  # [B, H, S, D]
    if torch.is_tensor(pos) and pos.dim() == 1:
        buf[torch.arange(buf.shape[0], device=buf.device), :, pos] = new[:, :, 0]
    else:
        buf[:, :, pos : pos + new.shape[2]] = new


def _write_cache_stacked(buf: torch.Tensor, new: torch.Tensor, layer: int, pos) -> None:
    """`_write_cache` on layer `layer` of the stacked fp cache [L, B, H, T, D]
    (`transformer.py:256-272`)."""
    _write_cache(buf[layer], new, pos)


def _attn_block(
    p: Params,
    h: torch.Tensor,
    cfg: ModelConfig,
    rq: RuntimeQuantConfig,
    cos_sin,
    mask: Optional[torch.Tensor],
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_pos: Union[int, torch.Tensor, None] = None,
    layer: Optional[int] = None,
) -> torch.Tensor:
    b, s, _ = h.shape
    hd = cfg.head_dim_
    q, k, v = qkv_proj(p, h, cfg, rq.act)
    if cos_sin is not None:
        cos, sin = cos_sin
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if cache is None:
        attn = full_attention(q, k, v, mask, cfg, rq)
    elif "k" in cache:  # fp cache (`transformer.py:500-514,567-593`)
        ck, cv = cache["k"], cache["v"]
        _write_cache_stacked(ck, k, layer, cache_pos)
        _write_cache_stacked(cv, v, layer, cache_pos)
        t = ck.shape[3]
        block_t = decode_block_t(t)
        if _take_decode_kernel(rq, cache, s, cfg.num_heads, "B6.eager"):
            kmask = _kernel_mask(mask, b, t)
            if torch.is_tensor(cache_pos) and cache_pos.dim() == 1:
                attn = flash_decode_gqa(q.to(ck.dtype), ck[layer], cv[layer], kmask, block_t)
            else:
                attn = flash_decode_gqa_stacked(q.to(ck.dtype), ck, cv, kmask, layer, block_t)
            attn = attn.to(h.dtype)
        else:
            attn = _attention(q, ck[layer].to(h.dtype), cv[layer].to(h.dtype), mask, rq,
                              kv_heads_major=True)
    else:
        cache_update_stacked(cache, layer, k, v, cache_pos)
        t = cache["k_s"].shape[3]  # logical tokens (int4 rows hold two)
        block_t = decode_block_t(t)
        codes = tuple(cache[key] for key in CACHE_KEYS)
        if _decode_route_ok(rq, s) and _use_xla_attn(cache["k_q"].dtype):
            attn = xla_decode_gqa_s8_stacked(q, *codes, _kernel_mask(mask, b, t), layer,
                                             out_dtype=h.dtype)
        elif _take_decode_kernel(rq, cache, s, cfg.num_heads, "B5.eager"):
            attn = flash_decode_gqa_s8_stacked(q, *codes, _kernel_mask(mask, b, t), layer,
                                               out_dtype=h.dtype, block_t=block_t)
        else:
            k_all, v_all = cache_read(layer_view(cache, layer), h.dtype)
            attn = _attention(q, k_all, v_all, mask, rq, kv_heads_major=True)
    return qlinear(attn.reshape(b, s, cfg.num_heads * hd), p["o"]["w"], p["o"].get("b"), rq.act)


def _take_decode_kernel(rq: RuntimeQuantConfig, cache, s: int, hq: int,
                        eager_key: str) -> bool:
    """Does this cached step take its cache's decode kernel? A step that the
    route's gate lets through but the kernel's shapes turn away takes the
    eager path and is counted under `eager_key`."""
    if not _decode_route_ok(rq, s):
        return False
    if _decode_shape_ok(cache, hq):
        return True
    COUNTS[eager_key] += 1
    return False


def _mlp_block(p: Params, h: torch.Tensor, rq: RuntimeQuantConfig = NO_QUANT) -> torch.Tensor:
    act = rq.act
    if "gateup" in p:  # fused gate|up (`transformer.py:712-714`)
        gu = qlinear(h, p["gateup"]["w"], p["gateup"].get("b"), act)
        half = gu.shape[-1] // 2
        gate, up = gu[..., :half], gu[..., half:]
    else:
        gate = qlinear(h, p["gate"]["w"], p["gate"].get("b"), act)
        up = qlinear(h, p["up"]["w"], p["up"].get("b"), act)
    return qlinear(F.silu(gate) * up, p["down"]["w"], p["down"].get("b"), act)


def decoder_layer(
    p: Params, h: torch.Tensor, cfg: ModelConfig, rq: RuntimeQuantConfig, cos_sin, mask,
    cache=None, cache_pos=None, layer=None,
) -> torch.Tensor:
    """Pre-norm residual llama layer. With `cache`, `layer` indexes the
    layer-stacked cache (fp or quantized), which is written in place at
    `cache_pos` (an int, or per-row slots `[B]`)."""
    attn_in = rms_norm(h, p["ln1"]["w"], cfg.rms_norm_eps, p["ln1"].get("b"))
    h = h + _attn_block(p, attn_in, cfg, rq, cos_sin, mask, cache, cache_pos, layer)
    mlp_in = rms_norm(h, p["ln2"]["w"], cfg.rms_norm_eps, p["ln2"].get("b"))
    return h + _mlp_block(p, mlp_in, rq)


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding; out-of-range ids clip to the table (JAX mode="clip")."""
    table = params["embed"]
    return table[tokens.clamp(0, table.shape[0] - 1)]


def final_norm(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(h, params["norm"]["w"], cfg.rms_norm_eps, params["norm"].get("b"))


def lm_head(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The head's logits; a quantized head on the card that a kernel does
    not take is padded first (nothing to do on a prepared tree)."""
    w = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return qlinear(h, pad_weight(w) if isinstance(w, QuantizedTensor) else w)


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch != "llama":
        raise NotImplementedError(f"arch {cfg.arch!r} is not ported yet")


def forward_hidden(
    params: Params, tokens: torch.Tensor, cfg: ModelConfig, rq: RuntimeQuantConfig = NO_QUANT
) -> torch.Tensor:
    """Full-sequence causal forward to final hidden states `[B, S, d]`.
    Weights on the card that a kernel does not take are padded first
    (`ops/padding.pad_for_kernels`; nothing to do on a prepared tree)."""
    _check_arch(cfg)
    params = pad_for_kernels(params)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :]
    h = embed(params, tokens)
    cos_sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta, h.dtype, cfg.rope_scaling_)
    mask = causal_mask(s, device=tokens.device)
    for i in range(cfg.num_layers):
        h = decoder_layer(_layer_params(params["layers"], i), h, cfg, rq, cos_sin, mask)
    return final_norm(params, h, cfg)


def forward_logits(
    params: Params, tokens: torch.Tensor, cfg: ModelConfig, rq: RuntimeQuantConfig = NO_QUANT
) -> torch.Tensor:
    """Logits `[B, S, V]` of the full-sequence forward (prefill / eval)."""
    return lm_head(params, forward_hidden(params, tokens, cfg, rq), cfg)


def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype=None, quantized=False, device="cuda"
) -> Dict[str, torch.Tensor]:
    """Preallocated heads-major cache `[L, B, Hkv, max_len, *]`
    (`transformer.py:847-863`): by default the fp cache `{"k", "v"}` in
    `dtype` (None: `cfg.dtype`, whatever the parameters' dtype);
    `quantized=8` (or True) int8 codes, `quantized=4` the int4 T-pair pack
    (`ops/kvcache.py`)."""
    dev = resolve_device(device)
    if quantized:
        if quantized is not True and quantized not in (4, 8):
            raise ValueError(f"quantized must be False, True, 8 or 4; got {quantized!r}")
        return init_quantized_kv_cache(cfg, batch, max_len, dev, bits=4 if quantized == 4 else 8)
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_len(cache: Dict[str, torch.Tensor]) -> int:
    """Logical tokens of a cache of either kind (int4 rows hold two)."""
    return (cache["k"] if "k" in cache else cache["k_s"]).shape[3]


def _ring_write_and_mask(pos, s: int, max_len: int, sink: int, device):
    """Write slot(s) and additive mask for the sink+ring layout: slots
    [0, sink) pin the first positions, [sink, max_len) hold a ring of the
    most recent ones (`transformer.py:866-891`). `pos` is an int (mask
    [s, max_len]) or, for single-token steps, a per-row tensor [B] (write
    slots [B], mask [B, 1, max_len])."""
    w = max_len - sink
    slots = torch.arange(max_len, device=device)[None, :]
    if torch.is_tensor(pos) and pos.dim() == 1:
        if s != 1:
            raise ValueError("per-row positions take single-token steps")
        write_slot = torch.where(pos < max_len, pos, sink + torch.remainder(pos - sink, w))
        last = qi = pos[:, None]
    else:
        if s == 1:
            write_slot = pos if pos < max_len else sink + (pos - sink) % w
        else:
            if s > max_len:
                raise ValueError(f"a span of {s} tokens does not fit max_len={max_len}")
            # JAX writes at `pos` through `dynamic_update_slice`, which clamps
            # the start so that the span fits: past the end it lands at
            # max_len - s, earlier than its positions; the mask stays JAX's
            write_slot = min(pos, max_len - s)
        last = pos if s == 1 else pos + s - 1
        qi = pos + torch.arange(s, device=device)[:, None]
    abs_ring = last - torch.remainder(last - slots, w)
    ring_valid = (slots >= sink) & (abs_ring >= sink) & (abs_ring <= qi)
    sink_valid = (slots < sink) & (slots <= qi)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    mask = torch.where(ring_valid | sink_valid, zero, torch.full_like(zero, -math.inf))
    if torch.is_tensor(pos) and pos.dim() == 1:
        mask = mask[:, None, :]
    return write_slot, mask


def _decode_hidden(params, cache, tokens, positions, write_slot, mask, cfg, rq) -> torch.Tensor:
    """The layer stack against the cache (written in place): final hidden.
    Weights on the card that a kernel does not take are padded first."""
    params = pad_for_kernels(params)
    h = embed(params, tokens)
    cos_sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta, h.dtype, cfg.rope_scaling_)
    for i in range(cfg.num_layers):
        h = decoder_layer(
            _layer_params(params["layers"], i), h, cfg, rq, cos_sin, mask, cache, write_slot, i
        )
    return final_norm(params, h, cfg)


def decode_hidden(
    params: Params,
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,  # [B, S] (S = 1 decode, > 1 prefill)
    pos: int,
    cfg: ModelConfig,
    rq: RuntimeQuantConfig = NO_QUANT,
    sink_tokens: int = 0,
) -> torch.Tensor:
    """`decode_step` up to the final norm: hidden states `[B, S, d]`. The
    serving engine takes the lm_head of the rows it needs only."""
    _check_arch(cfg)
    b, s = tokens.shape
    pos = int(pos)
    positions = pos + torch.arange(s, device=tokens.device)[None, :]
    write_slot, mask = _ring_write_and_mask(pos, s, cache_len(cache), sink_tokens, tokens.device)
    return _decode_hidden(params, cache, tokens, positions, write_slot, mask, cfg, rq)


def decode_step(
    params: Params,
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,  # [B, S] (S = 1 decode, > 1 prefill)
    pos: int,
    cfg: ModelConfig,
    rq: RuntimeQuantConfig = NO_QUANT,
    sink_tokens: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One prefill/decode step against the cache (fp or quantized), which is
    updated IN PLACE. Returns (logits [B, S, V], cache)."""
    h = decode_hidden(params, cache, tokens, pos, cfg, rq, sink_tokens)
    return lm_head(params, h, cfg), cache


def decode_step_multi(
    params: Params,
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,  # [B, 1] one token per slot
    pos: torch.Tensor,  # [B] per-slot absolute positions
    cfg: ModelConfig,
    rq: RuntimeQuantConfig = NO_QUANT,
    sink_tokens: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step for a batch of independent sequences at their own
    positions, the step of continuous batching (`transformer.py:984-1021`):
    each row writes its own sink+ring slot, then B4 (quantized cache) or B6
    (fp cache) reads each layer view under its own `[B, T]` mask. Returns
    (logits [B, 1, V], cache)."""
    _check_arch(cfg)
    b, s = tokens.shape
    if s != 1 or tuple(pos.shape) != (b,):
        raise ValueError(f"multi-slot decode takes tokens [B, 1] and pos [B]; got {tuple(tokens.shape)}, {tuple(pos.shape)}")
    write_slot, mask = _ring_write_and_mask(pos, 1, cache_len(cache), sink_tokens, tokens.device)
    h = _decode_hidden(params, cache, tokens, pos[:, None], write_slot, mask, cfg, rq)
    return lm_head(params, h, cfg), cache


def sampling_logits(
    logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0
) -> torch.Tensor:
    """Temperature-scaled fp32 logits [B, V] with the top-k and nucleus
    (top-p) masks applied as -inf fills (`transformer.py:1198-1211`)."""
    scaled = logits.float() / temperature
    if top_k and top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k][:, None]
        scaled = torch.where(scaled < kth, -math.inf, scaled)
    if top_p < 1.0:
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p (the
        # argmax always survives: cum is shifted by its own prob)
        keep_sorted = cum - probs < top_p
        thresh = torch.where(keep_sorted, sorted_desc, math.inf).amin(dim=-1, keepdim=True)
        scaled = torch.where(scaled < thresh, -math.inf, scaled)
    return scaled


def sample_logits(
    logits: torch.Tensor,  # [B, V]
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """One sampling step: temperature, top-k mask, nucleus mask, then a
    categorical draw by the Gumbel-max rule from `generator` (on the
    logits' device). temperature <= 0 is greedy. Draws are the generator's
    own, not JAX's random stream. Returns int64 tokens [B]."""
    if temperature is None or temperature <= 0.0:
        return logits.argmax(dim=-1)
    scaled = sampling_logits(logits, temperature, top_k, top_p)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    return (scaled + gumbel).argmax(dim=-1)


def greedy_generate(
    params: Params,
    cache: Dict[str, torch.Tensor],
    first_token: torch.Tensor,  # [B, 1]
    pos0: int,
    n_steps: int,
    cfg: ModelConfig,
    rq: RuntimeQuantConfig = NO_QUANT,
    sink_tokens: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Greedy decode (`transformer.py:1024-1101`). Returns (tokens
    [B, n_steps], cache).

    An int4 cache takes the windowed decode (`models/windowed.py`) when the
    window fits the ring width (`n_steps < T - sink`) and nothing is
    evicted during it (`pos0 + n_steps <= T`); every other cache runs one
    `decode_step` per token. Under the "s4" backend the weights are
    prepared once per call, outside the step loop (`transformer.py:1052`)."""
    from .windowed import decode_window, windowed_ok

    params = prepare_decode_params(params)
    pos0 = int(pos0)
    t_logical = cache_len(cache)
    if (
        "k_q" in cache and cache["k_q"].dtype == torch.uint8
        and n_steps < t_logical - sink_tokens
        and windowed_ok(cfg, cache, rq, sink_tokens)
        and pos0 + n_steps <= t_logical
    ):
        return decode_window(params, cache, first_token, pos0, n_steps, cfg, rq,
                             sink_tokens=sink_tokens)
    tok = first_token.to(torch.long)
    out = []
    for i in range(n_steps):
        logits, cache = decode_step(params, cache, tok, pos0 + i, cfg, rq, sink_tokens)
        tok = logits[:, -1, :].argmax(dim=-1)[:, None]
        out.append(tok[:, 0])
    return torch.stack(out, dim=1), cache


def sample_generate(
    params: Params,
    cache: Dict[str, torch.Tensor],
    first_token: torch.Tensor,  # [B, 1]
    pos0: int,
    n_steps: int,
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    rq: RuntimeQuantConfig = NO_QUANT,
    sink_tokens: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sampled decode (temperature / top-k / nucleus), one `decode_step` per
    token (`transformer.py:1215-1251`). Draws come from `generator` (on the
    cache's device) through `sample_logits`, where JAX splits a key per
    step: a seed repeats its stream, but not JAX's. temperature <= 0 is
    greedy. Returns (tokens [B, n_steps], cache)."""
    params = prepare_decode_params(params)
    pos0 = int(pos0)
    tok = first_token.to(torch.long)
    out = []
    for i in range(n_steps):
        logits, cache = decode_step(params, cache, tok, pos0 + i, cfg, rq, sink_tokens)
        tok = sample_logits(logits[:, -1, :], generator, temperature, top_k, top_p)[:, None]
        out.append(tok[:, 0])
    return torch.stack(out, dim=1), cache


def speculative_generate(
    params: Params,
    draft_params: Params,
    cache: Dict[str, torch.Tensor],
    draft_cache: Dict[str, torch.Tensor],
    first_token: torch.Tensor,  # [1, 1]
    pos0: int,
    n_rounds: int,
    k: int,
    cfg: ModelConfig,
    draft_cfg: Optional[ModelConfig] = None,
    rq: RuntimeQuantConfig = NO_QUANT,
    draft_rq: RuntimeQuantConfig = NO_QUANT,
    sink_tokens: int = 0,
):
    """Greedy speculative decoding (`transformer.py:1104-1171`): each round
    the draft proposes `k` greedy tokens in single-token steps, the target
    verifies all k+1 positions in one `decode_step` (S = k+1), and the
    longest matching prefix plus the target's own next token are emitted,
    so the stream is the target's greedy stream. Batch 1 only.

    As in JAX, the draft writes `tok, d1 .. d_{k-1}` in a round and never
    `d_k`: after a fully accepted round its slot `pos + k` keeps stale K/V
    that later draft steps attend to. That moves acceptance counts, never
    the emitted stream; the port keeps it so that counts match JAX's. Each
    round brings its accepted count to the host (the next round's position).

    Returns (tokens [n_rounds, k+1] right-padded, counts [n_rounds], cache,
    draft_cache, final position); flatten with `flatten_speculative`."""
    if first_token.shape[0] != 1:
        raise ValueError("speculative_generate supports batch=1")
    dcfg = draft_cfg or cfg
    params = prepare_decode_params(params)
    draft_params = prepare_decode_params(draft_params)
    tok, pos = first_token.to(torch.long), int(pos0)
    idx = torch.arange(k + 1, device=tok.device)
    rows, counts = [], []
    for _ in range(n_rounds):
        t, drafts = tok, []
        for i in range(k):
            lg, draft_cache = decode_step(draft_params, draft_cache, t, pos + i, dcfg, draft_rq,
                                          sink_tokens)
            t = lg[:, -1, :].argmax(dim=-1)[:, None]
            drafts.append(t)
        seq = torch.cat([tok] + drafts, dim=1)  # [1, k+1]
        logits, cache = decode_step(params, cache, seq, pos, cfg, rq, sink_tokens)
        t_pred = logits.argmax(dim=-1)  # [1, k+1]
        d_row = seq[:, 1:]
        m = torch.cumprod((d_row == t_pred[:, :k]).long(), dim=1).sum(dim=1)[0]
        emitted = torch.where(idx < m, F.pad(d_row[0], (0, 1)), t_pred[0])
        tok = emitted[m].reshape(1, 1)
        rows.append(emitted)
        counts.append(m + 1)
        pos += int(m) + 1
    return torch.stack(rows), torch.stack(counts), cache, draft_cache, pos


def flatten_speculative(toks, counts, limit: Optional[int] = None) -> List[int]:
    """Host side: each round's first `count` tokens, concatenated."""
    out: List[int] = []
    for row, c in zip(torch.as_tensor(toks).tolist(), torch.as_tensor(counts).tolist()):
        out.extend(row[: int(c)])
    return out[:limit] if limit else out
