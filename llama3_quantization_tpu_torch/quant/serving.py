"""Serving recodes and horizontal fusion (port of
`llama3_quantization_tpu/quant/serving.py`).

- `recode_s8_percol`: any QuantizedTensor -> per-output-column symmetric
  int8 (`c8[:, n] = round(W_deq[:, n] / s_n)`, `s_n = absmax_n / 127`), the
  a8 backend's weight format; `recode_model_s8` recodes every decoder
  linear, one layer at a time, so an 8B recode never holds the fp32
  dequant of the whole model. JAX runs `recode_model_s8`'s recodes under
  `jax.jit`, where XLA turns `absmax / 127` into `absmax * f32(1/127)`; the
  port's `recode_model_s8` mirrors that rounding, its eager recodes the
  exact quotient, as JAX's eager calls give.
- `recode_head_s8` / `recode_head_s4`: a full-precision lm_head to
  per-column symmetric int8 / int4 codes (int8 containers, no zero point).
- `fuse_for_decode`: q/k/v -> `qkv` and gate/up -> `gateup`, concatenated
  along N; numerics are unchanged (scales `[G, N]` concatenate exactly).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.params import MOE_EXPERT_LINEARS, linear_names
from ..ops.kvcache import true_div
from .qtensor import QuantizedTensor, dequantize


def _percol(wf: torch.Tensor, levels: float, jitted: bool = False):
    """fp32 [K, N] -> (int8 codes in [-levels, levels], [1, N] fp32 scale).
    `jitted`: the scale as XLA computes it under jit, absmax times the fp32
    reciprocal of `levels`."""
    absmax = wf.abs().amax(dim=0, keepdim=True)
    if jitted:
        s = absmax * true_div(torch.ones((), dtype=torch.float32, device=wf.device), levels)
    else:
        s = true_div(absmax, levels)
    s = s.clamp(min=1e-12)
    codes = torch.round(wf / s).clamp(-levels, levels).to(torch.int8)
    return codes, s


def _head_out_dtype(w: torch.Tensor) -> torch.dtype:
    return w.dtype if w.dtype.is_floating_point else torch.bfloat16


def recode_s8_percol(qt: QuantizedTensor, jitted: bool = False) -> QuantizedTensor:
    """Any (unstacked) QuantizedTensor -> per-column symmetric int8 container."""
    c8, s = _percol(dequantize(qt, torch.float32), 127.0, jitted)
    return QuantizedTensor(
        data=c8, scale=s, zero=None, bits=8, group_size=None, sym=True,
        k=qt.k, n=qt.n, packed=False, out_dtype=qt.out_dtype,
    )


def recode_head_s8(w: torch.Tensor, jitted: bool = False) -> QuantizedTensor:
    """Full-precision lm_head [d, vocab] -> per-column symmetric s8."""
    c8, sc = _percol(w.float(), 127.0, jitted)
    return QuantizedTensor(
        data=c8, scale=sc, zero=None, bits=8, group_size=None, sym=True,
        k=w.shape[0], n=w.shape[1], packed=False, out_dtype=_head_out_dtype(w),
    )


def recode_head_s4(w: torch.Tensor) -> QuantizedTensor:
    """Full-precision lm_head [d, vocab] -> per-column symmetric int4 codes
    in int8 containers (the s4 backend's head)."""
    c4, s = _percol(w.float(), 7.0)
    return QuantizedTensor(
        data=c4, scale=s, zero=None, bits=4, group_size=None, sym=True,
        k=w.shape[0], n=w.shape[1], packed=False, out_dtype=_head_out_dtype(w),
    )


def _concat_qt(qts) -> QuantizedTensor:
    """Concat containers along N (stacked `[L, K, N]` layout): data, scale
    and zero all join on the last axis."""
    base = qts[0]
    zero = None if base.zero is None else torch.cat([q.zero for q in qts], dim=-1)
    return dataclasses.replace(
        base,
        data=torch.cat([q.data for q in qts], dim=-1),
        scale=torch.cat([q.scale for q in qts], dim=-1),
        zero=zero,
        n=sum(q.n for q in qts),
    )


def _fusible(ws) -> bool:
    if all(isinstance(w, torch.Tensor) for w in ws):
        return True
    if not all(isinstance(w, QuantizedTensor) for w in ws):
        return False
    if any(w.g_idx is not None for w in ws):  # act-order groups don't concat
        return False
    if len({(w.bits, w.k, w.group_size, w.packed, w.sym, w.zero is None, w.out_dtype)
            for w in ws}) != 1:
        return False
    # per-column s8 serving containers, or grouped (incl. packed) tensors
    return ws[0].group_size is not None or (not ws[0].packed and ws[0].zero is None)


def _fuse_group(layers, names, fused_name) -> bool:
    """Merge the `names` entries into one horizontally concatenated linear."""
    entries = [layers[n] for n in names]
    ws = [e["w"] for e in entries]
    if not _fusible(ws):
        return False
    biases = [e.get("b") for e in entries]
    if any(b is not None for b in biases) and not all(b is not None for b in biases):
        return False
    fused = {"w": _concat_qt(ws) if isinstance(ws[0], QuantizedTensor) else torch.cat(ws, dim=-1)}
    if biases[0] is not None:
        fused["b"] = torch.cat(biases, dim=-1)
    for n in names:
        del layers[n]
    layers[fused_name] = fused
    return True


def fuse_for_decode(params, cfg):
    """Horizontally fuse q/k/v -> qkv and gate/up -> gateup (fewer weight
    dots and activation quantizations per decode step). Fuses zero-free
    per-column containers, grouped tensors of one (bits, K, group_size,
    packed) or plain arrays; the new tensors are copies."""
    out = dict(params)
    layers = dict(params["layers"])
    if all(n in layers for n in ("q", "k", "v")):
        _fuse_group(layers, ("q", "k", "v"), "qkv")
    if all(n in layers for n in ("gate", "up")):
        _fuse_group(layers, ("gate", "up"), "gateup")
    out["layers"] = layers
    return out


def _stack(qts) -> QuantizedTensor:
    base = qts[0]
    return dataclasses.replace(
        base, data=torch.stack([q.data for q in qts]), scale=torch.stack([q.scale for q in qts]),
    )


def recode_model_s8(params, cfg, include_head: bool = False):
    """Recode every quantized decoder linear for s8 serving, one layer (and
    on Mixtral one expert of the `[L, E, K, N]` stacks) at a time
    (`serving.py:163-210`). `include_head` also recodes a non-tied lm_head."""
    def recode_stacked(w: QuantizedTensor, lead_dims: int) -> QuantizedTensor:
        if lead_dims == 0:
            return recode_s8_percol(w, jitted=True)
        return _stack([recode_stacked(w.layer(i), lead_dims - 1)
                       for i in range(w.data.shape[0])])

    out = dict(params)
    layers = dict(params["layers"])
    for name in linear_names(cfg):
        entry = dict(layers[name])
        if isinstance(entry["w"], QuantizedTensor):
            entry["w"] = recode_stacked(entry["w"], 1)
            layers[name] = entry
    if cfg.is_moe:
        experts = dict(layers["experts"])
        for name in MOE_EXPERT_LINEARS:
            entry = dict(experts[name])
            if isinstance(entry["w"], QuantizedTensor):
                entry["w"] = recode_stacked(entry["w"], 2)
                experts[name] = entry
        layers["experts"] = experts
    out["layers"] = layers
    if include_head and "lm_head" in out:
        out["lm_head"] = recode_head_s8(out["lm_head"], jitted=True)
    return out
