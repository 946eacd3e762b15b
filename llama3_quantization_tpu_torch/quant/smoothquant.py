"""SmoothQuant: activation-outlier migration for W8A8-class quantization
(port of `llama3_quantization_tpu/quant/smoothquant.py`).

Per-layer activation statistics come from the calibration stream
(`collect_act_stats`); `smooth_layer` folds s = act^alpha / w^(1 - alpha)
through the norm -> linear and v -> o boundaries. The result is still fp:
quantize afterwards (RTN, GPTQ) and evaluate with runtime activation
quantization.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.configs import ModelConfig
from ..models.params import linear_names
from ..models.transformer import NO_QUANT
from .calibration import (
    _layer_slice,
    _stack_layers,
    calib_tensor,
    embed_calibration,
    layer_linear_inputs,
    run_layer_xla,
)
from .smoothing import (
    fold_fc_fc,
    fold_norm_linears,
    fold_norm_moe,
    sanitize_scale,
    smoothquant_scale,
)


@torch.no_grad()
def collect_act_stats(params, cfg: ModelConfig, calib_tokens: np.ndarray, batch_size: int = 8):
    """Per layer and per linear, the input activation's |max| and mean over
    the calibration stream, propagated through the fp layers
    (`smoothquant.py:27-70`): a list of {name: {"absmax", "mean"}}, fp32
    [K] each; on Mixtral also `experts_in`, the router's and the experts'
    shared input."""
    tokens = calib_tensor(params, calib_tokens)
    n = tokens.shape[0]
    h0, cos_sin, mask = embed_calibration(params, cfg, tokens)
    h = [h0[b0 : b0 + batch_size] for b0 in range(0, n, batch_size)]
    del h0
    names = list(linear_names(cfg))
    if cfg.is_moe:
        names.append("experts_in")
    stats = []
    for l in range(cfg.num_layers):
        p_l = _layer_slice(params["layers"], l)
        absmax: Dict[str, Optional[torch.Tensor]] = {m: None for m in names}
        mean_acc: Dict[str, Any] = {m: 0.0 for m in names}
        count = 0
        for bi in range(len(h)):
            caps = layer_linear_inputs(p_l, h[bi], cfg, NO_QUANT, cos_sin, mask)
            for m in names:
                x = caps[m].float().reshape(-1, caps[m].shape[-1])
                amax = x.abs().amax(dim=0)
                absmax[m] = amax if absmax[m] is None else torch.maximum(absmax[m], amax)
                mean_acc[m] = mean_acc[m] + x.sum(dim=0)
            count += caps[names[0]].reshape(-1, caps[names[0]].shape[-1]).shape[0]
            h[bi] = run_layer_xla(p_l, h[bi], cfg, NO_QUANT, cos_sin, mask)
        stats.append({m: {"absmax": absmax[m], "mean": mean_acc[m] / count} for m in names})
    return stats


def save_act_stats(stats, path: str) -> None:
    """Write per-layer activation stats as JAX writes them: npz keys
    `{layer}/{name}/absmax` and `.../mean`."""
    payload = {}
    for l, layer in enumerate(stats):
        for name, d in layer.items():
            payload[f"{l}/{name}/absmax"] = d["absmax"].detach().cpu().float().numpy()
            payload[f"{l}/{name}/mean"] = d["mean"].detach().cpu().float().numpy()
    np.savez(path, **payload)


def load_act_stats(path: str, device="cuda"):
    """Stats written by `save_act_stats` (either package's), on `device`
    (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    layers: dict = {}
    with np.load(path) as data:
        for key in data.files:
            l, name, kind = key.split("/")
            layers.setdefault(int(l), {}).setdefault(name, {})[kind] = \
                torch.from_numpy(np.array(data[key])).to(dev)
    return [layers[l] for l in sorted(layers)]


def _w_absmax_in(entries) -> torch.Tensor:
    """Per-input-channel |max| across a group of [K, N] weights."""
    return torch.stack([e["w"].float().abs().amax(dim=1) for e in entries]).amax(dim=0)


def smooth_layer(p_l: Dict[str, Any], layer_stats, cfg: ModelConfig, alpha: float = 0.5,
                 use_shift: bool = False) -> Dict[str, Any]:
    """Fold SmoothQuant scales at every migration point of one layer
    (`smoothquant.py:95-168`): (norm1 -> q/k/v), (norm2 -> the MLP's
    inputs: llama's gate/up, OPT's fc1), (v -> o). Falcon's shared norm
    folds once into q/k/v and fc1 together; Mixtral's norm2 folds into the
    router and every expert's gate/up, scale only."""
    p = dict(p_l)
    mlp_in = ["gate", "up"] if cfg.arch == "llama" else ["fc1"]
    group1 = ["q", "k", "v"] + (mlp_in if cfg.parallel_block and not cfg.is_moe else [])
    s1 = smoothquant_scale(layer_stats["q"]["absmax"], _w_absmax_in([p[m] for m in group1]),
                           alpha)
    shift1 = layer_stats["q"]["mean"] if use_shift else None
    p["ln1"], outs = fold_norm_linears(p["ln1"], [p[m] for m in group1], s1, shift1)
    for m, e in zip(group1, outs):
        p[m] = e
    if cfg.is_moe:
        expert_wmax = torch.stack([p["experts"][m]["w"].float().abs().amax(dim=(0, 2))
                                   for m in ("gate", "up")]).amax(dim=0)
        s2 = smoothquant_scale(layer_stats["experts_in"]["absmax"], expert_wmax, alpha)
        p["ln2"], p["router"], p["experts"] = fold_norm_moe(p["ln2"], p["router"], p["experts"],
                                                            s2)
    elif not cfg.parallel_block:
        s2 = smoothquant_scale(layer_stats[mlp_in[0]]["absmax"],
                               _w_absmax_in([p[m] for m in mlp_in]), alpha)
        shift2 = layer_stats[mlp_in[0]]["mean"] if use_shift else None
        p["ln2"], outs = fold_norm_linears(p["ln2"], [p[m] for m in mlp_in], s2, shift2)
        for m, e in zip(mlp_in, outs):
            p[m] = e
    return _smooth_v_o(p, layer_stats, cfg, alpha)


def _smooth_v_o(p, layer_stats, cfg: ModelConfig, alpha: float):
    """v -> o fold per o-input channel; with GQA the stats and weight ranges
    are max-reduced over each kv head's repeat group first, and the fold
    scales v once and o per repeated copy."""
    nv = p["v"]["w"].shape[1]
    o_in_amax = _reduce_to_v_layout(layer_stats["o"]["absmax"], cfg, nv)
    w_o_amax = _reduce_to_v_layout(p["o"]["w"].float().abs().amax(dim=1), cfg, nv)
    sv = smoothquant_scale(o_in_amax, w_o_amax, alpha)
    if p["o"]["w"].shape[0] == nv:
        p["v"], p["o"] = fold_fc_fc(p["v"], p["o"], sv, None)
    else:
        p["v"], p["o"] = _fold_v_o_gqa(p["v"], p["o"], sv, cfg)
    return p


def _reduce_to_v_layout(x: torch.Tensor, cfg: ModelConfig, nv: int) -> torch.Tensor:
    """Max-reduce a per-o-input-channel vector to v's column layout."""
    if x.shape[0] == nv:
        return x
    rep = x.shape[0] // nv
    return x.reshape(cfg.num_kv_heads, rep, cfg.head_dim_).amax(dim=1).reshape(nv)


def _fold_v_o_gqa(v_entry, o_entry, scale, cfg: ModelConfig):
    """v -> o fold when o's input is the GQA-repeated v output: v's columns
    scaled once, o's rows per repeated copy."""
    s = sanitize_scale(scale)
    wv, wo = v_entry["w"], o_entry["w"]
    nv = wv.shape[1]
    rep = wo.shape[0] // nv
    hd = cfg.head_dim_
    new_v = dict(v_entry)
    new_v["w"] = (wv / s[None, :].to(wv.dtype)).to(wv.dtype)
    if "b" in v_entry:
        new_v["b"] = (v_entry["b"] / s).to(v_entry["b"].dtype)
    s_rep = s.reshape(nv // hd, 1, hd).repeat(1, rep, 1).reshape(-1)
    new_o = dict(o_entry)
    new_o["w"] = (wo * s_rep[:, None].to(wo.dtype)).to(wo.dtype)
    return new_v, new_o


def smoothquant_model(params, cfg: ModelConfig, calib_tokens: np.ndarray, alpha: float = 0.5,
                      use_shift: Optional[bool] = None, act_stats=None, batch_size: int = 8):
    """SmoothQuant migration on every decoder layer; the result is still fp
    (`smoothquant.py:213-240`). Shifts fold by default on OPT only, as the
    reference applies them."""
    if use_shift is None:
        use_shift = cfg.arch == "opt"
    if act_stats is None:
        act_stats = collect_act_stats(params, cfg, calib_tokens, batch_size)
    with torch.no_grad():
        new_layers = [smooth_layer(_layer_slice(params["layers"], l), act_stats[l], cfg, alpha,
                                   use_shift) for l in range(cfg.num_layers)]
    out = dict(params)
    out["layers"] = _stack_layers(new_layers)
    return out
