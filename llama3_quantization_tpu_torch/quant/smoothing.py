"""Scale/shift migration algebra for SmoothQuant, AWQ and OmniQuant's LET
(port of `llama3_quantization_tpu/quant/smoothing.py`).

A per-channel scale s (and shift) moves across an algebraically neutral
boundary so that activation outliers shrink while the weights take the
range:

    norm(x) @ W  ==  (norm(x)/s) @ (s * W)            (norm -> linears)
    (x @ Wv) @ Wo ==  (x @ Wv/s) @ (s * Wo)           (v_proj -> o_proj)
    (q * s)(k / s)^T == q k^T                          (q_proj <-> k_proj)

Weights are `[K, N]`, so a per-input-channel scale broadcasts as
`scale[:, None]` and a per-output-channel one as `scale[None, :]`. Every
function is pure and differentiable (the scale passes a straight-through
clamp).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .quantizer import clamp_ste

SCALE_MIN = 1e-5
SCALE_MAX = 1e4


def sanitize_scale(s: torch.Tensor) -> torch.Tensor:
    """STE-clamped positive scale (the gradient passes the clamp)."""
    return clamp_ste(s.abs(), SCALE_MIN, SCALE_MAX)


def fold_norm_linears(
    norm: Dict[str, torch.Tensor],
    linears: List[Dict[str, torch.Tensor]],
    scale: torch.Tensor,  # [K]
    shift: Optional[torch.Tensor] = None,  # [K]
) -> Tuple[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]]]:
    """Migrate (scale, shift) from a norm into the linears it feeds:
    norm' = w / s (bias' = (b - shift) / s); W' = s * W, b' = b + shift @ W.
    A shift folded into a bias-free norm creates its bias."""
    s = sanitize_scale(scale)
    wdt = norm["w"].dtype
    new_norm = dict(norm)
    new_norm["w"] = (norm["w"] / s).to(wdt)
    if "b" in norm or shift is not None:
        b = norm.get("b", torch.zeros_like(norm["w"]))
        if shift is not None:
            b = b - shift
        new_norm["b"] = (b / s).to(wdt)
    new_linears = []
    for lin in linears:
        w = lin["w"]
        nl = dict(lin)
        nl["w"] = (w * s[:, None].to(w.dtype)).to(w.dtype)
        if shift is not None:
            delta = (shift.float() @ w.float()).to(w.dtype)
            nl["b"] = (lin["b"] + delta if "b" in lin else delta).to(w.dtype)
        new_linears.append(nl)
    return new_norm, new_linears


def fold_fc_fc(
    fc1: Dict[str, torch.Tensor],  # producer: out channels scaled down
    fc2: Dict[str, torch.Tensor],  # consumer: in channels scaled up
    scale: torch.Tensor,  # [N1] == [K2]
    shift: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Migrate a scale between two chained linears (v_proj -> o_proj)."""
    s = sanitize_scale(scale)
    w1, w2 = fc1["w"], fc2["w"]
    n1 = dict(fc1)
    n1["w"] = (w1 / s[None, :].to(w1.dtype)).to(w1.dtype)
    if "b" in fc1 or shift is not None:
        b1 = fc1.get("b", torch.zeros(w1.shape[1], dtype=w1.dtype, device=w1.device))
        if shift is not None:
            b1 = b1 - shift
        n1["b"] = (b1 / s).to(w1.dtype)
    n2 = dict(fc2)
    n2["w"] = (w2 * s[:, None].to(w2.dtype)).to(w2.dtype)
    if shift is not None:
        delta = (shift.float() @ w2.float()).to(w2.dtype)
        n2["b"] = (fc2["b"] + delta if "b" in fc2 else delta).to(w2.dtype)
    return n1, n2


def fold_q_k(
    q: Dict[str, torch.Tensor],
    k: Dict[str, torch.Tensor],
    scale: torch.Tensor,  # [Nq]
    head_dim: Optional[int] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Migrate a per-output-channel scale between q_proj and k_proj; with
    GQA the k scale is the per-kv-head mean of the q scale (`_gqa_reduce`,
    exact only for head-shared scales)."""
    s = sanitize_scale(scale)
    nq = dict(q)
    nq["w"] = (q["w"] / s[None, :].to(q["w"].dtype)).to(q["w"].dtype)
    if "b" in q:
        nq["b"] = (q["b"] / s).to(q["b"].dtype)
    nk = dict(k)
    if k["w"].shape[1] == q["w"].shape[1]:
        sk = s
    else:
        if head_dim is None:
            raise ValueError("GQA fold_q_k needs head_dim to regroup columns")
        sk = _gqa_reduce(s, k["w"].shape[1], head_dim)
    nk["w"] = (k["w"] * sk[None, :].to(k["w"].dtype)).to(k["w"].dtype)
    if "b" in k:
        nk["b"] = (k["b"] * sk).to(k["b"].dtype)
    return nq, nk


def _gqa_reduce(s: torch.Tensor, nk: int, head_dim: int) -> torch.Tensor:
    """A per-q-column scale [H * hd] reduced to the kv columns [Hkv * hd]
    by averaging the q heads of each kv head (head-major columns)."""
    rep = s.shape[0] // nk
    if rep == 1:
        return s
    n_kv = nk // head_dim
    return s.reshape(n_kv, rep, head_dim).mean(dim=1).reshape(nk)


def smoothquant_scale(act_absmax: torch.Tensor, w_absmax: torch.Tensor,
                      alpha: float = 0.5) -> torch.Tensor:
    """The SmoothQuant migration strength s = act^alpha / w^(1 - alpha)."""
    a = act_absmax.float().clamp(min=SCALE_MIN)
    w = w_absmax.float().clamp(min=SCALE_MIN)
    return ((a**alpha) / (w ** (1 - alpha))).clamp(SCALE_MIN, SCALE_MAX)


def fold_norm_moe(norm, router, experts, scale, shift=None):
    """Migrate a per-channel scale from the pre-MoE norm into the router and
    every expert's gate/up (`fold_norm_linears` on the stacked `[E, K, N]`
    experts, `smoothing.py:150-175`). Scale-only: Mixtral's router and
    experts have no bias for a shift to fold into."""
    if shift is not None:
        raise ValueError("MoE norm fold is scale-only (experts have no bias)")
    s = sanitize_scale(scale)
    new_norm = dict(norm)
    new_norm["w"] = (norm["w"] / s).to(norm["w"].dtype)
    if "b" in norm:
        new_norm["b"] = (norm["b"] / s).to(norm["b"].dtype)
    new_router = dict(router)
    new_router["w"] = (router["w"] * s[:, None].to(router["w"].dtype)).to(router["w"].dtype)
    new_experts = dict(experts)
    for name in ("gate", "up"):
        entry = dict(new_experts[name])
        w = entry["w"]  # [E, K, N]
        entry["w"] = (w * s[None, :, None].to(w.dtype)).to(w.dtype)
        new_experts[name] = entry
    return new_norm, new_router, new_experts
