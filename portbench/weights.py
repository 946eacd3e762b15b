"""Seeded model weights, made on the device and handed to both sides.

Every tensor is drawn from a `torch.Generator` of its own, seeded from a
hash of the run's seed and the tensor's place (layer, name), so a tensor
comes out the same whichever order it is asked for in. The program's tree
is built from these draws (`portbench/program.py`), and the reference
draws them again, layer by layer, once the program is gone: it never reads
a tensor the program made.

Quantized linears are raw codes `[.., K, N]` (uint8 in `[0, 2^bits)`),
group scales and integer zero points `[.., K / group, N]` (fp32): the
weight is `(code - zero) * scale`. Scales are drawn so that a weight's
standard deviation is `linear_gain / sqrt(K)`, which keeps the residual
stream finite through every layer. Embedding, head, router and norms are drawn
in fp32 and rounded to bf16, the type they are served in. The layers'
norms scale a few fixed hidden channels by `outlier_scale`, so the linears'
inputs carry the outlier channels that trained models have (LLM.int8(),
arXiv:2208.07339; SmoothQuant, arXiv:2211.10438); the linears that read
them weigh those rows 0, so the outliers set each input's range, which is
what an int8 activation loses to, and leave the outputs' size alone. The
outliers are a device of the check: they make the range of a linear's
input, which a lower precision of activations loses to, as wide as in
trained models, so that the check's int8 control reads far from the
program; a trained model's outlier features also weigh heavily in the
outputs, which these do not.

With `route_code` (a MoE), the first `num_experts` outlier channels carry
each token's route: the embedding writes a code there (`route_code` on one
expert, three quarters of it on another, 0 on the rest), no linear writes
to them, and each layer's router reads them alone, through a permutation
of the experts of its own. So each token picks its two experts in every
layer by a wide margin, on the program's side and the reference's alike,
and the picks are spread over all experts; a random router's picks lie
within rounding of a tie for some tokens in every layer, and one flip
makes the bf16 run depart from the reference by more than any lower
precision does.

This module imports nothing of the program.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Optional, Tuple

import torch

Codes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # codes, scale, zero
#: the linears that read a layer norm's output (and so its outlier channels)
NORM_FED = ("q", "k", "v", "gate", "up", "fc1")
#: the linears whose outputs are added to the residual stream
RESIDUAL_WRITERS = ("o", "down", "fc2")


def generator(seed: int, *place, device) -> torch.Generator:
    """A generator on `device` for one tensor: seeded from `seed` and its
    place, whatever other tensors were drawn before it."""
    digest = hashlib.sha256(repr((int(seed),) + tuple(place)).encode()).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest[:8], "little") >> 1)


def linear_shapes(model: dict) -> Dict[str, Tuple[int, int]]:
    """`(K, N)` of each quantized linear of a layer, by the port's names;
    a MoE layer's expert linears are `gate`, `up`, `down` (one of each per
    expert)."""
    d, i = model["hidden_size"], model["intermediate_size"]
    hd = model.get("head_dim") or d // model["num_heads"]
    shapes = {
        "q": (d, model["num_heads"] * hd),
        "k": (d, model["num_kv_heads"] * hd),
        "v": (d, model["num_kv_heads"] * hd),
        "o": (model["num_heads"] * hd, d),
    }
    if model["arch"] in ("llama", "mixtral"):
        shapes.update({"gate": (d, i), "up": (d, i), "down": (i, d)})
    else:
        shapes.update({"fc1": (d, i), "fc2": (i, d)})
    return shapes


def expert_names(model: dict) -> Tuple[str, ...]:
    """The linears of a layer held once per expert."""
    return ("gate", "up", "down") if model.get("num_experts", 0) else ()


def _code_std(bits: int) -> float:
    """RMS of `(code - zero) * u` for uniform codes, a zero of 2^(b-1) - 1
    or 2^(b-1), and u uniform in [0.5, 1.5)."""
    return math.sqrt(((4**bits - 1) / 12 + 0.25) * 13 / 12)


def quant_linear(cfg: dict, seed: int, layer: int, name: str, device) -> Codes:
    """Codes, scales and zeros of linear `name` of layer `layer`; an expert
    linear has a leading `[E]` axis."""
    model, quant = cfg["model"], cfg["quant"]
    bits, group = quant["bits"], quant["group_size"]
    k, n = linear_shapes(model)[name]
    lead = (model["num_experts"],) if name in expert_names(model) else ()
    g = generator(seed, "linear", layer, name, device=device)
    codes = torch.randint(0, 2**bits, (*lead, k, n), generator=g, dtype=torch.uint8, device=device)
    half = 2 ** (bits - 1)
    zero = torch.randint(half - 1, half + 1, (*lead, k // group, n), generator=g,
                         dtype=torch.uint8, device=device).float()
    w = cfg["weights"]
    gain = w["linear_gain"] / math.sqrt(k) / _code_std(bits)
    scale = (torch.rand((*lead, k // group, n), generator=g, device=device) + 0.5) * gain
    if name in NORM_FED and w.get("outlier_channels", 0):
        # the outlier channels' rows weigh 0: the outliers set the range of
        # the inputs, as in trained models, without growing the outputs
        rows = outlier_channels(cfg, seed, device)
        codes[..., rows, :] = zero[..., rows // group, :].to(torch.uint8)
    if name in RESIDUAL_WRITERS and w.get("route_code"):
        # no linear writes to the route code's channels: the code stays
        cols = route_channels(cfg, seed, device)
        codes[..., cols] = zero[..., cols].repeat_interleave(group, dim=-2).to(torch.uint8)
    return codes, scale, zero


def dequant(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """`(code - zero) * scale` per group along K, in fp32 (`[.., K, N]`)."""
    *lead, k, n = codes.shape
    g = scale.shape[-2]
    w = (codes.float().reshape(*lead, g, k // g, n) - zero[..., None, :]) * scale[..., None, :]
    return w.reshape(*lead, k, n)


def _bf16(g: torch.Generator, shape, std: float, device, mean: float = 0.0) -> torch.Tensor:
    x = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    return (x * std + mean).to(torch.bfloat16)


def outlier_channels(cfg: dict, seed: int, device) -> torch.Tensor:
    """The hidden channels that carry the activation outliers: the same in
    every layer, as in trained models."""
    d, n = cfg["model"]["hidden_size"], cfg["weights"].get("outlier_channels", 0)
    return torch.randperm(d, generator=generator(seed, "outliers", device=device),
                          device=device)[:n]


def route_channels(cfg: dict, seed: int, device) -> torch.Tensor:
    """The channels of the route code: the first `num_experts` outlier
    channels, channel i standing for expert i."""
    rows = outlier_channels(cfg, seed, device)
    if len(rows) < cfg["model"]["num_experts"]:
        raise ValueError("route_code needs an outlier channel for every expert")
    return rows[: cfg["model"]["num_experts"]]


def _route_embedding(cfg: dict, seed: int, embed: torch.Tensor) -> None:
    """Writes each token's route code into the embedding's route channels:
    `route_code` on one expert's, three quarters of it on another's."""
    e, value = cfg["model"]["num_experts"], cfg["weights"]["route_code"]
    g = generator(seed, "route_code", device=embed.device)
    picks = torch.rand((embed.shape[0], e), generator=g, device=embed.device).argsort(-1)[:, :2]
    code = torch.zeros((embed.shape[0], e), device=embed.device)
    code.scatter_(1, picks, torch.tensor([value, 0.75 * value], device=embed.device).expand_as(picks))
    embed[:, route_channels(cfg, seed, embed.device)] = code.to(embed.dtype)


def _route_router(cfg: dict, seed: int, layer: int, device) -> torch.Tensor:
    """A router `[d, E]` that reads the route channels alone: channel i
    gives expert `perm[i]` the logit `router_gain` times its value."""
    d, e = cfg["model"]["hidden_size"], cfg["model"]["num_experts"]
    perm = torch.randperm(e, generator=generator(seed, "route", layer, device=device),
                          device=device)
    router = torch.zeros((d, e), device=device)
    router[route_channels(cfg, seed, device), perm] = cfg["weights"]["router_gain"]
    return router.to(torch.bfloat16)


def _norm(cfg: dict, g: torch.Generator, lead, device,
          outliers: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """A norm's weight (near 1, `outlier_scale` times larger on the outlier
    channels) and, for LayerNorm archs, its bias."""
    model, w = cfg["model"], cfg["weights"]
    d = model["hidden_size"]
    weight = torch.randn((*lead, d), generator=g, dtype=torch.float32, device=device)
    weight = weight * w["norm_std"] + 1.0
    if outliers is not None and len(outliers):
        weight[..., outliers] *= w["outlier_scale"]
    out = {"w": weight.to(torch.bfloat16)}
    if model["arch"] not in ("llama", "mixtral"):
        out["b"] = _bf16(g, (*lead, d), w["norm_bias_std"], device)
    return out


def layer_fp(cfg: dict, seed: int, layer: int, device) -> Dict[str, object]:
    """The bf16 tensors of layer `layer`: its norms and, for MoE, its router
    `[d, E]`."""
    model = cfg["model"]
    g = generator(seed, "layer_fp", layer, device=device)
    hot = outlier_channels(cfg, seed, device)
    out: Dict[str, object] = {"ln1": _norm(cfg, g, (), device, hot)}
    if not model.get("parallel_block"):
        out["ln2"] = _norm(cfg, g, (), device, hot)
    if model.get("num_experts", 0) and cfg["weights"].get("route_code"):
        out["router"] = _route_router(cfg, seed, layer, device)
    elif model.get("num_experts", 0):
        d = model["hidden_size"]
        std = cfg["weights"]["router_gain"] / math.sqrt(d)
        out["router"] = _bf16(g, (d, model["num_experts"]), std, device)
    return out


def globals_fp(cfg: dict, seed: int, device) -> Dict[str, object]:
    """Embedding `[V, d]`, final norm and, untied, the head `[d, V]`, bf16."""
    model, w = cfg["model"], cfg["weights"]
    v, d = model["vocab_size"], model["hidden_size"]
    g = generator(seed, "globals", device=device)
    out: Dict[str, object] = {
        "embed": _bf16(g, (v, d), w["embed_std"], device),
        "norm": _norm(cfg, g, (), device),
    }
    if not model.get("tie_word_embeddings"):
        out["lm_head"] = _bf16(g, (d, v), w["head_std"], device)
    if model.get("num_experts", 0) and w.get("route_code"):
        _route_embedding(cfg, seed, out["embed"])
    return out
