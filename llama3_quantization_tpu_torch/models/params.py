"""Parameter trees (port of `llama3_quantization_tpu/models/params.py`).

Parameters are nested dicts with the JAX package's layout: decoder-layer
tensors are stacked `[L, ...]`, every linear weight is stored `[in, out]`
(a tensor or a layer-stacked `QuantizedTensor`), norms are `{"w": ...}`.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..device import resolve_device
from ..quant.qtensor import QuantizedTensor, quantize_rtn
from ..quant.quantizer import QuantSpec
from .configs import ModelConfig

Params = Dict[str, Any]

#: linear names per arch, in the canonical traversal order (`params.py:22-33`)
LLAMA_LINEARS = ("q", "k", "v", "o", "gate", "up", "down")
OPT_LINEARS = ("q", "k", "v", "o", "fc1", "fc2")
MOE_ATTN_LINEARS = ("q", "k", "v", "o")  # the experts are handled apart
MOE_EXPERT_LINEARS = ("gate", "up", "down")


def linear_names(cfg: ModelConfig):
    """The decoder linears of a layer: llama's seven, OPT's and Falcon's
    six, a Mixtral layer's four attention linears (its experts are
    `layers["experts"]`, `MOE_EXPERT_LINEARS`)."""
    if cfg.is_moe:
        return MOE_ATTN_LINEARS
    return LLAMA_LINEARS if cfg.arch == "llama" else OPT_LINEARS


def linear_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """`(in, out)` of each name of `linear_names(cfg)`, and of the MoE
    expert linears under `gate`, `up` and `down` where `cfg.is_moe`."""
    d, i, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    shapes = {
        "q": (d, cfg.num_heads * hd),
        "k": (d, cfg.num_kv_heads * hd),
        "v": (d, cfg.num_kv_heads * hd),
        "o": (cfg.num_heads * hd, d),
    }
    if cfg.arch == "llama" or cfg.is_moe:
        shapes.update({"gate": (d, i), "up": (d, i), "down": (i, d)})
    else:
        shapes.update({"fc1": (d, i), "fc2": (i, d)})
    return shapes


def norm_params(cfg: ModelConfig, lead: tuple, dtype, dev) -> Params:
    """A norm's parameters: unit weight, and a zero bias for LayerNorm."""
    d = cfg.hidden_size
    out = {"w": torch.ones((*lead, d), dtype=dtype, device=dev)}
    if not cfg.rms_norms:
        out["b"] = torch.zeros((*lead, d), dtype=dtype, device=dev)
    return out


def init_params(
    cfg: ModelConfig, generator: torch.Generator, dtype=torch.bfloat16, device="cuda"
) -> Params:
    """Random-init parameters in JAX's tree (`params.py:36-128`):
    scaled-normal linears `[L, in, out]` (zero biases on OPT's), unit norms
    (zero-bias LayerNorms on OPT and Falcon; no `ln2` under a parallel
    block), 0.02-scaled embedding, lm_head and OPT's learned positions
    `[max_position_embeddings + 2, d]`; Mixtral's fp router `[L, d, E]` and
    expert stacks `[L, E, in, out]`. `generator` must live on `device`;
    its draws are not JAX's."""
    dev = resolve_device(device)
    d, L = cfg.hidden_size, cfg.num_layers

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return (x * std).to(dtype)

    shapes = linear_shapes(cfg)
    layers: Params = {}
    for name in linear_names(cfg):
        k, n = shapes[name]
        layers[name] = {"w": normal((L, k, n), 1.0 / math.sqrt(k))}
        if cfg.arch == "opt":  # OPT's linears carry biases
            layers[name]["b"] = torch.zeros((L, n), dtype=dtype, device=dev)
    if cfg.is_moe:
        e = cfg.num_experts
        layers["router"] = {"w": normal((L, d, e), 1.0 / math.sqrt(d))}
        layers["experts"] = {
            name: {"w": normal((L, e, *shapes[name]), 1.0 / math.sqrt(shapes[name][0]))}
            for name in MOE_EXPERT_LINEARS
        }
    layers["ln1"] = norm_params(cfg, (L,), dtype, dev)
    if not cfg.parallel_block:  # Falcon's parallel block has one shared norm
        layers["ln2"] = norm_params(cfg, (L,), dtype, dev)
    params: Params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "layers": layers,
        "norm": norm_params(cfg, (), dtype, dev),
    }
    if cfg.arch == "opt":
        params["pos_embed"] = normal((cfg.max_position_embeddings + 2, d), 0.02)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), 0.02)
    return params


def stack_qtensors(qts) -> QuantizedTensor:
    """Stack per-layer QuantizedTensors of one shape into `[L, ...]` fields."""
    first = qts[0]
    return QuantizedTensor(
        data=torch.stack([q.data for q in qts]),
        scale=torch.stack([q.scale for q in qts]),
        zero=None if first.zero is None else torch.stack([q.zero for q in qts]),
        bits=first.bits,
        group_size=first.group_size,
        sym=first.sym,
        k=first.k,
        n=first.n,
        packed=first.packed,
        out_dtype=first.out_dtype,
        g_idx=None if first.g_idx is None else torch.stack([q.g_idx for q in qts]),
    )


def quantize_model_rtn(
    params: Params, cfg: ModelConfig, weight_spec: QuantSpec, pack: bool = False
) -> Params:
    """RTN-quantize every decoder-layer linear, each layer independently,
    and on Mixtral each expert of each layer (the router stays fp).
    Embeddings, norms and lm_head stay full precision."""
    if not weight_spec.enabled:
        return params
    out = dict(params)
    layers = dict(params["layers"])
    for name in linear_names(cfg):
        qts = [quantize_rtn(w, weight_spec, pack=pack) for w in layers[name]["w"]]
        layers[name] = {**layers[name], "w": stack_qtensors(qts)}
    if cfg.is_moe:
        experts = dict(layers["experts"])
        for name in MOE_EXPERT_LINEARS:
            per_layer = [stack_qtensors([quantize_rtn(w, weight_spec, pack=pack) for w in ws])
                         for ws in experts[name]["w"]]
            experts[name] = {**experts[name], "w": stack_qtensors(per_layer)}
        layers["experts"] = experts
    out["layers"] = layers
    return out
