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

LLAMA_LINEARS = ("q", "k", "v", "o", "gate", "up", "down")


def linear_names(cfg: ModelConfig):
    if cfg.arch != "llama":
        raise NotImplementedError(f"arch {cfg.arch!r} is not ported yet")
    return LLAMA_LINEARS


def linear_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, i, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    return {
        "q": (d, cfg.num_heads * hd),
        "k": (d, cfg.num_kv_heads * hd),
        "v": (d, cfg.num_kv_heads * hd),
        "o": (cfg.num_heads * hd, d),
        "gate": (d, i),
        "up": (d, i),
        "down": (i, d),
    }


def init_params(
    cfg: ModelConfig, generator: torch.Generator, dtype=torch.bfloat16, device="cuda"
) -> Params:
    """Random-init llama parameters: scaled-normal linears `[L, in, out]`,
    unit norms, 0.02-scaled embedding and lm_head. `generator` must live on
    `device`."""
    dev = resolve_device(device)
    d, L = cfg.hidden_size, cfg.num_layers

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return (x * std).to(dtype)

    layers: Params = {
        name: {"w": normal((L, k, n), 1.0 / math.sqrt(k))}
        for name, (k, n) in linear_shapes(cfg).items()
        if name in linear_names(cfg)
    }
    layers["ln1"] = {"w": torch.ones((L, d), dtype=dtype, device=dev)}
    layers["ln2"] = {"w": torch.ones((L, d), dtype=dtype, device=dev)}
    params: Params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "layers": layers,
        "norm": {"w": torch.ones((d,), dtype=dtype, device=dev)},
    }
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
    """RTN-quantize every decoder-layer linear, each layer independently.
    Embeddings, norms and lm_head stay full precision."""
    if not weight_spec.enabled:
        return params
    out = dict(params)
    layers = dict(params["layers"])
    for name in linear_names(cfg):
        stacked = layers[name]["w"]
        qts = [quantize_rtn(w, weight_spec, pack=pack) for w in stacked]
        layers[name] = {**layers[name], "w": stack_qtensors(qts)}
    out["layers"] = layers
    return out
