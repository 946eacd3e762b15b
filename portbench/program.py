"""The system under test: the port's parameter tree, built from the seeded
draws of `portbench/weights.py` through the port's own constructors.

Each linear's codes go through `quant.qtensor.from_codes` (packed, as the
configuration states), one layer (and expert) at a time, into stacks
allocated once, so the full-precision weights never exist whole. Then
`pad_for_kernels`, as the port's PPL loop and engine prepare a tree.
"""

from __future__ import annotations

import dataclasses

import torch

from llama3_quantization_tpu_torch.models.configs import ModelConfig
from llama3_quantization_tpu_torch.models.transformer import NO_QUANT, RuntimeQuantConfig
from llama3_quantization_tpu_torch.ops.padding import pad_for_kernels
from llama3_quantization_tpu_torch.quant.qtensor import from_codes
from llama3_quantization_tpu_torch.quant.quantizer import QuantSpec

from . import weights as W


#: the check's control: the port's own int8-activation path, its `act` hook
#: quantizing every linear's input per token (the configuration's is bf16)
CONTROL = RuntimeQuantConfig(act=QuantSpec(n_bits=8))


def runtime_quant(control: bool) -> RuntimeQuantConfig:
    return CONTROL if control else NO_QUANT


def model_config(cfg: dict) -> ModelConfig:
    """The port's `ModelConfig` from a configuration file's `model` object."""
    return ModelConfig(**cfg["model"])


def _stack(first, lead) -> object:
    """An empty layer-stacked copy of one `from_codes` result."""
    def alloc(t):
        return torch.empty((*lead, *t.shape), dtype=t.dtype, device=t.device)

    return dataclasses.replace(first, data=alloc(first.data), scale=alloc(first.scale),
                               zero=alloc(first.zero))


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def build_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The port's tree of the configuration, from `seed`, on `device`, its
    activations in `dtype` (the configuration's bf16; the tests' fp32)."""
    model = cfg["model"]
    spec = QuantSpec(n_bits=cfg["quant"]["bits"], group_size=cfg["quant"]["group_size"])
    n_layers = model["num_layers"]
    experts = W.expert_names(model)
    stacks: dict = {}
    fp_layers = []
    for layer in range(n_layers):
        for name in W.linear_shapes(model):
            codes, scale, zero = W.quant_linear(cfg, seed, layer, name, device)
            parts = ([(e,) for e in range(codes.shape[0])] if name in experts else [()])
            for idx in parts:
                qt = from_codes(codes[idx], scale[idx], zero[idx], spec, pack=True,
                                out_dtype=dtype)
                if name not in stacks:
                    lead = (n_layers, codes.shape[0]) if name in experts else (n_layers,)
                    stacks[name] = _stack(qt, lead)
                dst = stacks[name]
                for field in ("data", "scale", "zero"):
                    getattr(dst, field)[(layer, *idx)].copy_(getattr(qt, field))
            del codes, scale, zero
        fp_layers.append(_cast(W.layer_fp(cfg, seed, layer, device), dtype))
    layers: dict = {name: {"w": qt} for name, qt in stacks.items() if name not in experts}
    if experts:
        layers["experts"] = {name: {"w": stacks[name]} for name in experts}
        layers["router"] = {"w": torch.stack([f["router"] for f in fp_layers])}
    for norm in ("ln1", "ln2"):
        if norm in fp_layers[0]:
            layers[norm] = {key: torch.stack([f[norm][key] for f in fp_layers])
                            for key in fp_layers[0][norm]}
    params = dict(_cast(W.globals_fp(cfg, seed, device), dtype), layers=layers)
    return pad_for_kernels(params)
