"""Observer-driven mixed-precision GPTQ (port of
`llama3_quantization_tpu/quant/mixed.py`): quantize everything at the base
width while an `Observer` records each linear's GPTQ error, then graft the
top-k worst linears of an upgrade-width pass into the base result.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from ..models.configs import ModelConfig
from ..models.params import linear_names
from .calibration import gptq_quantize_model
from .gptq import Observer
from .quantizer import QuantSpec


def mixed_precision_gptq(
    params,
    cfg: ModelConfig,
    calib_tokens: np.ndarray,
    base_spec: QuantSpec,
    upgrade_spec: QuantSpec,
    topk: int = 4,
    **gptq_kwargs,
) -> Tuple[dict, Dict[str, float]]:
    """Returns (quantized params, {"name.layer": error} of the upgraded
    linears). Unpacked storage only: the upgraded codes are grafted into
    the same stacked int8 containers, whose dequant is bit-width agnostic."""
    if gptq_kwargs.get("pack"):
        raise ValueError(
            "mixed precision requires unpacked (int8-container) storage so "
            "upgraded codes graft into the same stacked tensor"
        )
    if upgrade_spec.group_size != base_spec.group_size:
        raise ValueError("base and upgrade specs must share group_size")
    base_zero = not (base_spec.symmetric or base_spec.disable_zero_point)
    up_zero = not (upgrade_spec.symmetric or upgrade_spec.disable_zero_point)
    if base_zero != up_zero:
        raise ValueError(
            "base and upgrade specs must agree on zero-point presence "
            "(symmetric/disable_zero_point)"
        )
    upgradable = set(linear_names(cfg))
    observer = Observer(topk=topk)
    errors: Dict[str, float] = {}

    def record(layer_idx, _total, errs):
        for name, err in errs.items():
            if name not in upgradable:
                continue
            observer.submit(name, layer_idx - 1, err)
            errors[f"{name}.{layer_idx - 1}"] = err

    base = gptq_quantize_model(params, cfg, calib_tokens, base_spec, progress=record,
                               **gptq_kwargs)
    worst = {(name, lid) for name, lid, _ in observer.items()}
    if not worst or upgrade_spec.n_bits <= base_spec.n_bits:
        return base, {}
    upgraded = gptq_quantize_model(params, cfg, calib_tokens, upgrade_spec, **gptq_kwargs)
    layers = dict(base["layers"])
    for name, lid in worst:
        entry = dict(layers[name])
        bw, uw = entry["w"], upgraded["layers"][name]["w"]
        data, scale = bw.data.clone(), bw.scale.clone()
        data[lid], scale[lid] = uw.data[lid], uw.scale[lid]
        zero = None
        if bw.zero is not None:
            zero = bw.zero.clone()
            zero[lid] = uw.zero[lid]
        entry["w"] = dataclasses.replace(bw, data=data, scale=scale, zero=zero)
        layers[name] = entry
    out = dict(base)
    out["layers"] = layers
    return out, {f"{n}.{l}": errors[f"{n}.{l}"] for n, l in worst}
