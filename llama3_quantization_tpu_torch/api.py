"""Top-level convenience API (port of `llama3_quantization_tpu/api.py`):
one entry point over the quantization algorithms.

`quantize` keeps JAX's signature, checks and dispatch (`api.py:61-111`):
RTN, GPTQ, AWQ, SmoothQuant (+ RTN), OmniQuant and observer-driven mixed
precision. HQQ and IR-QLoRA raise `NotImplementedError` until the next
quantizer slice (ROADMAP A 3).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Optional

import numpy as np

from .models.configs import ModelConfig
from .quant.quantizer import QuantSpec

METHODS = ("rtn", "gptq", "awq", "smoothquant", "hqq", "omniquant", "irqlora", "mixed")


def quantize(
    params,
    cfg: ModelConfig,
    method: str = "rtn",
    spec: Optional[QuantSpec] = None,
    calib_tokens: Optional[np.ndarray] = None,
    pack: bool = True,
    **kwargs: Any,
):
    """Quantize a model's decoder linears with the chosen algorithm
    (`api.py:20-115`). calib_tokens [n, S] is required for
    gptq/awq/smoothquant/omniquant/mixed; extra kwargs flow to the
    algorithm."""
    spec = spec or QuantSpec(n_bits=4, group_size=128)
    needs_calib = method in ("gptq", "awq", "smoothquant", "omniquant", "mixed")
    if needs_calib and calib_tokens is None:
        raise ValueError(f"method {method!r} requires calib_tokens")
    if method == "rtn":
        from .models.params import quantize_model_rtn

        return quantize_model_rtn(params, cfg, spec, pack=pack)
    if method == "gptq":
        from .quant.calibration import gptq_quantize_model

        return gptq_quantize_model(params, cfg, calib_tokens, spec, pack=pack, **kwargs)
    if method == "awq":
        from .quant.awq import awq_quantize_model

        return awq_quantize_model(params, cfg, calib_tokens, spec, pack=pack, **kwargs)
    if method == "smoothquant":
        from .models.params import quantize_model_rtn
        from .quant.smoothquant import smoothquant_model

        smoothed = smoothquant_model(params, cfg, calib_tokens, **kwargs)
        return quantize_model_rtn(smoothed, cfg, spec, pack=pack)
    if method == "omniquant":
        from .quant.omniquant import OmniConfig, omniquant_model

        ocfg = OmniConfig(wspec=dataclasses.replace(spec, lwc=True), pack=pack, **kwargs)
        return omniquant_model(params, cfg, calib_tokens, ocfg)
    if method == "mixed":
        from .quant.mixed import mixed_precision_gptq

        upgrade = kwargs.pop("upgrade_spec", None) or dataclasses.replace(spec, n_bits=8)
        out, upgraded = mixed_precision_gptq(params, cfg, calib_tokens, spec, upgrade, **kwargs)
        if upgraded:
            print(f"[mixed] upgraded: {sorted(upgraded)}", file=sys.stderr)
        return out
    if method in ("hqq", "irqlora"):
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP A 3: HQQ, NF4 and IR-QLoRA are the "
            "next quantizer slice)"
        )
    raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
