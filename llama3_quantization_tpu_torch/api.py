"""Top-level convenience API (port of `llama3_quantization_tpu/api.py`):
one entry point over the quantization algorithms.

`quantize` keeps JAX's signature and checks. The port has RTN so far
(`models/params.quantize_model_rtn`); every other method raises
`NotImplementedError` until the quantizers are ported (ROADMAP A 3).
"""

from __future__ import annotations

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
    if method in METHODS:
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP A 3, the quantizers); "
            "the port has 'rtn'"
        )
    raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
