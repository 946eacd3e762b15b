"""Synthetic quantized models (port of `llama3_quantization_tpu/models/synthetic.py`).

Builds a model whose decoder linears are random packed codes with random
group scales, directly on the device: the memory and compute profile of a
real W4/W2 checkpoint without a download. Packed 4/2-bit codes only; the
`percol_s8`, `head_s8` and `head_s4` options are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import resolve_device
from ..quant.pack import pack_factor
from ..quant.qtensor import QuantizedTensor
from ..quant.quantizer import QuantSpec
from .configs import ModelConfig
from .params import Params, linear_shapes


def _rand_qtensor(gen, k: int, n: int, spec: QuantSpec, layers: int, dev) -> QuantizedTensor:
    gs = spec.group_size or k
    g = k // gs
    f = pack_factor(spec.n_bits)
    data = torch.randint(0, 256, (layers, k // f, n), generator=gen, dtype=torch.uint8, device=dev)
    zero = torch.full((layers, g, n), float(2 ** (spec.n_bits - 1)), dtype=torch.float32, device=dev)
    scale = torch.rand((layers, g, n), generator=gen, dtype=torch.float32, device=dev)
    scale = (scale + 0.5) * (2.0 / math.sqrt(k) / (2**spec.n_bits))
    return QuantizedTensor(
        data=data, scale=scale, zero=zero, bits=spec.n_bits, group_size=spec.group_size,
        sym=False, k=k, n=n, packed=True, out_dtype=torch.bfloat16,
    )


def init_quantized_params(
    cfg: ModelConfig,
    spec: QuantSpec,
    seed: int = 0,
    device="cuda",
    dtype=torch.bfloat16,
    generator: Optional[torch.Generator] = None,
) -> Params:
    """Random params with every decoder linear already packed, built on
    `device` from `generator` (or a fresh one seeded with `seed`)."""
    dev = resolve_device(device)
    if cfg.arch != "llama":
        raise NotImplementedError(f"arch {cfg.arch!r} is not ported yet")
    if pack_factor(spec.n_bits) == 1:
        raise NotImplementedError("only packed 2/4-bit synthetic weights are ported")
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed)
    d, L = cfg.hidden_size, cfg.num_layers
    layers: Params = {
        name: {"w": _rand_qtensor(gen, k, n, spec, L, dev)}
        for name, (k, n) in linear_shapes(cfg).items()
    }
    layers["ln1"] = {"w": torch.ones((L, d), dtype=dtype, device=dev)}
    layers["ln2"] = {"w": torch.ones((L, d), dtype=dtype, device=dev)}

    def normal(shape):
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (x * 0.02).to(dtype)

    params: Params = {
        "embed": normal((cfg.vocab_size, d)),
        "layers": layers,
        "norm": {"w": torch.ones((d,), dtype=dtype, device=dev)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size))
    return params
