"""Synthetic quantized models (port of `llama3_quantization_tpu/models/synthetic.py`).

Builds a model whose decoder linears are random codes with random group
scales, directly on the device: the memory and compute profile of a real
quantized checkpoint without a download. Formats as in JAX: packed 4/2-bit
codes (`pack=True`), centered signed int8 containers (`pack=False`, or bits
without a nibble packing), per-column symmetric int8 (`percol_s8`, the a8
serving format), and an lm_head recoded to per-column s8 or s4 (`head_s8`,
`head_s4`). Draws come from a `torch.Generator` and do not reproduce JAX's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import resolve_device
from ..quant.pack import pack_factor
from ..quant.qtensor import QuantizedTensor
from ..quant.quantizer import QuantSpec
from ..quant.serving import recode_head_s4, recode_head_s8
from .configs import ModelConfig
from .params import Params, linear_shapes


def _uniform(gen, shape, lo: float, hi: float, dev) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32, device=dev) * (hi - lo) + lo


def _rand_qtensor(
    gen, k: int, n: int, spec: QuantSpec, layers: int, dev, pack: bool = True,
    percol_s8: bool = False,
) -> QuantizedTensor:
    if percol_s8:
        # serving-format weights: per-column symmetric int8 (quant/serving.py)
        data = torch.randint(-127, 128, (layers, k, n), generator=gen, dtype=torch.int8, device=dev)
        scale = _uniform(gen, (layers, 1, n), 0.5, 1.5, dev) * (2.0 / math.sqrt(k) / 127.0)
        return QuantizedTensor(
            data=data, scale=scale, zero=None, bits=8, group_size=None, sym=True,
            k=k, n=n, packed=False, out_dtype=torch.bfloat16,
        )
    gs = spec.group_size or k
    g = k // gs
    f = pack_factor(spec.n_bits) if pack else 1
    if f > 1:
        data = torch.randint(0, 256, (layers, k // f, n), generator=gen, dtype=torch.uint8,
                             device=dev)
        zero = torch.full((layers, g, n), float(2 ** (spec.n_bits - 1)), dtype=torch.float32,
                          device=dev)
    else:
        # unpacked storage is centered signed int8 (quant/qtensor.py)
        half = 2 ** (spec.n_bits - 1)
        data = torch.randint(-half, half, (layers, k, n), generator=gen, dtype=torch.int8,
                             device=dev)
        zero = torch.zeros((layers, g, n), dtype=torch.float32, device=dev)
    scale = _uniform(gen, (layers, g, n), 0.5, 1.5, dev) * (2.0 / math.sqrt(k) / (2**spec.n_bits))
    return QuantizedTensor(
        data=data, scale=scale, zero=zero, bits=spec.n_bits, group_size=spec.group_size,
        sym=False, k=k, n=n, packed=f > 1, out_dtype=torch.bfloat16,
    )


def init_quantized_params(
    cfg: ModelConfig,
    spec: QuantSpec,
    seed: int = 0,
    device="cuda",
    dtype=torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    pack: bool = True,
    percol_s8: bool = False,
    head_s8: bool = False,
    head_s4: bool = False,
) -> Params:
    """Random params with every decoder linear already real-quantized, built
    on `device` from `generator` (or a fresh one seeded with `seed`)."""
    dev = resolve_device(device)
    if cfg.arch != "llama":
        raise NotImplementedError(f"arch {cfg.arch!r} is not ported yet")
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed)
    d, L = cfg.hidden_size, cfg.num_layers
    layers: Params = {
        name: {"w": _rand_qtensor(gen, k, n, spec, L, dev, pack, percol_s8)}
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
        if head_s8 or head_s4:
            recode = recode_head_s4 if head_s4 else recode_head_s8
            head = torch.randn((d, cfg.vocab_size), generator=gen, dtype=torch.float32, device=dev)
            params["lm_head"] = recode(head * 0.02)
        else:
            params["lm_head"] = normal((d, cfg.vocab_size))
    return params
