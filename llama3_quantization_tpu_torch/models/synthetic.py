"""Synthetic quantized models (port of `llama3_quantization_tpu/models/synthetic.py`).

Builds a model whose decoder linears are random codes with random group
scales, directly on the device: the memory and compute profile of a real
quantized checkpoint without a download. Formats as in JAX: packed 4/2-bit
codes (`pack=True`), centered signed int8 containers (`pack=False`, or bits
without a nibble packing), per-column symmetric int8 (`percol_s8`, the a8
serving format), and an lm_head recoded to per-column s8 or s4 (`head_s8`,
`head_s4`). Draws come from a `torch.Generator` and do not reproduce JAX's.

Every arch gets JAX's tree (`synthetic.py:93-136`): llama's SwiGLU
linears, and for every other arch OPT's `fc1`/`fc2` with LayerNorms
(weights and biases; no `ln2` under a parallel block), biases on OPT's
linears and its learned positions. So a Mixtral config gets `fc1`/`fc2`
and no router or experts, a tree that `forward_logits` cannot run, in
JAX as here (a quirk mirrored, not fixed: build a real Mixtral with
`init_params` and `quantize_model_rtn`).
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
from .params import Params


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
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed)
    d, i, hd, L = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_, cfg.num_layers
    shapes = {
        "q": (d, cfg.num_heads * hd),
        "k": (d, cfg.num_kv_heads * hd),
        "v": (d, cfg.num_kv_heads * hd),
        "o": (cfg.num_heads * hd, d),
    }
    if cfg.arch == "llama":
        shapes.update({"gate": (d, i), "up": (d, i), "down": (i, d)})
    else:
        shapes.update({"fc1": (d, i), "fc2": (i, d)})
    layers: Params = {}
    for name, (k, n) in shapes.items():
        layers[name] = {"w": _rand_qtensor(gen, k, n, spec, L, dev, pack, percol_s8)}
        if cfg.arch == "opt":
            layers[name]["b"] = torch.zeros((L, n), dtype=dtype, device=dev)

    def norm(lead):
        out = {"w": torch.ones((*lead, d), dtype=dtype, device=dev)}
        if cfg.arch != "llama":
            out["b"] = torch.zeros((*lead, d), dtype=dtype, device=dev)
        return out

    layers["ln1"] = norm((L,))
    if not cfg.parallel_block:
        layers["ln2"] = norm((L,))

    def normal(shape):
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (x * 0.02).to(dtype)

    params: Params = {
        "embed": normal((cfg.vocab_size, d)),
        "layers": layers,
        "norm": norm(()),
    }
    if cfg.arch == "opt":
        params["pos_embed"] = normal((cfg.max_position_embeddings + 2, d))
    if not cfg.tie_word_embeddings:
        if head_s8 or head_s4:
            recode = recode_head_s4 if head_s4 else recode_head_s8
            head = torch.randn((d, cfg.vocab_size), generator=gen, dtype=torch.float32, device=dev)
            params["lm_head"] = recode(head * 0.02)
        else:
            params["lm_head"] = normal((d, cfg.vocab_size))
    return params
