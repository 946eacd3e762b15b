"""GPipe pipeline parallelism over a `pp` mesh axis (port of
`llama3_quantization_tpu/parallel/pipeline.py`).

The stacked layers are split on their layer axis over the `pp` ranks
(`shard_params_pipeline`: each rank keeps its L / pp layers, everything else
whole), and M microbatches flow through the P stages in M + P - 1 ticks:
stage s runs microbatch t - s at tick t, receiving its [mb, S, D] input from
stage s - 1 and sending its output to stage s + 1. JAX's SPMD program runs
every stage at every tick and masks the bubbles; here a stage idles through
them, with the same result. The last stage's hidden states are broadcast to
every rank (JAX's masked psum, `pipeline.py:131-136`), which all return the
logits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.distributed as dist

from ..models.configs import ModelConfig
from ..models.transformer import (
    NO_QUANT,
    RuntimeQuantConfig,
    _layer_params,
    decoder_layer,
    embed,
    final_norm,
    lm_head,
    model_rope,
)
from ..ops.collectives import check_backend
from ..ops.flash_attention import causal_mask
from ..ops.padding import pad_for_kernels
from ..quant.qtensor import QuantizedTensor
from .mesh import axis_index, axis_size
from .sharding import P


def pipeline_pspecs(params: Dict[str, Any]) -> Dict[str, Any]:
    """PartitionSpecs for pipeline sharding (`pipeline.py:43-61`): layer
    stacks split on their leading axis over `pp`, the rest replicated."""
    def leaf(x, spec_of):
        if isinstance(x, dict):
            return {k: leaf(v, spec_of) for k, v in x.items()}
        if isinstance(x, QuantizedTensor):
            return dataclasses.replace(x, data=spec_of(x.data), scale=spec_of(x.scale),
                                       zero=None if x.zero is None else spec_of(x.zero))
        return spec_of(x)

    specs = {k: leaf(v, lambda x: P(*([None] * x.dim()))) for k, v in params.items()
             if k != "layers"}
    specs["layers"] = leaf(params["layers"], lambda x: P("pp", *([None] * (x.dim() - 1))))
    return specs


def _layer_slice(x, l0: int, l1: int):
    if isinstance(x, dict):
        return {k: _layer_slice(v, l0, l1) for k, v in x.items()}
    if isinstance(x, QuantizedTensor):
        return dataclasses.replace(
            x, data=x.data[l0:l1], scale=x.scale[l0:l1],
            zero=None if x.zero is None else x.zero[l0:l1],
            g_idx=None if x.g_idx is None else x.g_idx[l0:l1])
    return x[l0:l1]


def shard_params_pipeline(params, mesh, cfg: ModelConfig):
    """This rank's stage of `params` (`pipeline.py:64-69`): its L / pp
    consecutive layers (views), everything else the tree's own."""
    pp = axis_size(mesh, "pp")
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by pp={pp}")
    n = cfg.num_layers // pp
    stage = axis_index(mesh, "pp")
    out = dict(params)
    out["layers"] = _layer_slice(params["layers"], stage * n, (stage + 1) * n)
    return out


def make_pipeline_forward(
    cfg: ModelConfig,
    mesh,
    n_microbatches: int,
    rq: RuntimeQuantConfig = NO_QUANT,
):
    """`fn(params, tokens) -> logits` running the GPipe schedule on stage
    trees from `shard_params_pipeline` (`pipeline.py:72-150`). Requires
    num_layers % pp == 0 and batch % n_microbatches == 0."""
    pp = axis_size(mesh, "pp")
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by pp={pp}")
    group = mesh.get_group("pp")
    n_local = cfg.num_layers // pp

    def fwd(params, tokens):
        stage = axis_index(mesh, "pp")
        m = n_microbatches
        b, s = tokens.shape
        if b % m:
            raise ValueError(f"batch {b} does not split into {m} microbatches")
        mb = b // m
        with torch.inference_mode():
            params_k = pad_for_kernels(params)
            positions = torch.arange(s, device=tokens.device)[None, :]
            h = embed(params_k, tokens, cfg, positions)  # [B, S, D], every stage
            cos_sin = model_rope(positions, cfg, h.dtype)
            mask = causal_mask(s, device=tokens.device)
            outputs = torch.zeros_like(h).reshape(m, mb, s, -1)
            prev = None if stage == 0 else dist.get_global_rank(group, stage - 1)
            nxt = None if stage == pp - 1 else dist.get_global_rank(group, stage + 1)
            for t in range(m + pp - 1):
                i = t - stage  # the microbatch this stage runs at tick t
                if not 0 <= i < m:
                    continue  # a bubble
                if prev is None:
                    x = h[i * mb : (i + 1) * mb]
                else:
                    x = torch.empty((mb, s, h.shape[-1]), dtype=h.dtype, device=h.device)
                    check_backend(x, group)
                    dist.recv(x, prev, group=group)
                for j in range(n_local):
                    x = decoder_layer(_layer_params(params_k["layers"], j), x, cfg, rq, cos_sin,
                                      mask)
                if nxt is None:
                    outputs[i] = x
                else:
                    check_backend(x, group)
                    dist.send(x.contiguous(), nxt, group=group)
            if pp > 1:
                check_backend(outputs, group)
                dist.broadcast(outputs, dist.get_global_rank(group, pp - 1), group=group)
            hidden = outputs.reshape(b, s, -1)
            return lm_head(params_k, final_norm(params_k, hidden, cfg), cfg)

    return fwd
