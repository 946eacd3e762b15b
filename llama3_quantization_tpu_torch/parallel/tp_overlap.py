"""Megatron sequence-parallel TP forward with the collectives overlapped
(port of `llama3_quantization_tpu/parallel/tp_overlap.py`).

`sharding.make_sharded_forward` all-reduces after each row-parallel linear.
This forward keeps Megatron's sequence-parallel block structure instead:
activations sequence-sharded between blocks and head/feature-sharded inside
them, with both brackets as the ring collective matmuls of
`collective_matmul.py`:

    h[S/P]  --ag_matmul-->  q/k/v, gate/up (column shards, full S)
            <--rs_matmul--  o, down (row shards, reduced and re-scattered)

so every transfer rides a ring step beside the matmul of the chunk on hand.
Pre-norm RoPE archs; num_heads % tp == num_kv_heads % tp == 0, S % tp == 0.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..models.configs import ModelConfig
from ..models.transformer import (
    NO_QUANT,
    RuntimeQuantConfig,
    _layer_params,
    _norm,
    apply_rope,
    embed,
    full_attention,
    lm_head,
    rope_cos_sin,
)
from ..ops.collectives import all_gather_cat, shard_of
from ..ops.flash_attention import causal_mask
from ..ops.padding import pad_for_kernels
from ..quant.qtensor import QuantizedTensor
from .collective_matmul import ag_matmul, rs_matmul
from .mesh import axis_index, axis_size
from .sharding import P, shard_params

#: the block-entry (column) and block-exit (row) projections
_COL = ("q", "k", "v", "gate", "up")
_ROW = ("o", "down")


def tp_overlap_pspecs(params: Dict[str, Any]) -> Dict[str, Any]:
    """PartitionSpecs of the tp-overlap forward (`tp_overlap.py:46-72`):
    columns of the block-entry projections, rows of the block-exit ones,
    everything else replicated."""
    def array_spec(name, ndim):
        if name in _COL:
            return P(*([None] * (ndim - 1)), "tp")
        if name in _ROW:
            return P(*([None] * (ndim - 2)), "tp", None)
        return P(*([None] * ndim))

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        name = path[-2] if len(path) >= 2 else None
        if isinstance(tree, QuantizedTensor):
            return {f: array_spec(name, getattr(tree, f).dim())
                    for f in ("data", "scale", "zero") if getattr(tree, f) is not None}
        return array_spec(name, tree.dim())

    return walk(params)


def make_tp_overlap_forward(cfg: ModelConfig, mesh, rq: RuntimeQuantConfig = NO_QUANT):
    """`fn(params, tokens) -> logits` running the sequence-parallel TP
    schedule with ring-overlapped collectives (`tp_overlap.py:75-143`) on
    a full tree (each rank cuts its shards) or a rank-local one of `mesh`;
    every rank returns the full logits."""
    if cfg.parallel_block or not cfg.uses_rope or cfg.is_moe:
        raise NotImplementedError("tp-overlap forward supports dense pre-norm RoPE archs")
    tp = axis_size(mesh, "tp")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"head counts must divide tp={tp}")
    group = mesh.get_group("tp")
    hd = cfg.head_dim_

    def _flat(x):  # [B, S_loc, D] -> [S_loc * B, D], S-major rows
        return x.transpose(0, 1).reshape(-1, x.shape[-1])

    def _unflat(y, b):  # S-major rows -> [B, S, N]
        return y.reshape(-1, b, y.shape[-1]).transpose(0, 1)

    def fwd(params, tokens):
        local = params if shard_of(params) is not None else shard_params(params, mesh, cfg)
        my = axis_index(mesh, "tp")
        b, s = tokens.shape
        if s % tp:
            raise ValueError(f"S={s} does not split over tp={tp}")
        s_loc = s // tp
        with torch.inference_mode():
            pk = pad_for_kernels(local)
            positions = torch.arange(s, device=tokens.device)[None, :]
            h_full = embed(pk, tokens, cfg, positions)
            h = h_full[:, my * s_loc : (my + 1) * s_loc]
            cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta, h_full.dtype,
                                    cfg.rope_scaling_)
            mask = causal_mask(s, device=tokens.device)
            for i in range(cfg.num_layers):
                p = _layer_params(pk["layers"], i)
                x = _flat(_norm(p["ln1"], h, cfg))
                q = _unflat(ag_matmul(x, p["q"]["w"], group), b).reshape(b, s, -1, hd)
                k = _unflat(ag_matmul(x, p["k"]["w"], group), b).reshape(b, s, -1, hd)
                v = _unflat(ag_matmul(x, p["v"]["w"], group), b).reshape(b, s, -1, hd)
                attn = full_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, mask,
                                      cfg, rq)  # the rank's heads, full S
                h = h + _unflat(rs_matmul(_flat(attn.reshape(b, s, -1)), p["o"]["w"], group), b)
                x2 = _flat(_norm(p["ln2"], h, cfg))
                gate = _unflat(ag_matmul(x2, p["gate"]["w"], group), b)
                up = _unflat(ag_matmul(x2, p["up"]["w"], group), b)
                h = h + _unflat(rs_matmul(_flat(F.silu(gate) * up), p["down"]["w"], group), b)
            h = all_gather_cat(h.contiguous(), group, 1)  # back to the full sequence
            return lm_head(pk, _norm(pk["norm"], h, cfg), cfg)

    return fwd
