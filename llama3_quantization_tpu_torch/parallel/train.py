"""The sharded LWC calibration training step (port of
`llama3_quantization_tpu/parallel/train.py`).

OmniQuant's learnable weight clipping (LWC) generalised to the whole model
under a mesh: the model tensor parallel over tp (a rank-local tree from
`sharding.shard_params`, whose clipping logits are the shards' own), the
calibration batch split over dp, gradients on the clipping logits only
(frozen base weights, the reference's split of the optimization variables,
`quant/omniquant.py:257-264`) averaged over dp, and AdamW with optax's
defaults. A row-parallel weight's groups run along its sharded K axis, so
each rank fake-quantizes the whole weight (its K shards gathered over tp)
under logits every tp rank holds whole, keeps its rows, and the logits'
gradients are summed over tp: the step is the unsharded model's. At S >= `FLASH_MIN_SEQ` the forward's attention goes through
`ops/flash_attention.FlashAttentionFn`, so on the card each step launches
B7.stats forward and B7.dkv + B7.dq backward, where JAX's `value_and_grad`
reaches the library kernels (`train.py:101`).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from ..models.configs import ModelConfig
from ..models.params import linear_names
from ..models.transformer import NO_QUANT, RuntimeQuantConfig, forward_local, lm_head
from ..ops.collectives import all_gather_cat, all_reduce_, local_rows, shard_of
from ..quant.quantizer import QuantSpec, fake_quant_dynamic, lwc_init
from .sharding import _LINEAR_KIND


def _row_sharded(params, name: str):
    """The `Shard` where `name` is a row-parallel weight of a tp > 1 tree."""
    shard = shard_of(params)
    if shard is None or shard.tp == 1 or _LINEAR_KIND.get(name) != "row":
        return None
    return shard


def init_model_lwc(params, cfg: ModelConfig, spec: QuantSpec):
    """Stacked LWC logits for every decoder linear (`train.py:28-39`):
    {name: {"up", "low"}}, leaves [L, N, G, 1] of the rank's columns (all
    of K's groups, also on a row-parallel weight's rank)."""
    lwc: Dict[str, Any] = {}
    for name in linear_names(cfg):
        w = params["layers"][name]["w"]  # [L, K, N]
        shard = _row_sharded(params, name)
        k = w.shape[1] * (1 if shard is None else shard.tp)
        single = lwc_init((w.shape[2], k), spec, device=w.device)
        lwc[name] = {k: v.expand((w.shape[0],) + v.shape).clone() for k, v in single.items()}
    return lwc


def apply_lwc_model(params, lwc, cfg: ModelConfig, spec: QuantSpec):
    """The tree with every stacked decoder weight fake-quantized under its
    clipping logits (`train.py:42-59`), differentiable in them."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in linear_names(cfg):
        entry = dict(layers[name])
        w = entry["w"]  # [L, K, N]
        shard = _row_sharded(params, name)
        if shard is not None:  # the whole K, for groups that cross shards
            k_loc = w.shape[1]
            w = all_gather_cat(w.contiguous(), shard.tp_group, 1)
        fq = torch.stack([
            fake_quant_dynamic(w[i].T, spec, lwc[name]["up"][i], lwc[name]["low"][i]).T.to(w.dtype)
            for i in range(w.shape[0])
        ])
        if shard is not None:
            fq = fq[:, shard.tp_rank * k_loc : (shard.tp_rank + 1) * k_loc]
        entry["w"] = fq
        layers[name] = entry
    out["layers"] = layers
    return out


def _leaves(tree) -> List[torch.Tensor]:
    return [v for k in sorted(tree) for v in
            (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _rebuild(tree, leaves):
    it = iter(leaves)

    def walk(node):
        return {k: walk(node[k]) if isinstance(node[k], dict) else next(it) for k in sorted(node)}

    return walk(tree)


class AdamW:
    """optax's `adamw(lr)` (b1 0.9, b2 0.999, eps 1e-8, weight_decay 1e-4)
    over a tree of LWC logits: `init(lwc)` gives the optimizer state, a
    `torch.optim.AdamW` over its own copies of the leaves."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, lwc) -> torch.optim.AdamW:
        leaves = [t.detach().clone().requires_grad_(True) for t in _leaves(lwc)]
        return torch.optim.AdamW(leaves, lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)


def make_lwc_train_step(
    cfg: ModelConfig,
    mesh,
    wspec: QuantSpec,
    rq: RuntimeQuantConfig = NO_QUANT,
    lr: float = 1e-2,
    seq_shard: bool = True,
):
    """Build (optimizer, train_step) (`train.py:62-105`).

    `train_step(lwc, opt_state, params, tokens) -> (lwc', opt_state', loss)`:
    next-token cross-entropy of the LWC-fake-quantized rank-local tree on
    this rank's rows of `tokens` [B, S + 1], gradients on the clipping
    logits averaged over dp, one AdamW step; `lwc'` is a new tree (`lwc` is
    left as it was) and `loss` the batch's mean, the same on every rank.
    `seq_shard` is JAX's vocab-parallel constraint on the logits; the port's
    head already gathers them, so it changes nothing."""
    del seq_shard
    opt = AdamW(lr)

    def train_step(lwc, opt_state: torch.optim.AdamW, params, tokens):
        shard = shard_of(params)
        if shard is not None and shard.mesh is not mesh:
            raise ValueError("the tree is rank-local to another mesh")
        leaves = opt_state.param_groups[0]["params"]
        with torch.no_grad():
            for dst, src in zip(leaves, _leaves(lwc)):
                if dst is not src:
                    dst.copy_(src)
        opt_state.zero_grad(set_to_none=True)
        toks = local_rows(tokens, shard)
        inputs, targets = toks[:, :-1], toks[:, 1:]
        eff = apply_lwc_model(params, _rebuild(lwc, leaves), cfg, wspec)
        logits = lm_head(eff, forward_local(eff, inputs, cfg, rq), cfg).float()
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long())
        loss.backward()
        row = [t for name in sorted(lwc) if _row_sharded(params, name) is not None
               for t in _leaves({name: lwc[name]})]
        row_ids = {id(t) for t in row}
        for t, src in zip(leaves, _leaves(lwc)):
            if id(src) in row_ids:  # whole on every tp rank: sum the rows' shares
                all_reduce_(t.grad, shard.tp_group)
        if shard is not None and toks.shape[0] != tokens.shape[0]:
            for t in leaves:
                all_reduce_(t.grad, shard.dp_group).div_(shard.dp)
            loss = all_reduce_(loss.detach().clone(), shard.dp_group) / shard.dp
        opt_state.step()
        new = _rebuild(lwc, [t.detach().clone() for t in leaves])
        return new, opt_state, loss.detach()

    return opt, train_step
