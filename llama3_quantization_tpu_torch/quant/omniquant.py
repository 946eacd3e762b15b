"""OmniQuant: learnable weight clipping (LWC) and learnable equivalent
transformation (LET) block calibration (port of
`llama3_quantization_tpu/quant/omniquant.py`).

Per decoder layer, sigmoid-bounded clipping logits (and, with `let`,
smoothing scales) are trained so that the fake-quantized layer's output
matches the fp layer's output in MSE; the learned clipping is then baked
into a real-quantized weight and the quantized activations are propagated
to the next layer. Each training step differentiates through the decoder
layer: on the card its full-sequence attention runs B7 with statistics
forward and B7.dkv and B7.dq backward (`ops/flash_attention.py`), as the
TPU runs the library kernels' `custom_vjp`.

optax's two AdamW groups become one `torch.optim.AdamW` with two parameter
groups (`lwc_lr`, `let_lr`; `weight_decay`, betas (0.9, 0.999), eps 1e-8):
optax's update up to fp32 rounding. JAX's `L3Q_OMNI_PROFILE` phase timer
is not ported: time a layer from `progress` instead. Only the llama
branches are ported (ROADMAP A 4 for MoE, OPT and Falcon).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models.params import linear_names
from ..models.transformer import NO_QUANT, RuntimeQuantConfig, decoder_layer
from .calibration import (
    _layer_slice,
    _stack_layers,
    calib_tensor,
    check_llama,
    embed_calibration,
    run_layer_xla,
)
from .qtensor import quantize_rtn
from .quantizer import QuantSpec, fake_quant_dynamic, lwc_init
from .smoothing import fold_fc_fc, fold_norm_linears, sanitize_scale, smoothquant_scale
from .smoothquant import _fold_v_o_gqa


@dataclasses.dataclass(frozen=True)
class OmniConfig:
    wspec: QuantSpec = QuantSpec(n_bits=4, group_size=128, lwc=True)
    epochs: int = 5
    lwc_lr: float = 1e-2
    let: bool = False  # joint learnable-equivalent-transformation training
    let_lr: float = 5e-3
    weight_decay: float = 0.0
    batch_size: int = 2
    aug_loss: bool = False
    pack: bool = False
    #: directory of resumable per-layer aux parameters (`omni_layer_{l}.npz`)
    resume_dir: Optional[str] = None

    def __post_init__(self):
        if not self.wspec.lwc:
            object.__setattr__(self, "wspec", dataclasses.replace(self.wspec, lwc=True))


def _w_absmax(p_l, names) -> torch.Tensor:
    return torch.stack([p_l[n]["w"].float().abs().amax(dim=1) for n in names]).amax(dim=0)


def init_layer_let(p_l: Dict[str, Any], cfg: ModelConfig, act_stats=None, alpha: float = 0.5,
                   use_shift: bool = False):
    """Trainable smoothing parameters for one layer (`omniquant.py:74-141`):
    scales from the SmoothQuant formula where activation stats are given,
    else ones; shifts only with `use_shift` (never for llama)."""
    check_llama(cfg, "init_layer_let")
    d = p_l["q"]["w"].shape[0]
    dev = p_l["q"]["w"].device
    if act_stats is not None:
        qkv_scale = smoothquant_scale(act_stats["q"]["absmax"], _w_absmax(p_l, ["q", "k", "v"]),
                                      alpha)
        fc1_scale = smoothquant_scale(act_stats["gate"]["absmax"], _w_absmax(p_l, ["gate"]),
                                      alpha)
    else:
        qkv_scale = torch.ones((d,), dtype=torch.float32, device=dev)
        fc1_scale = torch.ones((d,), dtype=torch.float32, device=dev)
    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=dev)  # noqa: E731
    let = {"qkv_scale": qkv_scale.float()}
    if use_shift:
        let["qkv_shift"] = zeros()
    let["fc1_scale"] = fc1_scale.float()
    if use_shift:
        let["fc1_shift"] = zeros()
    let["out_scale"] = torch.ones((p_l["v"]["w"].shape[1],), dtype=torch.float32, device=dev)
    # q <-> k: one scale per RoPE rotation pair (dims i and i + hd/2 mix under
    # rotation), shared across heads
    let["qkt_scale"] = torch.ones((cfg.head_dim_ // 2,), dtype=torch.float32, device=dev)
    return let


def apply_let(p_l: Dict[str, Any], let, cfg: ModelConfig):
    """Differentiable fold of the LET parameters (`omniquant.py:144-225`):
    ln1 -> q/k/v, ln2 -> gate/up, v -> o, and q <-> k with the pair scales
    mirrored onto both RoPE halves and tiled over the heads."""
    check_llama(cfg, "apply_let")
    p = dict(p_l)
    p["ln1"], qkv = fold_norm_linears(p["ln1"], [p["q"], p["k"], p["v"]], let["qkv_scale"],
                                      let.get("qkv_shift"))
    p["q"], p["k"], p["v"] = qkv
    p["ln2"], outs = fold_norm_linears(p["ln2"], [p["gate"], p["up"]], let["fc1_scale"],
                                       let.get("fc1_shift"))
    p["gate"], p["up"] = outs
    nv = p["v"]["w"].shape[1]
    if p["o"]["w"].shape[0] == nv:
        p["v"], p["o"] = fold_fc_fc(p["v"], p["o"], let["out_scale"])
    else:
        p["v"], p["o"] = _fold_v_o_gqa(p["v"], p["o"], let["out_scale"], cfg)
    s_head = torch.cat([let["qkt_scale"], let["qkt_scale"]])
    sq = sanitize_scale(s_head.repeat(p["q"]["w"].shape[1] // cfg.head_dim_))
    sk = sanitize_scale(s_head.repeat(p["k"]["w"].shape[1] // cfg.head_dim_))
    q_new, k_new = dict(p["q"]), dict(p["k"])
    wq, wk = p["q"]["w"], p["k"]["w"]
    q_new["w"] = (wq / sq[None, :].to(wq.dtype)).to(wq.dtype)
    if "b" in q_new:
        q_new["b"] = (q_new["b"] / sq).to(q_new["b"].dtype)
    k_new["w"] = (wk * sk[None, :].to(wk.dtype)).to(wk.dtype)
    if "b" in k_new:
        k_new["b"] = (k_new["b"] * sk).to(k_new["b"].dtype)
    p["q"], p["k"] = q_new, k_new
    return p


def _save_aux(resume_dir: Optional[str], layer: int, aux) -> None:
    if not resume_dir:
        return
    from ..utils.pytree_io import save_pytree_npz

    os.makedirs(resume_dir, exist_ok=True)
    save_pytree_npz(os.path.join(resume_dir, f"omni_layer_{layer}.npz"), aux)


def _load_aux(resume_dir: Optional[str], layer: int, aux_like):
    if not resume_dir:
        return None
    from ..utils.pytree_io import load_pytree_npz

    path = os.path.join(resume_dir, f"omni_layer_{layer}.npz")
    if not os.path.exists(path):
        return None
    return load_pytree_npz(path, aux_like)


def init_layer_lwc(p_l: Dict[str, Any], cfg: ModelConfig, spec: QuantSpec):
    """Clipping logits (4.0: sigmoid ~ 0.98, almost no clipping) for every
    linear of one layer, in the `[N, G, 1]` layout of its `[N, K]` view."""
    check_llama(cfg, "init_layer_lwc")
    return {name: lwc_init(tuple(p_l[name]["w"].T.shape), spec, device=p_l[name]["w"].device)
            for name in linear_names(cfg)}


def apply_lwc(p_l, lwc, cfg: ModelConfig, spec: QuantSpec):
    """The layer with every linear fake-quantized under its clipping
    logits (differentiable in the logits)."""
    eff = dict(p_l)
    for name in linear_names(cfg):
        entry = dict(eff[name])
        w = entry["w"]
        entry["w"] = fake_quant_dynamic(w.T, spec, lwc[name]["up"], lwc[name]["low"]).T.to(w.dtype)
        eff[name] = entry
    return eff


def _aux_leaves(tree) -> List[torch.Tensor]:
    return [x for k in sorted(tree) for x in
            (_aux_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _aux_map(tree, fn):
    """`fn` on every leaf, visited in `_aux_leaves`' order (sorted keys)."""
    return {k: _aux_map(tree[k], fn) if isinstance(tree[k], dict) else fn(tree[k])
            for k in sorted(tree)}


def omni_loss(aux, p_l, hq_b, target_b, target2_b, cfg: ModelConfig, ocfg: OmniConfig,
              rq: RuntimeQuantConfig, cos_sin, mask) -> torch.Tensor:
    """The block loss of one training step (`omniquant.py:361-374`): MSE of
    the fake-quantized layer's output against the fp target, plus, with
    `aug_loss`, against the fp layer on the quantized stream."""
    eff = apply_let(p_l, aux["let"], cfg) if "let" in aux else p_l
    eff = apply_lwc(eff, aux["lwc"], cfg, ocfg.wspec)
    out = decoder_layer(eff, hq_b, cfg, rq, cos_sin, mask).float()
    loss = ((out - target_b.float()) ** 2).mean()
    if ocfg.aug_loss:
        loss = loss + ((out - target2_b.float()) ** 2).mean()
    return loss


def omni_loss_and_grads(aux, p_l, hq_b, target_b, target2_b, cfg, ocfg, rq, cos_sin, mask):
    """(loss, grads): one step's loss and its gradient with respect to every
    aux leaf, as a tree of aux's structure (the leaves need not require
    grad)."""
    leaves = _aux_leaves(aux)
    live = [x.detach().clone().requires_grad_(True) for x in leaves]
    it = iter(live)
    tree = _aux_map(aux, lambda _: next(it))
    with torch.enable_grad():
        loss = omni_loss(tree, p_l, hq_b, target_b, target2_b, cfg, ocfg, rq, cos_sin, mask)
        grads = torch.autograd.grad(loss, live)
    it = iter(grads)
    return loss.detach(), _aux_map(aux, lambda _: next(it))


def omniquant_model(
    params,
    cfg: ModelConfig,
    calib_tokens: np.ndarray,
    ocfg: OmniConfig = OmniConfig(),
    rq: RuntimeQuantConfig = NO_QUANT,
    progress: Optional[Callable[[int, int, float], None]] = None,
    act_stats=None,
    epoch_log: Optional[list] = None,
):
    """Blockwise LWC (and LET) calibration over all layers; returns
    real-quantized params (`omniquant.py:312-498`). `epochs=0` is RTN.

    `act_stats` (from `smoothquant.collect_act_stats` or `load_act_stats`)
    seeds the LET scales; None collects them from the calibration stream
    when `let`. An epoch whose last loss is not finite rolls the layer back
    to the last finite epoch and stops its training. With `resume_dir`,
    each layer's trained aux is written there and read back instead of
    training. `epoch_log`, where given, collects (layer, epoch, last loss)."""
    check_llama(cfg, "omniquant_model")
    tokens = calib_tensor(params, calib_tokens)
    n = tokens.shape[0]
    bs = min(ocfg.batch_size, n)
    with torch.no_grad():
        h0, cos_sin, mask = embed_calibration(params, cfg, tokens)
    h_fp = [h0[b0 : b0 + bs] for b0 in range(0, n, bs)]
    h_q = list(h_fp)
    del h0
    if ocfg.let and act_stats is None:
        from .smoothquant import collect_act_stats

        act_stats = collect_act_stats(params, cfg, calib_tokens, batch_size=max(bs, 1))
    use_shift = cfg.arch not in ("llama", "mixtral") and rq.act is not None

    new_layers = []
    for l in range(cfg.num_layers):
        p_l = _layer_slice(params["layers"], l)
        with torch.no_grad():
            # aug targets first: the fp layer on the pre-update quantized stream
            targets2 = ([decoder_layer(p_l, hb, cfg, NO_QUANT, cos_sin, mask) for hb in h_q]
                        if ocfg.aug_loss else None)
            for bi in range(len(h_fp)):
                h_fp[bi] = decoder_layer(p_l, h_fp[bi], cfg, NO_QUANT, cos_sin, mask)
        targets = h_fp
        if targets2 is None:
            targets2 = targets

        aux: Dict[str, Any] = {"lwc": init_layer_lwc(p_l, cfg, ocfg.wspec)}
        if ocfg.let:
            aux["let"] = init_layer_let(p_l, cfg, act_stats[l] if act_stats else None,
                                        use_shift=use_shift)
        last_loss = float("nan")
        resumed = _load_aux(ocfg.resume_dir, l, aux)
        if resumed is not None:
            aux = resumed
        elif ocfg.epochs > 0:
            aux = _aux_map(aux, lambda x: x.detach().clone().requires_grad_(True))
            groups = [{"params": _aux_leaves(aux["lwc"]), "lr": ocfg.lwc_lr}]
            if "let" in aux:
                groups.append({"params": _aux_leaves(aux["let"]), "lr": ocfg.let_lr})
            opt = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=ocfg.weight_decay)
            best = _aux_map(aux, lambda x: x.detach().clone())
            for epoch in range(ocfg.epochs):
                for bi in range(len(h_q)):
                    opt.zero_grad(set_to_none=True)
                    with torch.enable_grad():
                        loss = omni_loss(aux, p_l, h_q[bi], targets[bi], targets2[bi], cfg, ocfg,
                                         rq, cos_sin, mask)
                        loss.backward()
                    opt.step()
                last_loss = float(loss.detach())
                if epoch_log is not None:
                    epoch_log.append((l, epoch, last_loss))
                if not np.isfinite(last_loss):
                    with torch.no_grad():
                        for x, y in zip(_aux_leaves(aux), _aux_leaves(best)):
                            x.copy_(y)
                    break
                best = _aux_map(aux, lambda x: x.detach().clone())
            aux = _aux_map(aux, lambda x: x.detach())
            _save_aux(ocfg.resume_dir, l, aux)

        with torch.no_grad():
            q_l = dict(apply_let(p_l, aux["let"], cfg)) if ocfg.let else dict(p_l)
            lwc = aux["lwc"]
            for name in linear_names(cfg):
                entry = dict(q_l[name])
                entry["w"] = quantize_rtn(entry["w"], ocfg.wspec, pack=ocfg.pack,
                                          lwc_up=lwc[name]["up"], lwc_low=lwc[name]["low"])
                q_l[name] = entry
            for bi in range(len(h_q)):
                h_q[bi] = run_layer_xla(q_l, h_q[bi], cfg, rq, cos_sin, mask)
        new_layers.append(q_l)
        if progress:
            progress(l + 1, cfg.num_layers, last_loss)

    out = dict(params)
    out["layers"] = _stack_layers(new_layers)
    return out
