"""Layer-streaming calibration (port of
`llama3_quantization_tpu/quant/calibration.py`).

Activations of every calibration sample are kept on the device as a list
of batches; each decoder layer is (1) run instrumented to expose the input
of each linear, (2) quantized, (3) run quantized to produce the next
layer's stream. Capture and propagation run under the "xla" backend (the
dequant route), whatever the process-wide backend, as JAX pins them; the
capture's full-sequence attention takes B7 at S >= 128 where it takes the
shape.

Every arch of `models/transformer.py`: OPT's and Falcon's `fc1`/`fc2`
(Falcon's MLP reads the shared norm's output, the same capture as q),
and Mixtral's experts, which `gptq_quantize_model` solves one expert at a
time on Hessians weighted by each token's routing weight.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.configs import ModelConfig
from ..models.params import MOE_EXPERT_LINEARS, linear_names, stack_qtensors
from ..models.transformer import (
    NO_QUANT,
    RuntimeQuantConfig,
    _moe_routing_weights,
    _norm,
    apply_rope,
    decoder_layer,
    embed,
    full_attention,
    model_rope,
    qkv_proj,
)
from ..ops.flash_attention import causal_mask
from ..ops.matmul import backend, qlinear
from .gptq import (
    HessianState,
    fake_quant_int8_per_tensor,
    gptq_quantize_weight,
    hessian_init,
    hessian_update,
    snr_error,
)
from .qtensor import QuantizedTensor
from .quantizer import QuantSpec


def _snr_row(name, layer_idx, w_fp, w_q, x, weight_error, elapsed):
    """One SNR diagnostics row: the quantized weight's output against the
    fp output on the captured inputs, with and without int8 input
    quantization."""
    from ..ops.matmul import qmatmul

    x2 = x.reshape(-1, x.shape[-1])
    y_fp = x2.float() @ w_fp.float()
    y_q = qmatmul(x2, w_q)
    y_q_in = qmatmul(fake_quant_int8_per_tensor(x2), w_q)
    return {
        "name": f"layer{layer_idx}.{name}",
        "weight_error": weight_error,
        "fp_inp_snr": snr_error(y_q, y_fp),
        "q_inp_snr": snr_error(y_q_in, y_fp),
        "time": elapsed,
    }


def layer_linear_inputs(p: Dict[str, Any], h: torch.Tensor, cfg: ModelConfig,
                        rq: RuntimeQuantConfig, cos_sin, mask) -> Dict[str, torch.Tensor]:
    """One instrumented decoder-layer forward returning the input
    activation of every linear (`calibration.py:64-121`); on Mixtral the
    experts' shared input as `experts_in` (their down inputs are derived
    per expert by the MoE GPTQ path)."""
    b, s, _ = h.shape
    out: Dict[str, torch.Tensor] = {}
    attn_in = _norm(p["ln1"], h, cfg)
    out["q"] = out["k"] = out["v"] = attn_in
    q, k, v = qkv_proj(p, attn_in, cfg, rq.act)
    if cos_sin is not None:
        cos, sin = cos_sin
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    attn = full_attention(q, k, v, mask, cfg, rq).reshape(b, s, cfg.num_heads * cfg.head_dim_)
    out["o"] = attn
    attn_out = qlinear(attn, p["o"]["w"], p["o"].get("b"), rq.act)
    if cfg.parallel_block:
        mlp_in = attn_in  # Falcon: the MLP reads the shared norm's output
    else:
        mlp_in = _norm(p["ln2"], h + attn_out, cfg)
    if cfg.is_moe:
        out["experts_in"] = mlp_in
    elif cfg.arch == "llama":
        out["gate"] = out["up"] = mlp_in
        gate = qlinear(mlp_in, p["gate"]["w"], p["gate"].get("b"), rq.act)
        up = qlinear(mlp_in, p["up"]["w"], p["up"].get("b"), rq.act)
        out["down"] = F.silu(gate) * up
    else:
        out["fc1"] = mlp_in
        fc1 = qlinear(mlp_in, p["fc1"]["w"], p["fc1"].get("b"), rq.act)
        out["fc2"] = F.relu(fc1) if cfg.activation == "relu" else F.gelu(fc1, approximate="tanh")
    return out


def capture_aliases(cfg: ModelConfig) -> Dict[str, str]:
    """Capture keys that read the same activation in `layer_linear_inputs`
    (q/k/v off attn_in; llama's gate/up off mlp_in; Falcon's fc1 off the
    shared norm): one Hessian or statistic per canonical key."""
    al = {"k": "q", "v": "q"}
    if cfg.arch == "llama" and not cfg.is_moe:
        al["up"] = "gate"
    if cfg.parallel_block:
        al["fc1"] = "q"
    return al


def _layer_slice(layers: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer `l` of the stacked layer tree (views)."""
    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, QuantizedTensor):
            return x.layer(l)
        return x[l]

    return take(layers)


def _stack_layers(layer_list: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-layer trees of one structure -> the stacked `[L, ...]` tree."""
    first = layer_list[0]
    if isinstance(first, dict):
        return {k: _stack_layers([t[k] for t in layer_list]) for k in first}
    if isinstance(first, QuantizedTensor):
        return stack_qtensors(layer_list)
    return torch.stack(layer_list)


def embed_calibration(params, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens [n, S] -> (h [n, S, D], cos_sin (None without RoPE), mask)."""
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)[None, :]
    h = embed(params, tokens, cfg, positions)
    return h, model_rope(positions, cfg, h.dtype), causal_mask(s, device=tokens.device)


def calib_tensor(params, calib_tokens) -> torch.Tensor:
    """The calibration tokens as int64 on the parameters' device."""
    return torch.as_tensor(np.asarray(calib_tokens), dtype=torch.long).to(params["embed"].device)


def run_layer_xla(p, h, cfg: ModelConfig, rq: RuntimeQuantConfig, cos_sin, mask):
    """One decoder layer under the "xla" backend (the dequant route): the
    propagation numerics of the quantizers, whatever the process-wide
    backend (`calibration.py:209-226`)."""
    with backend("xla"):
        return decoder_layer(p, h, cfg, rq, cos_sin, mask)


#: true_sequential sub-block order per arch: earlier groups are quantized
#: before the inputs of later ones are captured (Mixtral has none: all of
#: its attention linears form one group)
_TRUE_SEQ_GROUPS = {
    "llama": [("k", "v", "q"), ("o",), ("up", "gate"), ("down",)],
    "opt": [("k", "v", "q"), ("o",), ("fc1",), ("fc2",)],
    "falcon": [("k", "v", "q"), ("o",), ("fc1",), ("fc2",)],
}


@torch.no_grad()
def gptq_quantize_model(
    params,
    cfg: ModelConfig,
    calib_tokens: np.ndarray,  # [n, S]
    spec: QuantSpec,
    blocksize: int = 128,
    percdamp: float = 0.01,
    actorder: bool = False,
    pack: bool = False,
    batch_size: int = 8,
    rq: RuntimeQuantConfig = NO_QUANT,
    true_sequential: bool = False,
    progress: Optional[Callable[[int, int, Dict[str, float]], None]] = None,
    snr_log: Optional[list] = None,
):
    """Sequential GPTQ over all decoder layers (`calibration.py:149-354`):
    a new parameter tree with every decoder linear a GPTQ-quantized
    `QuantizedTensor` (embeddings, norms and lm_head untouched).
    `true_sequential` quantizes sub-blocks in dataflow order, recapturing
    inputs through the groups already quantized; `progress(l, L, errors)`
    after each layer; `snr_log` collects per-linear SNR rows
    (`gptq.format_snr_table`). Mixtral's experts are solved after the
    attention linears, each on Hessians weighted by the routing weights
    (`quantize_experts`)."""
    tokens = calib_tensor(params, calib_tokens)
    n = tokens.shape[0]
    h, cos_sin, mask = embed_calibration(params, cfg, tokens)
    h_list = [h[b0 : b0 + batch_size] for b0 in range(0, n, batch_size)]
    del h
    aliases = capture_aliases(cfg)

    def capture(p, hb):
        with backend("xla"):
            caps = layer_linear_inputs(p, hb, cfg, rq, cos_sin, mask)
        return {k: v for k, v in caps.items() if k not in aliases}

    names = linear_names(cfg)
    if true_sequential and cfg.arch in _TRUE_SEQ_GROUPS:
        groups = [g for g in (tuple(m for m in grp if m in names)
                              for grp in _TRUE_SEQ_GROUPS[cfg.arch]) if g]
    else:
        groups = [tuple(names)]

    def quantize_group(q_l, group, errs, layer):
        canon = {name: aliases.get(name, name) for name in group}
        uses: Dict[str, int] = {}
        for rep in canon.values():
            uses[rep] = uses.get(rep, 0) + 1
        hstate: Dict[str, HessianState] = {
            rep: hessian_init(q_l[rep]["w"].shape[0], device=h_list[0].device) for rep in uses
        }
        caps0 = None
        for hb in h_list:
            caps = capture(q_l, hb)
            if caps0 is None and snr_log is not None:
                caps0 = caps
            for rep in uses:
                hstate[rep] = hessian_update(hstate[rep], caps[rep])
            del caps
        for name in group:
            entry = dict(q_l[name])
            t0 = time.perf_counter()
            rep = canon[name]
            uses[rep] -= 1
            H = hstate.pop(rep).H if uses[rep] == 0 else hstate[rep].H
            qt, err = gptq_quantize_weight(entry["w"], H, spec, blocksize=blocksize,
                                           actorder=actorder, percdamp=percdamp, pack=pack)
            del H
            errs[name] = float(err)
            if snr_log is not None:
                snr_log.append(_snr_row(name, layer, entry["w"], qt, caps0[rep], float(err),
                                        time.perf_counter() - t0))
            entry["w"] = qt
            q_l[name] = entry
        return q_l

    def quantize_experts(q_l, errs):
        """Mixtral's experts (`calibration.py:281-343`): each token's share
        of expert e's Hessian is scaled by its routing weight w_e (x times
        sqrt(w_e)); gate and up share the weighted input Hessian, down takes
        the weighted Hessian of each expert's activation through its
        already-quantized gate and up."""
        from ..ops.matmul import qmatmul

        xs, wts = [], []
        for hb in h_list:
            x = capture(q_l, hb)["experts_in"]
            xs.append(x)
            wts.append(_moe_routing_weights(q_l, x, cfg))
        experts = q_l["experts"]
        solve = dict(spec=spec, blocksize=blocksize, actorder=actorder, percdamp=percdamp,
                     pack=pack)
        new_e: Dict[str, list] = {m: [] for m in MOE_EXPERT_LINEARS}
        for e in range(experts["gate"]["w"].shape[0]):
            h_in = hessian_init(xs[0].shape[-1], device=xs[0].device)
            for x, w in zip(xs, wts):
                h_in = hessian_update(h_in, x * w[..., e].sqrt()[..., None].to(x.dtype))
            qt_gate, err_g = gptq_quantize_weight(experts["gate"]["w"][e], h_in.H, **solve)
            qt_up, err_u = gptq_quantize_weight(experts["up"]["w"][e], h_in.H, **solve)
            down_w = experts["down"]["w"][e]
            h_down = hessian_init(down_w.shape[0], device=xs[0].device)
            for x, w in zip(xs, wts):
                act = F.silu(qmatmul(x, qt_gate)) * qmatmul(x, qt_up)
                h_down = hessian_update(h_down, act * w[..., e].sqrt()[..., None].to(act.dtype))
            qt_down, err_d = gptq_quantize_weight(down_w, h_down.H, **solve)
            errs[f"expert{e}"] = float(err_g + err_u + err_d)
            for m, qt in zip(MOE_EXPERT_LINEARS, (qt_gate, qt_up, qt_down)):
                new_e[m].append(qt)
        q_l["experts"] = {m: {"w": stack_qtensors(qts)} for m, qts in new_e.items()}
        return q_l

    new_layers = []
    for l in range(cfg.num_layers):
        q_l = dict(_layer_slice(params["layers"], l))
        errs: Dict[str, float] = {}
        for group in groups:
            q_l = quantize_group(q_l, group, errs, l)
        if cfg.is_moe:
            q_l = quantize_experts(q_l, errs)
        for bi in range(len(h_list)):
            h_list[bi] = run_layer_xla(q_l, h_list[bi], cfg, rq, cos_sin, mask)
        new_layers.append(q_l)
        if progress:
            progress(l + 1, cfg.num_layers, errs)

    out = dict(params)
    out["layers"] = _stack_layers(new_layers)
    return out
