"""AWQ: activation-aware weight quantization by a per-channel scale search
(port of `llama3_quantization_tpu/quant/awq.py`): for each migration point,
grid-search the SmoothQuant exponent alpha of s = act^alpha / w^(1 - alpha)
for the least quantized-matmul output MSE on calibration activations, fold
the winning scales and RTN-quantize.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models.params import linear_names
from ..models.transformer import NO_QUANT
from .calibration import (
    _layer_slice,
    _stack_layers,
    calib_tensor,
    check_llama,
    embed_calibration,
    layer_linear_inputs,
    run_layer_xla,
)
from .qtensor import quantize_rtn
from .quantizer import QuantSpec, fake_quant_dynamic
from .smoothing import fold_norm_linears, smoothquant_scale


def awq_search_alpha(x: torch.Tensor, w_cat: torch.Tensor, spec: QuantSpec,
                     n_grid: int = 20) -> torch.Tensor:
    """The per-channel scale at the alpha of linspace(0, 1, n_grid) with the
    least mean ||(x/s) @ Q(s * W) - x @ W||^2 (`awq.py:31-58`); x [T, K]
    sampled calibration inputs, w_cat [K, N] the group's weights side by
    side."""
    xf, wf = x.float(), w_cat.float()
    act_amax = xf.abs().amax(dim=0)
    w_amax = wf.abs().amax(dim=1)
    ref = xf @ wf
    alphas = torch.linspace(0.0, 1.0, n_grid, dtype=torch.float32, device=x.device)
    losses = []
    for a in alphas:
        s = smoothquant_scale(act_amax, w_amax, a)
        wq = fake_quant_dynamic((wf * s[:, None]).T, spec).T  # per-out-channel grid
        out = (xf / s[None, :]) @ wq
        losses.append(((out - ref) ** 2).mean())
    return smoothquant_scale(act_amax, w_amax, alphas[int(torch.argmin(torch.stack(losses)))])


@torch.no_grad()
def awq_quantize_model(
    params,
    cfg: ModelConfig,
    calib_tokens: np.ndarray,
    spec: QuantSpec,
    n_grid: int = 20,
    sample_tokens: int = 512,
    batch_size: int = 8,
    pack: bool = False,
):
    """Per-layer AWQ: search and fold scales at (ln1 -> q/k/v) and (ln2 ->
    gate/up), then RTN-quantize every decoder linear; quantized-input
    propagation between layers (`awq.py:61-157`). The token sample of each
    search comes from numpy's `default_rng(0)`, as in JAX."""
    check_llama(cfg, "awq_quantize_model")
    tokens = calib_tensor(params, calib_tokens)
    n = tokens.shape[0]
    h0, cos_sin, mask = embed_calibration(params, cfg, tokens)
    h = [h0[b0 : b0 + batch_size] for b0 in range(0, n, batch_size)]
    del h0
    mlp_in = ["gate", "up"]
    rng = np.random.default_rng(0)
    new_layers: List[Dict[str, Any]] = []
    for l in range(cfg.num_layers):
        p_l = _layer_slice(params["layers"], l)
        caps = layer_linear_inputs(p_l, h[0], cfg, NO_QUANT, cos_sin, mask)

        def sample(name):
            x = caps[name].reshape(-1, caps[name].shape[-1])
            idx = rng.choice(x.shape[0], size=min(sample_tokens, x.shape[0]), replace=False)
            return x[torch.as_tensor(idx, device=x.device)]

        p = dict(p_l)
        s1 = awq_search_alpha(sample("q"), torch.cat([p[m]["w"] for m in ("q", "k", "v")], dim=1),
                              spec, n_grid)
        p["ln1"], qkv = fold_norm_linears(p["ln1"], [p["q"], p["k"], p["v"]], s1)
        p["q"], p["k"], p["v"] = qkv
        s2 = awq_search_alpha(sample(mlp_in[0]), torch.cat([p[m]["w"] for m in mlp_in], dim=1),
                              spec, n_grid)
        p["ln2"], outs = fold_norm_linears(p["ln2"], [p[m] for m in mlp_in], s2)
        for m, e in zip(mlp_in, outs):
            p[m] = e
        for name in linear_names(cfg):
            entry = dict(p[name])
            entry["w"] = quantize_rtn(entry["w"], spec, pack=pack)
            p[name] = entry
        for bi in range(len(h)):
            h[bi] = run_layer_xla(p, h[bi], cfg, NO_QUANT, cos_sin, mask)
        new_layers.append(p)
    out = dict(params)
    out["layers"] = _stack_layers(new_layers)
    return out
