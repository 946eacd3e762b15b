"""HQQ: calibration-free half-quadratic quantization (port of
`llama3_quantization_tpu/quant/hqq.py`).

Alternating half-quadratic splitting over

    argmin_{q, z}  || W - s (q - z) ||_p^p   (p < 1)

with an auxiliary error e, W = s (q - z) + e:

  1. q <- clamp(round(W / s + z))
  2. e <- the l_p shrinkage of the residual W - s (q - z)
  3. z <- mean over the group of q - (W - e) / s
  4. beta <- beta * kappa

The weights are stored in the port's `QuantizedTensor` through
`qtensor.from_codes`, with the continuous float zero point HQQ keeps. The
rounding points are those of JAX's jitted solver on the CPU: the scale is
`(wmax - wmin) * float32(1 / qmax)` (XLA turns the division by a constant
into that product), W / s is formed once, the residual and the threshold
are contracted multiply-adds (`nf4.fma32`), beta stays a float32
tensor, and each group's mean adds in XLA's order (`xla_group_sum`):
with a plain sum, 8-bit zeros (near 128) move by a few ulps, past the 1e-5
the parity tests allow. Only `pow` may round differently, so a zero can
move by an ulp and a code flip where it sits on a rounding tie
(`tests/test_torch_hqq.py` bounds both).

`hqq_quantize_model` quantizes one linear of one layer at a time, so that
a Llama-3-8B in float32 (32 GB) fits one 80 GB card with its result.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.configs import ModelConfig
from ..models.params import linear_names, stack_qtensors
from .nf4 import fma32
from .qtensor import QuantizedTensor, from_codes
from .quantizer import CLIPMIN, QuantSpec

#: XLA's CPU code reduces more than XLA_RUN elements in windows of XLA_RUN
#: (each added in order), then the windows' sums in order; XLA_RUN or
#: fewer in XLA_LANES strided lanes, added in halves at the end
XLA_RUN = 32
XLA_LANES = 8


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along `dim` in index order, one rounding per element."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _lane_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along `dim` in XLA_LANES lanes (element i into lane i % lanes,
    in order), then the lanes in halves."""
    n = x.shape[dim]
    if n % XLA_LANES or n < 2 * XLA_LANES:
        return _seq_sum(x, dim)
    lanes = _seq_sum(x.reshape(*x.shape[:dim], n // XLA_LANES, XLA_LANES, *x.shape[dim + 1:]),
                     dim)
    while lanes.shape[dim] > 1:
        half = lanes.shape[dim] // 2
        lanes = lanes.narrow(dim, 0, half) + lanes.narrow(dim, half, half)
    return lanes.squeeze(dim)


def xla_group_sum(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """`jnp.sum(x, axis=dim)` over a non-minor axis in the order XLA's CPU
    code adds (`XLA_RUN`, `XLA_LANES`)."""
    n = x.shape[dim]
    if n <= XLA_RUN or n % XLA_RUN:
        return _lane_sum(x, dim)
    runs = _seq_sum(x.reshape(*x.shape[:dim], n // XLA_RUN, XLA_RUN, *x.shape[dim + 1:]), dim + 1)
    return _seq_sum(runs, dim) if runs.shape[dim] <= XLA_RUN else xla_group_sum(runs, dim)


def _shrink_lp(x: torch.Tensor, inv_beta: torch.Tensor, p: float) -> torch.Tensor:
    """Generalized soft threshold of the l_p (p < 1) proximal step, the hqq
    package's `shrink_lp_op`: threshold (1/beta) |x|^(p-1)."""
    mag = x.abs()
    power = torch.pow(mag.clamp(min=1e-8), _f32(p - 1.0, x.device))
    thresh = fma32(-inv_beta, power, mag).clamp(min=0.0)
    return torch.sign(x) * thresh


def hqq_solve(w: torch.Tensor, n_bits: int, group_size: int, iters: int = 20, p: float = 0.7,
              beta0: float = 10.0, kappa: float = 1.01
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`hqq.py:44-86`: (codes uint8 [K, N], scale [G, N], zero [G, N]). The
    zero point starts rounded and is then optimized continuously."""
    k, n = w.shape
    gs = group_size or k
    qmax = 2**n_bits - 1
    dev = w.device
    wg = w.float().reshape(k // gs, gs, n)
    wmin = wg.amin(dim=1, keepdim=True)
    wmax = wg.amax(dim=1, keepdim=True)
    scale = ((wmax - wmin) * _f32(1.0 / qmax, dev)).clamp(min=CLIPMIN)
    zero = torch.round(-wmin / scale)
    ws = wg / scale
    beta, kappa_t = _f32(beta0, dev), _f32(kappa, dev)
    inv_gs = _f32(1.0 / gs, dev)
    for _ in range(iters):
        q = torch.round(ws + zero).clamp(0, qmax)
        r = fma32(-scale, q - zero, wg)
        e = _shrink_lp(r, _f32(1.0, dev) / beta, p)
        zero = xla_group_sum(q - (wg - e) / scale, dim=1)[:, None, :] * inv_gs
        beta = beta * kappa_t
        del q, r, e
    q = torch.round(ws + zero).clamp(0, qmax)
    return q.reshape(k, n).to(torch.uint8), scale[:, 0, :], zero[:, 0, :]


def hqq_quantize_weight(w: torch.Tensor, spec: QuantSpec, iters: int = 20, p: float = 0.7,
                        pack: bool = False) -> QuantizedTensor:
    """One `[K, N]` weight (`hqq.py:89-103`)."""
    gs = spec.group_size or w.shape[0]
    if w.shape[0] % gs:
        raise ValueError(f"K={w.shape[0]} not divisible by group_size={gs}")
    codes, scale, zero = hqq_solve(w, spec.n_bits, gs, iters=iters, p=p)
    return from_codes(codes, scale, zero, spec, pack=pack,
                      out_dtype=w.dtype if w.dtype.is_floating_point else torch.bfloat16)


def hqq_quantize_model(params, cfg: ModelConfig, spec: QuantSpec, iters: int = 20,
                       p: float = 0.7, pack: bool = False):
    """Calibration-free HQQ over every decoder linear and, on Mixtral, every
    expert of the `[L, E, K, N]` stacks (`hqq.py:106-135`), one linear of
    one layer at a time."""
    out = dict(params)
    layers = dict(params["layers"])
    names = linear_names(cfg)
    per_layer = {name: [] for name in names}
    for l in range(cfg.num_layers):
        for name in names:
            per_layer[name].append(
                hqq_quantize_weight(layers[name]["w"][l], spec, iters=iters, p=p, pack=pack))
    for name in names:
        layers[name] = {**layers[name], "w": stack_qtensors(per_layer[name])}
        per_layer[name] = None
    if cfg.is_moe:
        layers["experts"] = {
            name: {**entry, "w": stack_qtensors([
                stack_qtensors([hqq_quantize_weight(w, spec, iters=iters, p=p, pack=pack)
                                for w in ws]) for ws in entry["w"]])}
            for name, entry in layers["experts"].items()}
    out["layers"] = layers
    return out
