"""IR-QLoRA: information-retention NF4 quantization (ICQ) and ICE LoRA
(port of `llama3_quantization_tpu/quant/irqlora.py`).

- **ICQ** (`icq_search`): per block of 64 inside each row of `blocksize2`
  blocks, the shift tau = factor * absmax + median over a grid of `2 tau_n
  + 1` factors in +-tau_range * sigma, keeping the factor whose NF4 code
  histogram has the largest entropy (the first such factor, as
  `jnp.argmax`). JAX evaluates the whole grid at once under `vmap`; here
  the factors run one after another with the running best kept by a strict
  `>`, so that the reference's 201-point grid over a Llama-3-8B linear
  needs no `[factors, ...]` temporary.
- tau storage: dynamic-FP8 codebook codes and a per-row absmax.
- **ICE** (`ice_lora_apply`): the LoRA path with the mean and broadcast
  shortcuts scaled by `a_scale` / `b_scale`.

The rounding points are those of JAX's jitted code on the CPU, so that
`tests/test_torch_nf4_irqlora.py` can hold the two bit for bit: the
factor grid (`icq_factors`, built on the host), the multiply-adds XLA
contracts into one rounding (`fma32`: each grid point's tau inside the
search, the dequantized weight), `log2` as `log * LOG2_E`, and each
entropy's 16 terms added in halves.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
import numpy as np
import torch

from .nf4 import DYNAMIC_FP8_MAP, NF4_CODE, dequantize_codebook, fma32, quantize_to_codebook

#: `sigma` of the reference (`irqlora.py:16`): 1 / ppf of the first of
#: linspace(0.9677083, 0.5, 9)[:-1] quantiles
SIGMA = 1.0 / 1.8481308574676514


@dataclasses.dataclass
class ICQWeight:
    codes: torch.Tensor  # uint8 [n_blocks, 64] NF4 indices
    absmax: torch.Tensor  # f32 [n_blocks] per-64-block absmax (of the shifted w)
    tau_codes: torch.Tensor  # uint8 [rows2, blocksize2] FP8-map codes of tau / tau_absmax
    tau_absmax: torch.Tensor  # f32 [rows2] per-row absmax of tau
    shape: tuple = ()


def _fma32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """a * b + c rounded once to float32."""
    return np.float32(float(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))))


def icq_factors(tau_range: float, tau_n: int) -> np.ndarray:
    """`jnp.linspace(-tau_range * SIGMA, tau_range * SIGMA, 2 tau_n + 1)`
    in float32, to the bit of what JAX's jitted `icq_search` computes on
    the CPU when `tau_range` is passed (a traced argument, as
    `irqlora_quantize_model` passes it). With d = 2 tau_n, t =
    float32(tau_range) and s = float32(SIGMA), element k < d is `a * (1 - k
    * (1/d)) + k * c` with a = -t * s and c = t * (s * (1/d)), the product
    `k * c` contracted into the sum; where the grid is unrolled (d <= 32),
    element 1 contracts the other product instead. The last element is the
    grid's end t * s."""
    f32 = np.float32
    div = 2 * tau_n
    inv = f32(1) / f32(div)
    t, s = f32(tau_range), f32(SIGMA)
    start, step = f32(f32(-t) * s), f32(t * f32(s * inv))
    out = []
    for k in range(div):
        kf = f32(k)
        rest = f32(f32(1) - f32(kf * inv))
        if k == 1 and div <= 32:
            out.append(_fma32(start, rest, f32(kf * step)))
        else:
            out.append(_fma32(kf, step, f32(start * rest)))
    out.append(f32(t * s))
    return np.asarray(out, dtype=np.float32)


def _nf4_block_quant(w_blocks: torch.Tensor):
    """w_blocks [..., 64] -> (codes, absmax)."""
    absmax = w_blocks.abs().amax(dim=-1, keepdim=True)
    scaled = w_blocks / absmax.clamp(min=1e-12)
    return quantize_to_codebook(scaled, NF4_CODE), absmax[..., 0]


#: float32(1 / ln 2): XLA computes `jnp.log2(x)` as `log(x) * LOG2_E`
LOG2_E = 1.44269502


def _entropy_table(block: int, device) -> torch.Tensor:
    """-f log2 f (0 where f = 0) for every frequency f = c / block."""
    freqs = torch.arange(block + 1, dtype=torch.float32, device=device) * (1.0 / block)
    log2 = torch.log(freqs.clamp(min=1e-12)) * torch.tensor(LOG2_E, dtype=torch.float32)
    ent = -freqs * log2
    return torch.where(freqs > 0, ent, torch.zeros_like(ent))


def _block_entropy(codes: torch.Tensor) -> torch.Tensor:
    """Per-block entropy of the 16-symbol code histogram over the last axis
    (`evaluate_entropy`, irqlora.py:50-61)."""
    lead, block = codes.shape[:-1], codes.shape[-1]
    flat = codes.reshape(-1, block).long()
    counts = torch.zeros(flat.shape[0], 16, dtype=torch.long, device=codes.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    terms = _entropy_table(block, codes.device)[counts]
    while terms.shape[-1] > 1:  # XLA's order: halves added, 16 -> 8 -> 4 -> 2 -> 1
        half = terms.shape[-1] // 2
        terms = terms[:, :half] + terms[:, half:]
    return terms[:, 0].reshape(lead)


def _median(x: torch.Tensor) -> torch.Tensor:
    """`jnp.median(x, axis=-1, keepdims=True)`: the two middle order
    statistics' sum times 0.5."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2])[..., None] * 0.5


def icq_best(wb: torch.Tensor, tau0: torch.Tensor, absmax0: torch.Tensor,
             factors: torch.Tensor) -> torch.Tensor:
    """Index of the entropy-maximizing factor of every block, the first on
    ties: the running best over the factors, one at a time."""
    best_ent = torch.full(wb.shape[:-1], float("-inf"), device=wb.device)
    best = torch.zeros(wb.shape[:-1], dtype=torch.long, device=wb.device)
    for i in range(factors.shape[0]):
        codes, _ = _nf4_block_quant(wb - fma32(factors[i], absmax0, tau0))
        ent = _block_entropy(codes)
        better = ent > best_ent
        best_ent = torch.where(better, ent, best_ent)
        best.masked_fill_(better, i)
        del codes, ent, better
    return best


def icq_search(w: torch.Tensor, tau_range: float = 0.1, tau_n: int = 51,
               blocksize: int = 64, blocksize2: int = 256) -> ICQWeight:
    """Entropy-maximizing tau search (`search`, irqlora.py:63-84)."""
    shape = tuple(w.shape)
    wb = w.float().reshape(-1, blocksize2, blocksize)
    tau0 = _median(wb)
    absmax0 = (wb - tau0).abs().amax(dim=2, keepdim=True)
    factors = torch.from_numpy(icq_factors(tau_range, tau_n)).to(wb.device)
    best = icq_best(wb, tau0, absmax0, factors)
    tau = factors[best][..., None] * absmax0 + tau0  # two roundings here, as XLA's
    codes, absmax = _nf4_block_quant(wb - tau)
    tau2 = tau.abs().amax(dim=1, keepdim=True)  # [rows2, 1, 1]
    tau1 = quantize_to_codebook(tau / tau2.clamp(min=1e-12), DYNAMIC_FP8_MAP)
    return ICQWeight(
        codes=codes.reshape(-1, blocksize),
        absmax=absmax.reshape(-1),
        tau_codes=tau1.reshape(-1, blocksize2),
        tau_absmax=tau2.reshape(-1),
        shape=shape,
    )


def icq_dequantize(q: ICQWeight) -> torch.Tensor:
    """NF4 dequant plus the tau add-back (`IRQLoraLinear4bit.forward`,
    irqlora.py:131-135)."""
    vals = dequantize_codebook(q.codes, NF4_CODE)
    tau = dequantize_codebook(q.tau_codes, DYNAMIC_FP8_MAP) * q.tau_absmax[:, None]
    blocksize2, block = q.tau_codes.shape[1], q.codes.shape[1]
    w = fma32(vals.reshape(-1, blocksize2, block), q.absmax.reshape(-1, blocksize2, 1),
              tau[..., None])
    return w.reshape(q.shape)


def irqlora_quantize_model(params, cfg, tau_range: float = 0.1, tau_n: int = 100,
                           blocksize2: int = 256, progress=None):
    """Every decoder linear ICQ-NF4-quantized and dequantized once into the
    weights' dtype (`irqlora.py:116-174`: evaluation runs on the
    dequantized values, as the reference dequantizes inside every
    forward). A weight whose size is not a whole number of `blocksize2`
    blocks of 64 stays as it is (the reference skips it). One linear of one
    layer at a time; `progress(layer, n_layers)` after each layer. On
    Mixtral every expert of the `[L, E, K, N]` stacks too, after the layers'
    linears (`irqlora.py:152-172`)."""
    from ..models.params import linear_names

    out = dict(params)
    layers = dict(params["layers"])
    names = linear_names(cfg)
    stacks = {name: layers[name]["w"] for name in names}
    new = {name: [] for name in names}
    n_layers = cfg.num_layers

    def q_one(w_l):
        if w_l.numel() % (blocksize2 * 64):
            return w_l  # not whole blocks: kept fp (the reference skips it)
        q = icq_search(w_l.reshape(-1), tau_range=tau_range, tau_n=tau_n,
                       blocksize2=blocksize2)
        return icq_dequantize(dataclasses.replace(q, shape=tuple(w_l.shape))).to(w_l.dtype)

    for l in range(n_layers):
        for name in names:
            new[name].append(q_one(stacks[name][l]))
        if progress is not None:
            progress(l + 1, n_layers)
    for name in names:
        layers[name] = {**layers[name], "w": torch.stack(new[name])}
        new[name] = None
    if cfg.is_moe:
        layers["experts"] = {
            name: {**entry, "w": torch.stack([torch.stack([q_one(w) for w in ws])
                                              for ws in entry["w"]])}
            for name, entry in layers["experts"].items()}
    out["layers"] = layers
    return out


def ice_lora_apply(x: torch.Tensor, w_icq: ICQWeight, lora_a: torch.Tensor,
                   lora_b: torch.Tensor, a_scale, b_scale, scaling: float = 1.0) -> torch.Tensor:
    """Base NF4 linear plus the ICE-augmented LoRA path (irqlora.py:136-155):
    h = A(x) + a_scale * mean-pool(x -> r); out = B(h) + b_scale *
    broadcast(h -> N)."""
    w = icq_dequantize(w_icq).to(x.dtype)
    base = x @ w
    r = lora_a.shape[1]
    h = x @ lora_a + a_scale * x.reshape(*x.shape[:-1], r, -1).mean(-1)
    n = lora_b.shape[1]
    out = h @ lora_b
    ice_b = torch.repeat_interleave(h, n // r, dim=-1)
    if ice_b.shape[-1] != n:
        ice_b = torch.nn.functional.pad(ice_b, (0, n - ice_b.shape[-1]))
    return base + scaling * (out + b_scale * ice_b)
