"""GPTQ: Hessian-based weight quantization (port of
`llama3_quantization_tpu/quant/gptq.py`).

Streaming Hessian accumulation `H = 2/n sum x x^T`, a damped inverse
Cholesky factor, and the block-wise column-by-column solve with error
feedback `W -= err * Hinv_row`, per-group scale/zero re-estimation from
the columns as the block found them, and the optional activation-order
permutation with its column -> group map (`g_idx`). The solve is
sequential by nature: a Python loop over columns inside each block (JAX's
inner `fori_loop`) and one matmul per block for the trailing columns.

The grid finder follows GPTQ-for-LLaMa's `Quantizer.find_params` (min
clamped to <= 0, max to >= 0, an all-zero row mapped to [-1, 1], the
symmetric grid centred), not `quantizer.py`'s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops.kvcache import true_div
from .qtensor import QuantizedTensor, from_codes
from .quantizer import QuantSpec


class Observer:
    """Top-k worst-quantized-layer tracker: layers ranked by GPTQ proxy
    error, candidates for precision upgrades (`gptq.py:36-60`)."""

    def __init__(self, topk: int = 32):
        self.loss_list: list = []
        self.topk = topk

    def submit(self, name: str, layerid: int, error: float) -> None:
        item = (name, layerid, error)
        if len(self.loss_list) < self.topk:
            self.loss_list.append(item)
            return
        min_idx = min(range(len(self.loss_list)), key=lambda i: self.loss_list[i][2])
        if error > self.loss_list[min_idx][2]:
            self.loss_list[min_idx] = item

    def items(self):
        return sorted(self.loss_list, key=lambda s: s[2], reverse=True)

    def table(self) -> str:
        rows = ["| layer | error |", "|---|---|"]
        rows += [f"| {n}.{l} | {e:.4f} |" for n, l, e in self.items()]
        return "\n".join(rows)


def snr_error(y_hat: torch.Tensor, y: torch.Tensor) -> float:
    """Noise-to-signal power ratio, averaged over rows. Lower is better."""
    y_hat = y_hat.reshape(-1, y_hat.shape[-1]).float()
    y = y.reshape(-1, y.shape[-1]).float()
    noise = ((y_hat - y) ** 2).sum(dim=-1)
    signal = (y**2).sum(dim=-1)
    return float((noise / signal.clamp(min=1e-12)).mean())


def fake_quant_int8_per_tensor(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 fake quant of an activation (the input
    quantizer of the SNR probe)."""
    xf = x.float()
    scale = true_div(xf.abs().max().clamp(min=1e-12), 127.0)
    q = torch.round(xf / scale).clamp(-128, 127)
    return (q * scale).to(x.dtype)


def format_snr_table(rows) -> str:
    """SNR diagnostics rows as a table: name | weight_error | fp_inp_SNR |
    q_inp_SNR | time."""
    out = [
        "| name | weight_error | fp_inp_SNR | q_inp_SNR | time |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            "| {name} | {weight_error:.4f} | {fp_inp_snr:.6f} | {q_inp_snr:.6f} | {time:.2f}s |"
            .format(**r)
        )
    return "\n".join(out)


def gptq_find_params(w: torch.Tensor, n_bits: int, sym: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (scale, zero) over the given columns: w [rows, cols] ->
    scale, zero [rows]."""
    maxq = 2**n_bits - 1
    xmin = w.amin(dim=1).clamp(max=0.0)
    xmax = w.amax(dim=1).clamp(min=0.0)
    if sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    scale = true_div(xmax - xmin, float(maxq))
    if sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)
    return scale, zero


def _quantize_col(w, scale, zero, maxq):
    q = (torch.round(w / scale) + zero).clamp(0, maxq)
    return q, scale * (q - zero)


@dataclasses.dataclass
class HessianState:
    H: torch.Tensor  # [K, K] float32
    nsamples: int


def hessian_init(k: int, device="cpu") -> HessianState:
    return HessianState(H=torch.zeros((k, k), dtype=torch.float32, device=device), nsamples=0)


def hessian_update(state: HessianState, x: torch.Tensor) -> HessianState:
    """x: [B, T, K] or [T, K], one calibration batch counting as B samples:
    H' = H * old_n / new_n + (2 / new_n) x^T x. Updates H in place."""
    if x.dim() == 2:
        x = x[None]
    new_n = state.nsamples + x.shape[0]
    xf = x.reshape(-1, x.shape[-1]).float() * (2.0 / new_n) ** 0.5
    H = state.H
    H.mul_(state.nsamples / new_n)
    H.addmm_(xf.T, xf)
    return HessianState(H=H, nsamples=new_n)


def inv_cholesky_upper(Hd: torch.Tensor) -> torch.Tensor:
    """Upper-triangular U with Hd^-1 = U^T U, the factor GPTQ's error
    feedback reads: cholesky(cholesky_inverse(cholesky(Hd)), upper), in
    fp32. JAX forms the same factor by a blocked Cholesky and triangular
    inverse in `fori_loop`s (`gptq.py:178-235`), a workaround for XLA's
    unrolled expanders running out of TPU memory at K = 14336; nothing here
    needs it."""
    L = torch.linalg.cholesky(Hd.float())
    return torch.linalg.cholesky(torch.cholesky_inverse(L), upper=True)


def gptq_solve(
    w_rows: torch.Tensor,  # [R, K] (rows = output channels)
    H: torch.Tensor,  # [K, K]
    n_bits: int,
    group_size: Optional[int] = None,
    blocksize: int = 128,
    sym: bool = False,
    actorder: bool = False,
    percdamp: float = 0.01,
):
    """Quantize one weight matrix against its input Hessian
    (`gptq.py:241-357`). Returns (codes uint8 [R, K], scale [R, G], zero
    [R, G], g_idx [K], error fp32 scalar)."""
    r, k = w_rows.shape
    gs = group_size or k
    if k % gs:
        raise ValueError(f"K={k} not divisible by group_size={gs}")
    blocksize = min(blocksize, k)
    if k % blocksize:
        raise ValueError(f"K={k} not divisible by blocksize={blocksize}")
    if gs % blocksize and blocksize % gs:
        raise ValueError(f"blocksize={blocksize} and group_size={gs} must nest")
    maxq = 2**n_bits - 1
    dev = w_rows.device

    W = w_rows.float().clone()
    H = H.float().clone()
    dead = torch.diagonal(H) == 0
    torch.diagonal(H)[dead] = 1.0
    W[:, dead] = 0.0
    if actorder:
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        W = W[:, perm]
        H = H[perm][:, perm]
    damp = percdamp * torch.diagonal(H).mean()
    torch.diagonal(H).add_(damp)
    Hinv = inv_cholesky_upper(H)
    del H

    Q = torch.zeros((r, k), dtype=torch.float32, device=dev)
    scales = torch.ones((r, k // gs), dtype=torch.float32, device=dev)
    zeros = torch.zeros((r, k // gs), dtype=torch.float32, device=dev)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    for i1 in range(0, k, blocksize):
        i2 = i1 + blocksize
        W1 = W[:, i1:i2].clone()
        Hinv1 = Hinv[i1:i2, i1:i2]
        Err1 = torch.zeros((r, blocksize), dtype=torch.float32, device=dev)
        for i in range(blocksize):
            c = i1 + i
            if c % gs == 0:
                # group params from W as the block found it (its columns
                # take the error feedback only after this loop)
                s, z = gptq_find_params(W[:, c : c + gs], n_bits, sym)
                scales[:, c // gs] = s
                zeros[:, c // gs] = z
            w = W1[:, i]
            d = Hinv1[i, i]
            q, dq = _quantize_col(w, scales[:, c // gs], zeros[:, c // gs], maxq)
            err = (w - dq) / d
            loss = loss + ((w - dq) ** 2 / d**2).sum() / 2.0
            W1[:, i + 1 :] -= err[:, None] * Hinv1[i, i + 1 :][None, :]
            Q[:, c] = q
            Err1[:, i] = err
        W[:, i1:i2] = W1
        if i2 < k:
            W[:, i2:] -= Err1 @ Hinv[i1:i2, i2:]

    g_idx = torch.arange(k, device=dev) // gs
    if actorder:
        invperm = torch.argsort(perm)
        Q = Q[:, invperm]
        g_idx = g_idx[invperm]
    return Q.to(torch.uint8), scales, zeros, g_idx, loss


def _solve_and_pack(w_kn, H, *, spec, blocksize, sym, actorder, percdamp, pack):
    codes, scales, zeros, g_idx, err = gptq_solve(
        w_kn.T, H, n_bits=spec.n_bits, group_size=spec.group_size, blocksize=blocksize,
        sym=sym, actorder=actorder, percdamp=percdamp,
    )
    qt = from_codes(
        codes.T.contiguous(),
        scales.T.contiguous(),
        zeros.T.contiguous(),
        spec,
        pack=pack,
        out_dtype=w_kn.dtype if w_kn.dtype.is_floating_point else torch.bfloat16,
        # act-order with grouping: the column -> group map follows the
        # activation order; contiguous otherwise
        g_idx=g_idx if (actorder and spec.group_size) else None,
    )
    return qt, err


def gptq_quantize_weight(
    w_kn: torch.Tensor,  # [K, N]
    H: torch.Tensor,
    spec: QuantSpec,
    blocksize: int = 128,
    actorder: bool = False,
    percdamp: float = 0.01,
    pack: bool = False,
) -> Tuple[QuantizedTensor, torch.Tensor]:
    """GPTQ-quantize a `[K, N]` weight; returns (QuantizedTensor, error).
    With actorder the codes come back in the original column order; with
    grouping too, the group of each column is `g_idx`'s, and the weight
    rides the dequant route (the kernels take contiguous groups)."""
    if spec.n_bits > 8:
        raise NotImplementedError(f"{spec.n_bits}-bit codes exceed int8 storage")
    return _solve_and_pack(
        w_kn, H, spec=spec, blocksize=blocksize, sym=spec.symmetric or spec.disable_zero_point,
        actorder=actorder, percdamp=percdamp, pack=pack,
    )
