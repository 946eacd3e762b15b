"""Distributed GPTQ calibration (port of
`llama3_quantization_tpu/parallel/calibrate.py`).

Both halves of GPTQ split over ranks with little traffic:

- the solve is independent per output channel: every column of `W [K, N]`
  quantizes against the same Hessian with its own scales, zeros and error
  feedback, so each rank of the mesh axis solves its N / n-wide slab of
  columns with no communication, and one all-reduce sums the error;
- the Hessian is a sum of per-sample outer products: each rank of the dp
  axis forms the partial `x^T x` of its samples, and one all-reduce sums
  them.
"""

from __future__ import annotations

import torch

from ..ops.collectives import all_reduce_
from ..quant.gptq import HessianState, gptq_quantize_weight
from ..quant.quantizer import QuantSpec
from .mesh import axis_index, axis_size
from .sharding import _narrow


def sharded_gptq_quantize_weight(
    w_kn: torch.Tensor,  # [K, N], every rank the same
    H: torch.Tensor,  # [K, K], every rank the same
    spec: QuantSpec,
    mesh,
    axis: str = "tp",
    blocksize: int = 128,
    percdamp: float = 0.01,
    pack: bool = False,
):
    """GPTQ of `w_kn` with its output channels split over `mesh`'s `axis`
    (`calibrate.py:38-97`). Returns (this rank's column shard, a
    QuantizedTensor with n = N / axis size, the same codes and scales as
    those columns of the single-rank solve; the error summed over the axis,
    the full matrix's)."""
    nd = axis_size(mesh, axis)
    n = w_kn.shape[1]
    if n % nd:
        raise ValueError(f"N={n} not divisible by mesh axis {axis}={nd}")
    w_local = _narrow(w_kn, 1, nd, axis_index(mesh, axis))
    qt, err = gptq_quantize_weight(w_local, H, spec, blocksize=blocksize, percdamp=percdamp,
                                   pack=pack)
    err = err.float().reshape(()).clone()
    if nd > 1:
        all_reduce_(err, mesh.get_group(axis))
    return qt, err


def sharded_hessian_update(
    state: HessianState,
    x: torch.Tensor,  # [B, T, K] (every rank the same batch; B split over `axis`)
    mesh,
    axis: str = "dp",
) -> HessianState:
    """One Hessian batch update with the samples split over `mesh`'s
    `axis` (`calibrate.py:100-123`): this rank's partial x^T x, scaled as
    the streaming update scales it, then one all-reduce. Returns a new
    state; B counts as the batch's samples."""
    if x.dim() == 2:
        x = x[None]
    b = x.shape[0]
    nd = axis_size(mesh, axis)
    if b % nd:
        raise ValueError(f"a batch of {b} does not split over mesh axis {axis}={nd}")
    new_n = state.nsamples + b
    n = b // nd
    r = axis_index(mesh, axis)
    x_local = x[r * n : (r + 1) * n]
    xf = x_local.reshape(-1, x_local.shape[-1]).float() * (2.0 / new_n) ** 0.5
    part = xf.T @ xf
    if nd > 1:
        all_reduce_(part, mesh.get_group(axis))
    return HessianState(H=state.H * (state.nsamples / new_n) + part, nsamples=new_n)
