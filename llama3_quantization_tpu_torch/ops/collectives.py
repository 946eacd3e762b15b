"""Rank-local parameter trees and the collectives of tensor and data parallelism.

The JAX package shards a parameter tree with GSPMD and lets XLA insert the
collectives (`parallel/sharding.py`). The port runs one process per device
and Megatron-style tensor parallelism by hand: `parallel.shard_params`
returns each rank's own shards, and the model inserts the collectives:

- an all-reduce over `tp` after each row-parallel linear (`o`, `down`,
  `fc2`, an MoE's combined experts), its bias added once after it;
- an all-gather over `tp` of a column-parallel head's vocab shards;
- under `dp`, each rank runs its own rows of the batch and the outputs are
  gathered over `dp`, so every rank ends with the full result.

The rank-local tree carries its place in the mesh under `SHARD_KEY`: one
`Shard`, read by every entry point of the model (`shard_of`). A tree without
it runs as one replica. The collectives check that the group's backend
serves the tensor's device (NCCL for CUDA tensors, gloo for CPU ones): a
tensor never crosses to the host to meet a group of the other kind. With
grad enabled they follow Megatron's conjugate pairs (`reduce_tp`: an
all-reduce forward, identity backward; `copy_tp`: the reverse), so a loss
that every tp rank computes alike differentiates as the unsharded model.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

#: the key of a rank-local tree that holds its `Shard`
SHARD_KEY = "shard"


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's place in a (dp, tp) mesh: sizes, indices and groups."""

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh with axes ("dp", "tp")
    dp: int
    dp_rank: int
    dp_group: Any
    tp: int
    tp_rank: int
    tp_group: Any


def shard_of(params) -> Optional[Shard]:
    """The `Shard` a rank-local tree carries, None for a one-replica tree."""
    return params.get(SHARD_KEY) if isinstance(params, dict) else None


def check_backend(t: torch.Tensor, group) -> None:
    """Raise unless `group`'s backend serves `t`'s device: NCCL for CUDA
    tensors, gloo for CPU tensors (no staging through the host)."""
    name = str(dist.get_backend(group))
    want = "nccl" if t.is_cuda else "gloo"
    if want not in name:
        raise RuntimeError(
            f"a {t.device.type} tensor met a {name} group: collectives run on "
            f"{want} for {t.device.type} tensors and never stage through the host"
        )


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place (after the backend check)."""
    check_backend(t, group)
    dist.all_reduce(t, group=group)
    return t


def all_reduce_max_(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of `t` over `group`, in place."""
    check_backend(t, group)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


@contextlib.contextmanager
def row_parallel_input(shard: Optional[Shard]):
    """Inside: the activations a linear takes are this rank's K shard of
    each row (a row-parallel linear under tp > 1), so the W·A8 backends'
    per-token int8 scale is the absmax over every rank's shard."""
    from . import qmatmul_a8

    if shard is None or shard.tp == 1:
        yield
        return
    prev, qmatmul_a8._K_GROUP = qmatmul_a8._K_GROUP, shard.tp_group
    try:
        yield
    finally:
        qmatmul_a8._K_GROUP = prev


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim`, in rank order of `group`.
    The pieces are equal in shape (a shard is always an equal part: the
    sharding refuses an axis that does not split evenly), so no size is
    exchanged and the host never waits for the device here."""
    check_backend(t, group)
    n = dist.get_world_size(group)
    if n == 1:
        return t
    buf = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(buf, t.contiguous(), group=group)
    parts = buf.view((n,) + tuple(t.shape))
    dim = dim % t.dim()
    return parts.movedim(0, dim).reshape(
        tuple(t.shape[:dim]) + (n * t.shape[dim],) + tuple(t.shape[dim + 1:]))


class _ReduceTP(torch.autograd.Function):
    """Forward: all-reduce over tp; backward: identity (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyTP(torch.autograd.Function):
    """Forward: identity; backward: all-reduce over tp (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _GatherTP(torch.autograd.Function):
    """Forward: all-gather along the last axis; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n_local = x.shape[-1]
        ctx.start = dist.get_rank(group) * x.shape[-1]
        return all_gather_cat(x, group, -1)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.start : ctx.start + ctx.n_local], None


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce_tp(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """The sum over tp of the rank's partial `x` (a row-parallel linear's
    output); `x` itself is reduced in place when no grad flows."""
    if shard is None or shard.tp == 1:
        return x
    if _needs_grad(x):
        return _ReduceTP.apply(x, shard.tp_group)
    return all_reduce_(x.contiguous(), shard.tp_group)


def copy_tp(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """`x` entering column-parallel linears: unchanged forward, its
    gradient summed over tp backward."""
    if shard is None or shard.tp == 1 or not _needs_grad(x):
        return x
    return _CopyTP.apply(x, shard.tp_group)


def gather_tp(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """A column-parallel output's shards concatenated along the last axis."""
    if shard is None or shard.tp == 1:
        return x
    if _needs_grad(x):
        return _GatherTP.apply(x, shard.tp_group)
    return all_gather_cat(x.contiguous(), shard.tp_group, -1)


def dp_rows(b: int, shard: Optional[Shard]) -> Optional[Tuple[int, int]]:
    """This rank's rows [start, stop) of a batch of `b` under dp, or None
    where every rank runs all rows (one replica, dp = 1, or b % dp != 0)."""
    if shard is None or shard.dp == 1 or b % shard.dp:
        return None
    n = b // shard.dp
    return shard.dp_rank * n, (shard.dp_rank + 1) * n


def local_rows(x: torch.Tensor, shard: Optional[Shard], b: Optional[int] = None) -> torch.Tensor:
    """This rank's rows of `x` (dim 0 is the batch of `b` rows)."""
    rows = dp_rows(x.shape[0] if b is None else b, shard)
    return x if rows is None else x[rows[0] : rows[1]]


def gather_rows(x: torch.Tensor, shard: Optional[Shard], b: int) -> torch.Tensor:
    """Every rank's rows of a batch of `b` (dim 0), after `local_rows`."""
    if dp_rows(b, shard) is None:
        return x
    return all_gather_cat(x.contiguous(), shard.dp_group, 0)
