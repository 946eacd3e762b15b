"""Collective matmuls: tensor parallelism's all-gather and reduce-scatter
brackets as ring steps that overlap the matmuls (port of
`llama3_quantization_tpu/parallel/collective_matmul.py`).

The Megatron block is bracketed by an all-gather (sequence-sharded
activations into a column-parallel matmul) and a reduce-scatter (a
row-parallel matmul back to sequence shards). As P ring steps each one
sends the next chunk to the neighbour while the chunk on hand is multiplied
(Wang et al., ASPLOS'23): every step issues its `batch_isend_irecv` before
the `qmatmul` of the chunk it holds and waits after it, so on NCCL the copy
runs beside the kernel (B1 for chunks of <= 64 rows, B2 above). A ring of
one issues no p2p operation. Weights may be QuantizedTensor shards from
`sharding.shard_params` (their k / n already the shard's: JAX's `_localize`).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from ..ops.collectives import check_backend
from ..ops.matmul import qmatmul


def _neighbours(group):
    p = dist.get_world_size(group)
    me = dist.get_rank(group)
    return (dist.get_global_rank(group, (me + 1) % p),
            dist.get_global_rank(group, (me - 1) % p))


def ring_shift(sends: Sequence[torch.Tensor], group) -> tuple:
    """Start sending each tensor of `sends` to the next rank of `group`'s
    ring and receiving its counterpart from the previous one. Returns
    (received tensors, requests to wait on); a ring of one returns the
    tensors themselves and no request (JAX's ppermute over one device)."""
    if dist.get_world_size(group) == 1:
        return tuple(sends), []
    nxt, prv = _neighbours(group)
    recvs = tuple(torch.empty_like(t) for t in sends)
    ops: List[dist.P2POp] = []
    for t, r in zip(sends, recvs):
        check_backend(t, group)
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    return recvs, dist.batch_isend_irecv(ops)


def _wait(reqs) -> None:
    for req in reqs:
        req.wait()


def ag_matmul(x_local: torch.Tensor, w_local, group) -> torch.Tensor:
    """All-gather matmul (`collective_matmul.py:44-69`): `x_local` the
    rank's rows (e.g. of the sequence), `w_local` a full-K column shard
    `[K, N/P]`; returns `[S, N/P]` for every rank's rows, in rank order.

    At step r the rank multiplies the chunk that started r hops upstream
    and writes it to that chunk's rows while the chunk moves on."""
    p = dist.get_world_size(group)
    my = dist.get_rank(group)
    s_loc = x_local.shape[0]
    chunk, out = x_local, None
    for r in range(p):
        src = (my - r) % p
        nxt, reqs = ring_shift((chunk,), group) if r < p - 1 else ((chunk,), [])
        y = qmatmul(chunk, w_local)
        if out is None:
            out = y.new_empty((s_loc * p, y.shape[-1]))
        out[src * s_loc : (src + 1) * s_loc] = y
        _wait(reqs)
        chunk = nxt[0]
    return out


def rs_matmul(x_full: torch.Tensor, w_local, group) -> torch.Tensor:
    """Reduce-scatter matmul (`collective_matmul.py:72-107`): `x_full`
    `[S, K/P]` (the rank's K shard), `w_local` the row shard `[K/P, N]`;
    returns the rank's block `[S/P, N]` of the summed product.

    A partial sum circulates the ring in fp32: each step adds the rank's
    product for the block the sum belongs to (computed while the sum is in
    flight), so after P steps each rank holds its own block complete.
    Quantized row shards keep whole groups: (K / P) % group_size == 0."""
    p = dist.get_world_size(group)
    my = dist.get_rank(group)
    s_loc = x_full.shape[0] // p

    def block(idx):
        return qmatmul(x_full[idx * s_loc : (idx + 1) * s_loc], w_local)

    # the sum arriving at step r started at rank my - r and owns that
    # rank's block; after the last hop every sum is home
    acc = block(my).float()
    for r in range(1, p):
        (acc_in,), reqs = ring_shift((acc,), group)
        y = block((my - r) % p)
        _wait(reqs)
        acc = acc_in + y
    if p > 1:
        (acc,), reqs = ring_shift((acc,), group)
        _wait(reqs)
    return acc.to(x_full.dtype)
