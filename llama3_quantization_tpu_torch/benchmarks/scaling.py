"""Multi-device scaling benchmark (port of
`llama3_quantization_tpu/benchmarks/scaling.py`).

Measures the sharded forward's tokens per second at growing device counts
(the first n ranks of the process group, a (n / tp, tp) mesh each) and the
scaling efficiency against the per-device rate at the first count. Host
clock around forwards that end in a device synchronise; batch grows with n
(weak scaling).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.configs import ModelConfig
from ..parallel import make_mesh, make_sharded_forward, shard_params
from ..parallel.mesh import in_mesh, mesh_shape


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def measure_scaling(
    params,
    cfg: ModelConfig,
    device_counts: Sequence[int] = (1, 2, 4, 8),
    batch_per_device: int = 2,
    seq: int = 128,
    iters: int = 5,
    tp_per_group: Optional[int] = None,
) -> Dict[int, dict]:
    """For each n in `device_counts` (up to the world size): shard over
    (dp = n / tp, tp) of the first n ranks and time the full-sequence
    forward (`scaling.py:22-63`). Every rank of the process group calls
    it (the meshes are made collectively) and every rank returns rank 0's
    readings: {n: {"tok_s", "tok_s_per_device", "efficiency", "mesh"}}."""
    results: Dict[int, dict] = {}
    base_rate = None
    dev = params["embed"].device
    for n in device_counts:
        if dist.get_world_size() < n:
            break
        tp = min(tp_per_group or n, n)
        mesh = make_mesh(dp=n // tp, tp=tp, devices=list(range(n)))
        reading = [None]
        if in_mesh(mesh):
            sharded = shard_params(params, mesh, cfg)
            fwd = make_sharded_forward(cfg, mesh)
            batch = batch_per_device * (n // tp)
            toks = torch.from_numpy(
                np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, seq))).to(dev)
            _sync(fwd(sharded, toks))
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fwd(sharded, toks)
            _sync(out)
            dt = (time.perf_counter() - t0) / iters
            reading = [batch * seq / dt]
        dist.broadcast_object_list(reading, src=0)
        rate = reading[0]
        if base_rate is None:
            base_rate = rate / n  # per-device rate at the first count
        results[n] = {
            "tok_s": round(rate, 1),
            "tok_s_per_device": round(rate / n, 1),
            "efficiency": round(rate / (base_rate * n), 4),
            "mesh": mesh_shape(mesh),
        }
    return results
