"""Process-group setup for multi-process runs (port of
`llama3_quantization_tpu/parallel/distributed.py`).

JAX wires every host's process with `jax.distributed.initialize` and one
global mesh spans them. The port runs one process per device, each a rank of
one `torch.distributed` process group: `init_distributed` starts it (from
torchrun's environment, from explicit arguments, or as a world of one when
neither is there), with the backend of the device the ranks compute on:
NCCL for the card, gloo for the CPU. `make_pod_mesh` then lays a (dp, tp)
mesh over the ranks with tp inside a host, so tensor parallelism's
all-reduces stay on the host's own links (NVLink) and dp crosses hosts:

    torchrun --nproc_per_node 8 -m llama3_quantization_tpu_torch.cli --tp 8 ...
    # or in code, on every rank:
    init_distributed()
    mesh = make_pod_mesh(tp=8)
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

#: collectives that wait longer than this raise instead of hanging
TIMEOUT = datetime.timedelta(seconds=300)


def backend_for(device) -> str:
    """The process-group backend for ranks computing on `device`."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """Start this process's rank of the process group (`distributed.py:
    36-49`, `jax.distributed.initialize`). `coordinator_address` is
    "host:port" of rank 0; missing arguments come from torchrun's
    environment (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`), and
    without either a world of one starts on its own (a store on
    127.0.0.1). The backend follows `device` (NCCL for "cuda", which
    raises without CUDA; gloo for "cpu"); a CUDA rank takes the card of its
    `LOCAL_RANK`. A process already in a group is left as it is."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = backend_for(dev)
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator address")
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True, timeout=TIMEOUT)
        dist.init_process_group(backend, store=store, rank=0, world_size=1, timeout=TIMEOUT)
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            rank=process_id, world_size=num_processes, timeout=TIMEOUT)


def local_device_count() -> int:
    """Ranks on this host: torchrun's `LOCAL_WORLD_SIZE`, else every rank
    (one host), bounded by the host's cards on NCCL."""
    n = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if "nccl" in str(dist.get_backend()):
        n = min(n, torch.cuda.device_count())
    return n


def make_pod_mesh(tp: Optional[int] = None, dp: Optional[int] = None, device="cuda"):
    """Global (dp, tp) mesh over every rank (`distributed.py:52-73`).
    Defaults: tp = the ranks of one host, dp = hosts. Ranks are numbered
    host by host (torchrun's order), so each tp row lies in one host."""
    from .mesh import make_mesh

    if not dist.is_initialized():
        init_distributed(device=device)
    n_total = dist.get_world_size()
    tp = tp or local_device_count()
    dp = dp or n_total // tp
    if dp * tp != n_total:
        raise ValueError(f"dp({dp}) * tp({tp}) != global devices ({n_total})")
    return make_mesh(dp=dp, tp=tp)
