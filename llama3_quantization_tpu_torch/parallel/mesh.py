"""Device meshes over the ranks of the process group (port of
`llama3_quantization_tpu/parallel/mesh.py`).

A JAX `Mesh` names the axes of a device array; the port's mesh is a
`torch.distributed.device_mesh.DeviceMesh` over ranks (one per device) with
the same axis names, `("dp", "tp")` here, `("pp",)` or `("sp",)` for the
pipeline and ring attention. Every rank of the default group constructs
each mesh (its groups are made collectively), members or not.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def mesh_device_type() -> str:
    """"cuda" under an NCCL process group, else "cpu"."""
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def named_mesh(shape: Sequence[int], names: Sequence[str],
               ranks: Optional[Sequence[int]] = None, device="cuda") -> DeviceMesh:
    """A mesh of `shape` with axes `names` over `ranks` (default: every rank
    of the default group, which starts as a world of one if there is none:
    `distributed.init_distributed(device=device)`)."""
    from .distributed import init_distributed

    if not dist.is_initialized():
        init_distributed(device=device)
    ranks = list(range(dist.get_world_size())) if ranks is None else [int(r) for r in ranks]
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(mesh_device_type(), grid, mesh_dim_names=tuple(names))


def make_mesh(
    dp: Optional[int] = None,
    tp: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    device="cuda",
) -> DeviceMesh:
    """A (dp, tp) mesh (`mesh.py:12-41`) over `devices`, ranks of the
    default group (default: all). Defaults as JAX's: tp = all, dp = 1;
    `ValueError` where dp * tp is not the device count."""
    from .distributed import init_distributed

    if not dist.is_initialized():
        init_distributed(device=device)
    n = dist.get_world_size() if devices is None else len(devices)
    if tp is None and dp is None:
        dp, tp = 1, n
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != device count ({n})")
    return named_mesh((dp, tp), ("dp", "tp"), devices, device)


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """Axis sizes by name: JAX's `dict(mesh.shape)`."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The size of axis `name`, 1 where the mesh has no such axis."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def axis_index(mesh: DeviceMesh, name: str) -> int:
    """This rank's index along axis `name` (JAX's `lax.axis_index`)."""
    return mesh.get_local_rank(name)


def in_mesh(mesh: DeviceMesh) -> bool:
    """Is this rank one of the mesh's?"""
    return mesh.get_coordinate() is not None
