"""Arguments, inputs and timing shared by the microbench entry points.

The JAX scripts time L distinct weight copies inside one jitted
`fori_loop` over a `scan`, so that host dispatch is excluded
(`scripts/microbench_w4_variants.py:159-177`). Here, on the card, the L
copies times `steps` calls are issued back to back and captured in one
CUDA graph, the graph is replayed once to warm up, and a replay is timed
with CUDA events: seconds per call = replay / steps / L. The L copies
together exceed the H100's 50 MB L2, so the weights stream from HBM. With
`--device cpu` (the tests) the same calls run eagerly under the host
clock, through the kernels' plain versions: those numbers time the CPU.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..device import resolve_device

#: the H100 SXM's HBM rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: the scripts' quantization group
GS = 128


def parse(argv: Optional[Sequence[str]], prog: str, positional: Sequence[Tuple[str, int]],
          steps: Optional[int] = None):
    """(ints by name, the remaining positional words, device, steps); a
    `--steps` flag only where the script has a steps default."""
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("args", nargs="*")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    if steps is not None:
        ap.add_argument("--steps", type=int, default=steps, help="timed calls per weight copy")
    ns = ap.parse_args(argv)
    vals = {name: int(ns.args[i]) if i < len(ns.args) else default
            for i, (name, default) in enumerate(positional)}
    return vals, ns.args[len(positional):], resolve_device(ns.device), getattr(ns, "steps", None)


def generator(device: torch.device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def rand_bytes(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform int8 in [-128, 127], made on `device`."""
    return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8).view(
        torch.int8)


def rand_scales(gen: torch.Generator, shape, device) -> torch.Tensor:
    """The scripts' group scales: uniform in [0.005, 0.015), f32."""
    return (torch.rand(shape, generator=gen, device=device) + 0.5) * 0.01


def rand_ints(gen: torch.Generator, lo: int, hi: int, shape, device) -> torch.Tensor:
    """Uniform int8 in [lo, hi), made on `device`."""
    return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int16).to(
        torch.int8)


def time_calls(fn: Callable, arg_sets: List[tuple], steps: int, device: torch.device,
               replays: int = 1) -> float:
    """Seconds per call of `fn(*a)` for `a` in `arg_sets`, `steps` rounds
    back to back (on the card: one CUDA graph, best of `replays` replays)."""
    if device.type != "cuda":
        for a in arg_sets:
            fn(*a)
        t0 = time.perf_counter()
        for _ in range(steps):
            for a in arg_sets:
                fn(*a)
        return (time.perf_counter() - t0) / steps / len(arg_sets)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for a in arg_sets:  # first calls: kernel build and load, outside the graph
            fn(*a)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: the wrappers' per-launch `cudaFuncSetAttribute` may run while capturing
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(steps):
            for a in arg_sets:
                fn(*a)
    graph.replay()
    torch.cuda.synchronize(device)
    best = math.inf
    for _ in range(replays):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    del graph
    return best / steps / len(arg_sets)


def share(nbytes: float, dt: float, device: torch.device) -> str:
    """", x% of 3.35 TB/s" on the card; nothing on the CPU."""
    if device.type != "cuda":
        return ""
    return f", {100 * nbytes / dt / HBM_BYTES_PER_S:5.1f}% of 3.35 TB/s"


def header(device: torch.device) -> None:
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)} (CUDA graph replay, CUDA events)")
    else:
        print("device: cpu (the kernels' plain versions, host clock)")


def rate_line(name: str, dt: float, nbytes: float, device: torch.device) -> str:
    """The scripts' line: us per call and GB/s of packed bytes."""
    return (f"  {name:8s}: {dt * 1e6:7.1f} us/call, {nbytes / dt / 1e9:5.0f} GB/s packed bytes"
            f"{share(nbytes, dt, device)}")
