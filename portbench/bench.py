"""One run of one cell: set-up, the measured window, the metrics, and the
correctness check against the plain reference.

`run_cell` does everything but look for the card (`run.py` does that):
so the tests can drive a whole run on the CPU at tiny sizes. What a cell
is comes from `BENCHMARK.json` and the files that `registry.py` finds by
name; what is measured and how comes from the traffic mix's driver.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import torch

from .registry import Registry, load_benchmark
from .tracing import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "llama3_quantization_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def seed_words(seed: int, *more: int) -> list:
    """A `numpy` seed sequence for a run's seed (any whole number) and
    the draw's place `more`."""
    return [int(seed) % 2**64, *more]


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Context:
    """What a per-layer metric's reader sees: the driver's facts (counts,
    work, times of the window), the reduced trace, the configuration and
    the traffic mix."""

    def __init__(self, facts: dict, trace: Optional[dict], cfg: dict, traffic: dict):
        self.facts, self.trace, self.cfg, self.traffic = facts, trace, cfg, traffic

    def group_s(self, group: str) -> float:
        """Device seconds of a kernel group in the traced window (0 when
        untraced or when none of its kernels ran)."""
        return (self.trace or {}).get("group_s", {}).get(group, 0.0)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             registry: Optional[Registry] = None, bench: Optional[dict] = None,
             control: bool = False, t_start: Optional[float] = None) -> dict:
    """Run cell `workload` once and return its result object (the last
    line `run.py` prints). `control` runs the program's int8-activation
    path (its `act` hook) in place of the configuration's bf16 one."""
    t_start = time.perf_counter() if t_start is None else t_start
    reg = registry or Registry()
    bench = bench or load_benchmark()
    cell = next((c for c in bench["workloads"] if c["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = reg.json("configs", cell["config"])
    traffic = reg.json("traffic", cell["traffic"])
    limits = reg.json("limits", cell["name"])
    dev = torch.device(device)
    tracer = Tracer(trace)
    driver = reg.module("drivers", traffic["driver"]).Driver(
        cfg=cfg, traffic=traffic, seed=seed, device=dev, tracer=tracer, control=control)

    log(f"set-up: imports done at {time.perf_counter() - t_start:.2f} s")
    if dev.type == "cuda":
        from llama3_quantization_tpu_torch.ops import _build

        _build.build_all()  # a no-op once the checkout's build directory holds them
        log(f"set-up: kernels built at {time.perf_counter() - t_start:.2f} s")
    driver.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"set-up: weights made and shapes warmed at {setup_s:.2f} s")

    with tracer.window():
        driver.window(seconds)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    end_to_end = dict(driver.end_to_end(), setup_s=setup_s)
    summary = tracer.reduce(reg.kernel_groups()) if trace else None
    facts = driver.facts()
    driver.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    metrics: Dict[str, dict] = {}
    if trace:
        ctx = Context(facts, summary, cfg, traffic)
        for m in bench["per_layer"]:
            if applies(m, workload):
                value = reg.reader(m["name"]).read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, workload):
                if end_to_end.get(m["name"]) is None:
                    raise RuntimeError(f"{workload}: the window gave no {m['name']}")
                metrics[m["name"]] = {"value": end_to_end[m["name"]], "unit": m["unit"]}

    log(f"peaks: {989e12:.3e} FLOP/s bf16, {3.35e12:.3e} B/s ({card_line(dev)})")
    t_check = time.perf_counter()
    checks = driver.check()
    log(f"reference check: {time.perf_counter() - t_check:.1f} s")
    compared = {name: {"value": value, "limit": limits[name]["limit"]}
                for name, value in checks.items()}
    attempted, failed = driver.outcomes()
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())

    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": device_info(dev, memory_peak, summary),
    }
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = compared
    # last, once every reader and the reference have been loaded and run
    bad = forbidden_modules()
    if bad:
        log(f"JAX or the JAX package was loaded: {bad[:8]}")
        raise RuntimeError(f"JAX or the JAX package was loaded: {bad[:8]}")
    return result


def device_info(dev: torch.device, memory_peak: int, summary: Optional[dict]) -> dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": memory_peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if summary is not None:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    return info


def card_line(dev: torch.device) -> str:
    """The card's name and power limit, read from nvidia-smi."""
    if dev.type != "cuda":
        return "no card"
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"


def samples_line(counts: Dict[str, int]) -> None:
    log("samples: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
