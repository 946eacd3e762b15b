"""Profiling helpers (port of `llama3_quantization_tpu/utils/profiling.py`):
`torch.profiler` traces, throughput accounting, and a per-kernel table of a
trace's device time.

- `profile_trace(log_dir)` wraps a region in a `torch.profiler` trace of
  the CPU and, where there is one, the card, and writes it into `log_dir`
  as a gzipped Chrome trace (`*.pt.trace.json.gz`, which chrome://tracing
  and Perfetto open);
- `Throughput` accumulates tokens and host seconds and reports tok/s beside
  a bytes-per-token roofline fraction at the card's HBM rate;
- `load_trace_events`, `device_op_table` and `format_op_table` read such a
  trace back (`tools/profile_report.py`).

The trace format differs from JAX's: a `jax.profiler` trace marks device
events by their process (`/device:...` process names), a `torch.profiler`
trace by their category (`kernel`, `gpu_memcpy`, `gpu_memset`), which is
what `device_op_table` reads.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Optional

#: the categories of a torch.profiler trace's device events
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the body with `torch.profiler` (CPU, and CUDA where available);
    on exit the card is synchronized and the trace written into `log_dir`.
    Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)


@dataclass
class Throughput:
    """Tokens/sec + roofline accounting for a decode/eval loop."""

    bytes_per_token: Optional[float] = None  # model HBM bytes per token
    hbm_gbps: float = 3350.0  # H100 SXM HBM3
    tokens: int = 0
    seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, tokens: int):
        self.seconds += time.perf_counter() - self._t0
        self.tokens += tokens

    @property
    def tok_s(self) -> float:
        return self.tokens / self.seconds if self.seconds else 0.0

    @property
    def speed_of_light_fraction(self) -> Optional[float]:
        if not self.bytes_per_token:
            return None
        sol = self.hbm_gbps * 1e9 / self.bytes_per_token
        return self.tok_s / sol

    def report(self) -> dict:
        out = {"tokens": self.tokens, "seconds": round(self.seconds, 4),
               "tok_s": round(self.tok_s, 2)}
        frac = self.speed_of_light_fraction
        if frac is not None:
            out["speed_of_light_fraction"] = round(frac, 4)
        return out


# ---------------------------------------------------------------------------
# Trace report: per-kernel device-time table from a torch.profiler trace
# ---------------------------------------------------------------------------


def load_trace_events(trace_dir: str):
    """The traceEvents of the newest `*.trace.json.gz` under a log dir (or
    of the one a direct path names)."""
    path = trace_dir
    if not path.endswith(".json.gz"):
        cands = []
        for root, _dirs, files in os.walk(trace_dir):
            cands += [os.path.join(root, f) for f in files if f.endswith(".trace.json.gz")]
        if not cands:
            raise FileNotFoundError(f"no *.trace.json.gz under {trace_dir}")
        path = max(cands, key=os.path.getmtime)
    with gzip.open(path) as f:
        return json.load(f).get("traceEvents", [])


def device_op_table(events, top: int = 25, steps: int = 1):
    """Aggregate the device's complete events by name.

    Returns rows of (name, count, total_ms, per_step_us, mean_us, share)
    sorted by total time; `steps` divides totals for per-step numbers.
    Device events are those of `DEVICE_CATEGORIES`, so host frames and
    runtime calls stay out of the table."""
    agg: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES and "dur" in e:
            name = e.get("name", "?")
            tot, cnt = agg.get(name, (0.0, 0))
            agg[name] = (tot + e["dur"], cnt + 1)
    total = sum(t for t, _ in agg.values()) or 1.0
    rows = [
        (name, cnt, tot / 1e3, tot / max(cnt, 1), tot / total)
        for name, (tot, cnt) in agg.items()
    ]
    rows.sort(key=lambda r: -r[2])
    return [
        {
            "name": name,
            "count": cnt,
            "total_ms": round(total_ms, 3),
            "per_step_us": round(total_ms * 1e3 / steps, 1),
            "mean_us": round(mean_us, 1),
            "share": round(share, 4),
        }
        for name, cnt, total_ms, mean_us, share in rows[:top]
    ]


def format_op_table(rows) -> str:
    out = [f"{'total ms':>10} {'per-step us':>12} {'count':>7} {'share':>6}  op"]
    for r in rows:
        out.append(
            f"{r['total_ms']:10.2f} {r['per_step_us']:12.1f} {r['count']:7d} "
            f"{r['share']:6.1%}  {r['name'][:90]}"
        )
    return "\n".join(out)
