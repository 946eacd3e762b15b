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
  trace back (`tools/profile_report.py`);
- `span`, `count`, `entry_point`, `recording` and `recorded`: the port's
  own spans and counters, placed at its layer boundaries (below).

The trace format differs from JAX's: a `jax.profiler` trace marks device
events by their process (`/device:...` process names), a `torch.profiler`
trace by their category (`kernel`, `gpu_memcpy`, `gpu_memset`), which is
what `device_op_table` reads.
"""

from __future__ import annotations

import contextlib
import functools
import gzip
import json
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

#: the categories of a torch.profiler trace's device events
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the body with `torch.profiler` (CPU, and CUDA where available);
    on exit the card is synchronized and the trace written into `log_dir`.
    Yields the profiler."""
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


# ---------------------------------------------------------------------------
# Spans and counters inside the port
# ---------------------------------------------------------------------------
#
# The serving engine, the model's step and the PPL step open spans
# (`span(name)`) at their layer boundaries and add to counters
# (`count(name, n)`). A span adds its host duration and self time (the
# duration less the time its child spans cover) to a total keyed by its
# name and by the outermost `engine.*` or `eval.*` span it ran under (""
# where none), and, under a running profiler, enters
# `torch.profiler.record_function(name)`, so that it lands in the trace on
# the device's clock (`TRACE_SPANS`). Nothing is written to disk.
#
# Recording is on only while a torch profiler runs, or inside `recording()`.
# The coarse entry points (the engine's public methods, `decode_step_multi`,
# `decode_window`, `forward_hidden`, the PPL step) are `entry_point`s, whose
# outermost call reads the gate (`torch.autograd._profiler_enabled()`, a
# flag read) and sets `ON` for the call; every span and counter site reads
# `ON` alone, so with recording off a site allocates nothing and enters no
# `record_function`. A recording starts empty on entering `recording()`, or
# at the first outermost entry point that finds a profiler running after
# one that found none (a warm-up before a profiled window, say) or after
# the recording was read; it is kept until the next one starts.
# `recorded()` reads it. Counters given a tensor add to it on the device
# and are read only by `recorded()`. One thread.

#: recording is on for the entry point the host is in: the flag every span
#: and counter site reads
ON = False
#: do spans enter a running profiler? Where kineto's events name their kind
#: (`activity_type`: torch 2.13 has it, 2.11 not), a reader of the events in
#: memory (`portbench/tracing.py`) tells a span's device-side mirror
#: (`gpu_user_annotation`) from a kernel. Where they do not (torch 2.11),
#: that reader takes the mirror for a kernel and the spans for host ops, so
#: a span in the trace would count as device time: the spans then keep to
#: the recorder's totals.
TRACE_SPANS = hasattr(getattr(torch._C._autograd, "_KinetoEvent", None), "activity_type")
#: the spans' clock (a test swaps in a fake one)
_clock = time.perf_counter


class _Recording:
    def __init__(self, traced: bool):
        self.traced = traced  # a profiler runs: spans enter record_function
        self.spans: Dict[tuple, List[float]] = {}  # (outer, name) -> [n, total_s, self_s]
        self.counts: Dict[str, float] = {}
        self.device: Dict[str, torch.Tensor] = {}
        self.stack: List["_Span"] = []


_rec = _Recording(traced=False)
_depth = 0  # open entry points and `recording()` blocks
_open = False  # the recording takes what the next profiled entry point records


class _Span:
    __slots__ = ("name", "outer", "fn", "t0", "child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _rec.stack
        outer = stack[-1].outer if stack else ""
        self.outer = outer or (self.name if self.name.startswith(("engine.", "eval.")) else "")
        self.fn = torch.profiler.record_function(self.name) if _rec.traced else None
        if self.fn is not None:
            self.fn.__enter__()
        self.child = 0.0
        stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        dur = _clock() - self.t0
        stack = _rec.stack
        stack.pop()
        if stack:
            stack[-1].child += dur
        tot = _rec.spans.setdefault((self.outer, self.name), [0, 0.0, 0.0])
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - self.child
        if self.fn is not None:
            self.fn.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A span named `name` (see above); a shared no-op while `ON` is off."""
    return _Span(name) if ON else _OFF


def count(name: str, n) -> None:
    """Add `n` to counter `name`: a number, or a tensor (any shape) added
    to on its device. Callers test `ON` first, so that nothing is computed
    while recording is off."""
    if torch.is_tensor(n):
        acc = _rec.device.get(name)
        _rec.device[name] = n.detach().clone() if acc is None else acc.add_(n)
    else:
        _rec.counts[name] = _rec.counts.get(name, 0) + n


class _Entry:
    def __enter__(self):
        global ON, _depth, _open, _rec
        if _depth == 0:
            profiled = torch.autograd._profiler_enabled()
            if profiled and not _open:
                _rec = _Recording(traced=TRACE_SPANS)
            _open = ON = profiled
        _depth += 1

    def __exit__(self, *exc):
        global ON, _depth
        _depth -= 1
        if _depth == 0:
            ON = False
        return False


_ENTRY = _Entry()


def entry_point(fn):
    """Make `fn` a coarse entry point: its outermost call reads the gate
    (see above)."""
    @functools.wraps(fn)
    def gated(*args, **kwargs):
        with _ENTRY:
            return fn(*args, **kwargs)

    return gated


@contextlib.contextmanager
def recording():
    """Record the body's spans and counters with no profiler running (a
    profiler that does run still receives the spans). Starts a recording;
    entry points inside the block record into it whatever they find."""
    global ON, _depth, _open, _rec
    was_on = ON
    _rec = _Recording(traced=TRACE_SPANS and torch.autograd._profiler_enabled())
    ON = True
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1
        ON, _open = was_on, False


def recorded() -> dict:
    """The last recording: `{"spans": {outer: {name: {"n", "total_s",
    "self_s"}}}, "counts": {name: number, or list for a tensor}}`. Device
    counters are read here, once (a sync when they live on the card).
    Reading closes a recording that a profiler fed: the next profiled entry
    point starts another."""
    global _open
    _open = False
    spans: Dict[str, dict] = {}
    for (outer, name), (n, total, self_s) in _rec.spans.items():
        spans.setdefault(outer, {})[name] = {"n": n, "total_s": total, "self_s": self_s}
    counts = dict(_rec.counts)
    for name, t in _rec.device.items():
        counts[name] = t.tolist()
    return {"spans": spans, "counts": counts}
