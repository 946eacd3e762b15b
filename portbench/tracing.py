"""The traced run: `torch.profiler` over the measured window, reduced to
the device's busy time, each kernel group's device time, and the
breakdown (the device operations that took most time, and the device's
idle time by what the host was doing meanwhile).

The benchmark marks its own calls into the program with spans
(`Tracer.span`, a `record_function`), so an idle gap is named by the span
the host was inside and the last host operation it had started. Spans
cost nothing when tracing is off. Kernel groups are files of kernel names
under `kernel_groups/<group>/` (one name a line, `#` comments): a device
event belongs to a group when one of the group's names is an identifier
of its (demangled) name.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from . import stats

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"
TOP = 10


def activity(event, span_names) -> str:
    """A profiler event's kind: its activity type where this PyTorch
    reports one, else from its device and name (on the card: kernels,
    copies and memsets, but not the spans' mirrors or synchronisations)."""
    if hasattr(event, "activity_type"):
        return event.activity_type()
    name = event.name()
    if "CUDA" in str(event.device_type()):
        if name in span_names:
            return "gpu_user_annotation"
        return "cuda_sync" if "sync" in name.lower() else "kernel"
    return "user_annotation" if name in span_names else "cpu_op"


class Tracer:
    """Spans always; the profiler only when `enabled`."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.span_names = {WINDOW_SPAN}
        self.prof = None
        self.summary: Optional[dict] = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        self.span_names.add(name)
        return record_function(name)

    @contextlib.contextmanager
    def window(self):
        """The measured window: profiled (CPU and card) when enabled."""
        if not self.enabled:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        try:
            with self.span(WINDOW_SPAN):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            self.prof.stop()

    def reduce(self, groups: Dict[str, Sequence[str]]) -> dict:
        """Reduce the profiled window (see `reduce_events`)."""
        events = [(e.name(), activity(e, self.span_names), e.start_ns(), e.duration_ns())
                  for e in self.prof.profiler.kineto_results.events()]
        self.prof = None
        self.summary = reduce_events(events, groups)
        return self.summary


def _matcher(names: Sequence[str]):
    pattern = re.compile(r"\b(?:%s)\b" % "|".join(re.escape(n) for n in names))
    return lambda kernel_name: bool(pattern.search(kernel_name))


def reduce_events(events: List[Tuple[str, str, int, int]],
                  groups: Dict[str, Sequence[str]]) -> dict:
    """From profiler events (name, activity type, start ns, duration ns):
    `window_s` (the window span), `busy_s` (the union of device events in
    it), `group_s` (each group's summed device time), `device_ops` and
    `idle_gaps` (the breakdown, seconds, at most `TOP` each)."""
    win = [(s, s + d) for n, a, s, d in events if n == WINDOW_SPAN]
    if not win:
        raise RuntimeError("the trace holds no window span")
    lo, hi = win[0]
    device, spans, host_ops = [], [], []
    for name, act, start, dur in events:
        if act in DEVICE_ACTIVITIES:
            device.append((name, start, start + dur))
        elif act == "user_annotation" and name != WINDOW_SPAN:
            spans.append((start, start + dur, name))
        elif act == "cpu_op":
            host_ops.append((start, name))
    device = [(n, max(a, lo), min(b, hi)) for n, a, b in device if b > lo and a < hi]
    busy = stats.merge_intervals((a, b) for _, a, b in device)
    by_name: Dict[str, float] = defaultdict(float)
    for name, a, b in device:
        by_name[name] += (b - a) / 1e9
    group_s = {}
    for group, names in groups.items():
        match = _matcher(names)
        group_s[group] = sum(s for name, s in by_name.items() if match(name))
    host_ops.sort()
    spans.sort()
    ops_at = ([s for s, _ in host_ops], host_ops)
    spans_at = ([s for s, _, _ in spans], spans)
    idle: Dict[str, float] = defaultdict(float)
    for a, b in stats.gaps(busy, lo, hi):
        idle[_host_activity((a + b) / 2, spans_at, ops_at)] += (b - a) / 1e9
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "group_s": group_s,
        "device_ops": [[name[:160], s] for name, s in top_ops],
        "idle_gaps": [[name, s] for name, s in top_idle],
    }


def _host_activity(t: float, spans_at, ops_at) -> str:
    """The innermost benchmark span around host time `t` (the latest
    started one that has not ended: spans nest), and the last host
    operation started before `t`."""
    (span_starts, spans), (op_starts, ops) = spans_at, ops_at
    inner = "outside spans"
    for i in range(bisect.bisect_right(span_starts, t) - 1, -1, -1):
        if spans[i][1] >= t:
            inner = spans[i][2]
            break
    i = bisect.bisect_right(op_starts, t) - 1
    op = ops[i][1] if i >= 0 else "no host op"
    return f"{inner} / {op}"
