"""Per-kernel device-time report from a `torch.profiler` trace (port of
`llama3_quantization_tpu/tools/profile_report.py`).

    python -m llama3_quantization_tpu_torch.tools.profile_report <log dir or *.trace.json.gz> \\
        --steps 4 --top 25

prints the device table (total and per-step time, launches, share) of the
newest trace under the directory, as `utils.profiling.profile_trace`
writes them: which kernels a step spends its device time in.
"""

from __future__ import annotations

import argparse

from ..utils.profiling import device_op_table, format_op_table, load_trace_events


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trace", help="profile_trace log dir or *.trace.json.gz path")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--steps", type=int, default=1,
                   help="divide totals by this for per-step numbers")
    args = p.parse_args(argv)
    events = load_trace_events(args.trace)
    rows = device_op_table(events, top=args.top, steps=args.steps)
    print(format_op_table(rows))
    return rows


if __name__ == "__main__":
    main()
