"""The benchmark's command: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the kernels' build on a checkout's first run, weights from the
seed, the warm-up of the cell's shapes), then a window of `--seconds`,
then the check against the plain reference. The last line of standard
output is the result object; the numbers compared, each beside its limit,
are the last lines of standard error. Without a card, or with fewer cards
than the cell asks for, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# caches of anything that compiles live inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(REPO / ".bench_cache" / sub)
os.environ.setdefault("USE_FLAX", "0")  # keep transformers, if loaded, off JAX
os.environ.setdefault("USE_TF", "0")
sys.path.insert(0, str(REPO))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the program's int8-activation path: the check's control")
    args = ap.parse_args(argv)

    import torch

    from portbench.bench import log, run_cell
    from portbench.registry import load_benchmark

    bench = load_benchmark(REPO / "BENCHMARK.json")
    cell = next((c for c in bench["workloads"] if c["name"] == args.workload), None)
    if cell is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark measures the card and never falls back to the CPU")
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} cards, found {torch.cuda.device_count()}")
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      bench=bench, control=args.control, t_start=T_START)
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
