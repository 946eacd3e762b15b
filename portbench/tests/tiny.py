"""Tiny configurations and cells for the CPU tests, written into a
temporary folder the way a later change adds files: configurations,
traffic mixes, limits, a per-layer metric and a kernel name."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench.registry import Registry, load_benchmark

WEIGHTS = {"linear_gain": 1.0, "embed_std": 0.02, "head_std": 0.5, "router_gain": 1.0,
           "norm_std": 0.05, "norm_bias_std": 0.02}
CONFIGS = {
    "tiny-mixtral": {
        "model": {"arch": "mixtral", "vocab_size": 512, "hidden_size": 64,
                  "intermediate_size": 128, "num_layers": 2, "num_heads": 4, "num_kv_heads": 2,
                  "rope_theta": 10000.0, "rms_norm_eps": 1e-5, "max_position_embeddings": 256,
                  "num_experts": 4, "num_experts_per_tok": 2, "tie_word_embeddings": False,
                  "dtype": "bfloat16"},
        "quant": {"bits": 4, "group_size": 32, "packed": True}, "weights": WEIGHTS},
    "tiny-falcon": {
        "model": {"arch": "falcon", "vocab_size": 512, "hidden_size": 64,
                  "intermediate_size": 256, "num_layers": 2, "num_heads": 4, "num_kv_heads": 1,
                  "rope_theta": 10000.0, "max_position_embeddings": 256, "activation": "gelu",
                  "parallel_block": True, "tie_word_embeddings": True, "dtype": "bfloat16"},
        "quant": {"bits": 4, "group_size": 32, "packed": True}, "weights": WEIGHTS},
}
#: a tied head reads the embedding: wide enough that the logits are not flat
CONFIGS["tiny-falcon"]["weights"] = {**WEIGHTS, "embed_std": 0.5}
#: the MoE with its route carried by a code in the outlier channels
CONFIGS["tiny-mixtral-routed"] = {
    **CONFIGS["tiny-mixtral"],
    "weights": {**WEIGHTS, "outlier_channels": 4, "outlier_scale": 64.0, "route_code": 1.0,
                "router_gain": 0.03125}}
TRAFFIC = {
    "tiny-ppl": {"driver": "ppl", "seqlen": 128, "batch": 1, "chunk": 64, "check_windows": 3},
    "tiny-serve": {"driver": "closed_loop_serve", "clients": 4, "slots": 4, "max_len": 64,
                   "quantized_cache": 8, "step_tokens": 4, "prompt_len": [4, 20],
                   "budget": [6, 14], "sizes_seed": 0, "pool": 64, "check_requests": 6},
}
#: (cell, configuration, traffic, the cell's limits)
CELLS = [
    ("tiny-mixtral-ppl", "tiny-mixtral-routed", "tiny-ppl", {"nll_gap": {"limit": 0.1}}),
    ("tiny-falcon-ppl", "tiny-falcon", "tiny-ppl", {"nll_gap": {"limit": 0.1}}),
    ("tiny-mixtral-serve", "tiny-mixtral-routed", "tiny-serve", {"served_gap": {"limit": 3.0}}),
]
#: a per-layer metric and a kernel name added by files alone
EXTRA_METRIC = ("windows_done.ppl", '''"""Windows scored in the window (a test metric)."""


def read(ctx):
    return ctx.facts.get("windows") if ctx.facts.get("kind") == "ppl" else None
''')
EXTRA_KERNEL = ("qmm", "extra.txt", "qmm_future_kernel\n")


def write_root(root: Path) -> Registry:
    """The tiny cells' files under `root`; a registry that finds them."""
    for kind, items in (("configs", CONFIGS), ("traffic", TRAFFIC)):
        (root / kind).mkdir(parents=True, exist_ok=True)
        for name, body in items.items():
            (root / kind / f"{name}.json").write_text(json.dumps(body))
    (root / "limits").mkdir(exist_ok=True)
    for cell, _, _, limits in CELLS:
        (root / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    (root / "metrics").mkdir(exist_ok=True)
    (root / "metrics" / f"{EXTRA_METRIC[0]}.py").write_text(EXTRA_METRIC[1])
    group, fname, body = EXTRA_KERNEL
    (root / "kernel_groups" / group).mkdir(parents=True, exist_ok=True)
    (root / "kernel_groups" / group / fname).write_text(body)
    return Registry([root])


def bench_with_tiny_cells() -> dict:
    """BENCHMARK.json with the tiny cells added to it, each metric that
    names cells extended to the tiny cells of the same traffic driver."""
    bench = copy.deepcopy(load_benchmark())
    kinds = {}
    for cell, config, traffic, _ in CELLS:
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a CPU test cell"})
        kinds.setdefault(TRAFFIC[traffic]["driver"], []).append(cell)
    driver_of = {"score_tok_per_s": "ppl", "gen_tok_per_s": "closed_loop_serve",
                 "tpot_p90_ms": "closed_loop_serve", "ttft_p90_ms": "closed_loop_serve"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = driver_of.get(m.get("moves", m["name"]), None)
            kind = kind or ("ppl" if m["name"].endswith(".ppl") else "closed_loop_serve")
            m["workloads"] = m["workloads"] + kinds.get(kind, [])
    bench["per_layer"].append({"name": EXTRA_METRIC[0], "unit": "windows", "better": "higher",
                               "source": "program_counter", "layer": "eval entry",
                               "moves": "score_tok_per_s",
                               "workloads": kinds["ppl"]})
    return bench
