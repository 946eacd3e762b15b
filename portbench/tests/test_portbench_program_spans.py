"""The per-layer metrics that read the port's own spans and counters
(`portbench/recorder.py`), in whole traced runs of the tiny cells on the
CPU: each is reported where it applies, within its range."""

import math

import pytest

from portbench.bench import run_cell
from portbench.tests import tiny

SEED = 2**31 + 54321
SERVE_SHARES = ("prefill_useful_share.serve", "attn_dispatch_share.serve", "kv_used_share.serve")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return tiny.write_root(tmp_path_factory.mktemp("spans")), tiny.bench_with_tiny_cells()


def _traced(setup, cell):
    """A traced run; serving windows long enough to finish requests on a
    busy CPU."""
    reg, bench = setup
    r = run_cell(cell, SEED, 8.0 if "serve" in cell else 1.5, True, "cpu", registry=reg,
                 bench=bench)
    assert r["correct"], r["checks"]
    return {name: m["value"] for name, m in r["metrics"].items()}


@pytest.mark.parametrize("cell,k_over_e", [("tiny-mixtral-ppl", 2 / 4), ("tiny-falcon-ppl", None)])
def test_moe_useful_share_where_there_is_a_moe(setup, cell, k_over_e):
    got = _traced(setup, cell)
    if k_over_e is None:
        assert "moe_useful_share.ppl" not in got
    else:
        assert got["moe_useful_share.ppl"] == pytest.approx(100 * k_over_e, abs=1e-9)
    assert not set(SERVE_SHARES) & set(got)


def test_serving_metrics_from_the_engine(setup):
    got = _traced(setup, "tiny-mixtral-serve")
    for name in SERVE_SHARES:
        assert 0 < got[name] <= 100, (name, got[name])
    assert got["dispatch_ms_per_step.serve"] > 0
    assert math.isfinite(got["dispatch_ms_per_step.serve"])
    assert "moe_useful_share.ppl" not in got
