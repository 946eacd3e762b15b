"""Whole runs of tiny cells on the CPU, driven past the look for a card:
the cells, their configurations, mixes, limits, a per-layer metric and a
kernel name all come from files in a temporary folder, as a later change
would add them. With the timed path broken underneath, `correct` comes
out false, once for each fault the cells can have."""

import math

import pytest
import torch

import llama3_quantization_tpu_torch.eval.ppl as ppl_mod
import llama3_quantization_tpu_torch.models.transformer as tf_mod
import llama3_quantization_tpu_torch.serving.engine as engine_mod

from portbench.bench import run_cell
from portbench.tests import tiny

SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    reg = tiny.write_root(tmp_path_factory.mktemp("cells"))
    return reg, tiny.bench_with_tiny_cells()


def _run(setup, cell, trace=False, seconds=None, **kw):
    """A run of `cell`; serving windows long enough to finish requests on a
    busy CPU."""
    reg, bench = setup
    seconds = seconds or (3.0 if "serve" in cell else 1.5)
    return run_cell(cell, SEED, seconds, trace, "cpu", registry=reg, bench=bench, **kw)


@pytest.mark.parametrize("cell", [c for c, *_ in tiny.CELLS])
def test_tiny_cell_runs_and_is_correct(setup, cell):
    r = _run(setup, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    want = {"setup_s"} | ({"score_tok_per_s"} if "ppl" in cell
                          else {"gen_tok_per_s", "tpot_p90_ms", "ttft_p90_ms"})
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 and math.isfinite(v["value"]) for v in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", ["tiny-falcon-ppl", "tiny-mixtral-serve"])
def test_tiny_cell_traced(setup, cell):
    r = _run(setup, cell, trace=True, seconds=4.0)
    assert r["correct"], r["checks"]
    names = set(r["metrics"])
    if "ppl" in cell:
        # added by a file alone; rooflines and idle share need the card
        assert {"mfu.ppl", "windows_done.ppl"} <= names
        assert "roofline.qmm.ppl" not in names and "idle_share.ppl" not in names
    else:
        assert {"slot_occupancy.serve", "admit_share.serve", "mfu.serve"} <= names
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_added_files_are_found(setup):
    reg, _ = setup
    assert "qmm_future_kernel" in reg.kernel_groups()["qmm"]
    assert "qmm_gemv_kernel" in reg.kernel_groups()["qmm"]  # the union with the package's
    assert reg.json("configs", "tiny-falcon")["model"]["arch"] == "falcon"
    # a metric of a family already read needs no reader of its own
    assert reg.reader("idle_share.ppl") is reg.reader("idle_share.serve")
    assert reg.reader("idle_share.train") is reg.reader("idle_share.ppl")
    assert reg.reader("windows_done.ppl") is not reg.reader("idle_share.ppl")
    with pytest.raises(FileNotFoundError):
        reg.reader("no_such_metric.ppl")
    assert reg.json("configs", "mixtral-8x7b-w4g128")["model"]["num_experts"] == 8


def test_control_changes_the_arithmetic(setup):
    """The control (the port's int8-activation path) runs the same cell and
    reads another distance than the configuration's bf16 path."""
    sound = _run(setup, "tiny-falcon-ppl")["checks"]["nll_gap"]["value"]
    control = _run(setup, "tiny-falcon-ppl", control=True)["checks"]["nll_gap"]["value"]
    assert control != sound


def _answer_altered(orig):
    return lambda *a, **k: orig(*a, **k) * 1.05


def _half_batch(orig):
    def nll(params, hidden, targets, cfg, chunk):
        half = hidden.shape[1] // 2  # the window's positions: half left out, mean of the rest
        return orig(params, hidden[:, :half], targets[:, :half], cfg, chunk) * (
            targets.shape[1] / half)
    return nll


def _state_unchanged(orig):
    def update(cache, layer, k, v, pos):
        if k.shape[1] != 1:  # prefills write; every decode step leaves the cache as it was
            orig(cache, layer, k, v, pos)
    return update


def _rows_copied(orig):
    def pick(logits, *a, **k):
        out = orig(logits, *a, **k).clone()
        half = out.shape[0] // 2
        out[half:2 * half] = out[:half]  # half of the batch left out: the rest's tokens
        return out
    return pick


def _token_altered(orig):
    calls = [0]

    def pick(logits, *a, **k):
        out = orig(logits, *a, **k)
        calls[0] += 1
        return (out + 1) % logits.shape[-1] if calls[0] % 3 == 0 else out
    return pick


FAULTS = [
    ("tiny-mixtral-ppl", ppl_mod, "_chunked_nll", _answer_altered),
    ("tiny-falcon-ppl", ppl_mod, "_chunked_nll", _answer_altered),
    ("tiny-mixtral-ppl", ppl_mod, "_chunked_nll", _half_batch),
    ("tiny-falcon-ppl", ppl_mod, "_chunked_nll", _half_batch),
    ("tiny-mixtral-serve", tf_mod, "cache_update_stacked", _state_unchanged),
    ("tiny-mixtral-serve", engine_mod, "sample_logits", _rows_copied),
    ("tiny-mixtral-serve", engine_mod, "sample_logits", _token_altered),
]


@pytest.mark.parametrize("cell,module,name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, _, _, f in FAULTS])
def test_fault_fails_the_check(setup, monkeypatch, cell, module, name, fault):
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    r = _run(setup, cell)
    assert not r["correct"], r["checks"]


def test_no_card_no_result(capsys):
    """Without a card the command prints no result and exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from portbench import run

    assert run.main(["--workload", "falcon-ppl-2048", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
