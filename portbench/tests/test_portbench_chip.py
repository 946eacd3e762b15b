"""On the card, at each cell's own size: the check's control (the port's
int8-activation path, `act` hook on every linear input, in place of the
configuration's bf16) comes out not correct on three seeds, and the
program itself correct. Readings besides, for the record: the plain
reference computed in bf16 with reduced-precision reductions allowed (a
plain bf16 model, one step below the program's fp32 reductions) in the
program's place. Each run takes a minute or two:

    python3 -m pytest portbench/tests/test_portbench_chip.py -m cuda -s
"""

import numpy as np
import pytest
import torch

from portbench.bench import run_cell, seed_words
from portbench.reference.decoder import Reference
from portbench.registry import Registry, load_benchmark

CELLS = {"mixtral-ppl-2048": 10.0, "falcon-ppl-2048": 10.0, "falcon-serve-64": 20.0}
SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(card, cell, seed):
    r = run_cell(cell, seed, CELLS[cell], False, "cuda", control=True)
    print(cell, seed, "control", r["checks"])
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_program_is_correct(card, cell):
    r = run_cell(cell, SEEDS[0], CELLS[cell], False, "cuda")
    print(cell, SEEDS[0], "program", r["checks"])
    assert r["correct"], r["checks"]


def bf16_witness(cell: str, seed: int) -> dict:
    """The cell's check numbers with the plain reference in bf16 in the
    program's place: PPL, the NLL gap a token over `check_windows` windows;
    serving, at every position of `check_requests` sequences of the mix's
    longest sizes, the gap of the token that bf16 puts first."""
    reg = Registry()
    c = next(w for w in load_benchmark()["workloads"] if w["name"] == cell)
    cfg, t = reg.json("configs", c["config"]), reg.json("traffic", c["traffic"])
    rng = np.random.default_rng(seed_words(seed, 5))
    vocab = cfg["model"]["vocab_size"]
    lo16 = Reference(cfg, seed, "cuda", torch.bfloat16)
    if t["driver"] == "ppl":
        toks = torch.from_numpy(rng.integers(0, vocab, (t["check_windows"], t["seqlen"])))
        got = lo16.mean_nll(toks)
        want = Reference(cfg, seed, "cuda").mean_nll(toks)
        return {"nll_gap": (got - want).abs().max().item()}
    plen, width = t["prompt_len"][1] - 1, t["prompt_len"][1] + t["budget"][1] - 3
    toks = torch.from_numpy(rng.integers(0, vocab, (t["check_requests"], width)))
    served = slice(plen - 1, width)
    first = lo16.logits(lo16.hidden(toks)[:, served]).argmax(-1)
    ref = Reference(cfg, seed, "cuda")
    logits = ref.logits(ref.hidden(toks)[:, served])
    gaps = logits.amax(-1) - logits.gather(-1, first[..., None])[..., 0]
    return {"served_gap": gaps.max().item()}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_plain_bf16_readings(card, cell, seed):
    limits = Registry().json("limits", cell)
    got = bf16_witness(cell, seed)
    print(cell, seed, "bf16 reference", got, "limits", {k: limits[k]["limit"] for k in got})
    assert set(got) == set(limits) and all(0 < v < float("inf") for v in got.values()), got
