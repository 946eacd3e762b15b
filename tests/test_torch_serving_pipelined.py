"""Port parity: `ServingEngine.run_pipelined` and its scheduling clamps.

The port's engine and the JAX package's take the same submits on the mixes
of tests/test_serving.py (the pipelined-vs-sequential mix, the prefree and
drain clamp, the ring-headroom clamp) and on an `ljf` mix over int8 and
int4 caches, and must give identical token streams. Within the port,
`run_pipelined` must also give the streams of the sequential `step_n`
loop. Setup as in tests/test_torch_serving.py.
"""

import pytest
import torch

from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.serving import ServingEngine as TEngine
from test_torch_model import jax_kernel_route, models  # noqa: F401  (fixtures)
from test_torch_serving import run_both, streams

torch.set_num_threads(1)

pytestmark = pytest.mark.big_compile

PROMPTS = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5], [2, 4, 6], [7, 7, 1], [3, 1, 4, 1, 5]]
LENS = [9, 5, 7, 12, 4, 6]


def submit_all(eng, prompts, lens):
    for p, n in zip(prompts, lens):
        eng.submit(p, n, None)


def sequential(eng, prompts, lens, k, ljf=False):
    """The sequential `step_n` loop of tests/test_serving.py:539-557:
    admit into free slots (pop from the end, longest first under `ljf`),
    run one window, repeat."""
    pend = list(zip(prompts, lens))
    if ljf:
        pend.sort(key=lambda r: r[1])

    def feed():
        batch = []
        while eng.free and len(batch) < len(eng.free) and pend:
            p, n = pend.pop()
            batch.append((p, n, None))
        if batch:
            eng.add_requests(batch)

    feed()
    while eng._slot_req:
        eng.step_n(k)
        if eng.free and pend:
            feed()
    return sorted(tuple(g) for g in streams(eng).values())


def test_run_pipelined_matches_jax_and_sequential(models, jax_kernel_route):
    def drive(eng):
        submit_all(eng, PROMPTS, LENS)
        eng.run_pipelined(4)
        return streams(eng)

    ref, got = run_both(models, drive, max_slots=2, max_len=64)
    assert got == ref
    assert sorted(len(g) for g in got.values()) == sorted(LENS)
    seq = TEngine(models[1], tcfg.TINY_LLAMA, max_slots=2, max_len=64, quantized_cache=8,
                  device="cpu")
    assert sequential(seq, PROMPTS, LENS, 4) == sorted(tuple(g) for g in got.values())


def test_prefree_and_drain_clamp(models, jax_kernel_route):
    """One slot, two budget-bound requests, k = 8 > budget 3: windows of 2
    then 1 (rounded down into `_window_sizes`), and the slot passes to the
    second request at dispatch time of the first one's last window."""
    def drive(eng):
        assert eng._window_sizes(12) == [1, 2, 4, 8, 12]
        eng.submit([1, 2, 3, 4], 3, None)
        eng.submit([9, 8, 7], 3, None)
        eng.run_pipelined(8)
        assert sorted(eng.free) == [0]
        assert all(r.done and r.freed for r in eng.requests.values())
        return streams(eng)

    ref, got = run_both(models, drive, max_slots=1, max_len=64)
    assert got == ref and [len(g) for g in got.values()] == [3, 3]


def test_ring_headroom_clamp(models, jax_kernel_route):
    """A ring the workload nearly fills (max_len 24, prompt + generation up
    to 21): windows shrink near its end and stay windowed."""
    prompts, lens = [[1, 2, 3, 4, 5], [9, 8, 7]], [16, 14]

    def drive(eng):
        submit_all(eng, prompts, lens)
        eng.run_pipelined(8)
        return streams(eng)

    ref, got = run_both(models, drive, max_slots=2, max_len=24)
    assert got == ref
    seq = TEngine(models[1], tcfg.TINY_LLAMA, max_slots=2, max_len=24, quantized_cache=8,
                  device="cpu")
    assert sequential(seq, prompts, lens, 8) == sorted(tuple(g) for g in got.values())


@pytest.mark.parametrize("bits", [8, 4])
def test_ljf_pipelined(models, jax_kernel_route, bits):
    """`ljf` admission over int8 and int4 caches: the longest budgets admit
    first; streams equal JAX's and the port's sequential loop's."""
    prompts = PROMPTS + [[6, 6], [8, 1, 8, 1, 8, 1, 8]]
    lens = LENS + [10, 3]

    def drive(eng):
        submit_all(eng, prompts, lens)
        eng.run_pipelined(4)
        return streams(eng)

    ref, got = run_both(models, drive, max_slots=3, max_len=64, quantized_cache=bits,
                        schedule="ljf")
    assert got == ref
    assert [len(g) for g in got.values()][:3] == sorted(lens, reverse=True)[:3]
    seq = TEngine(models[1], tcfg.TINY_LLAMA, max_slots=3, max_len=64, quantized_cache=bits,
                  schedule="ljf", device="cpu")
    assert sequential(seq, prompts, lens, 4, ljf=True) == sorted(tuple(g) for g in got.values())
