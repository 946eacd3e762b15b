"""Port parity: the continuous-batching `ServingEngine`, per-step and k-step.

The port's engine and the JAX package's run the same calls on the request
mixes of tests/test_serving.py (single sequences, a request joining
mid-flight, slot reuse, eos, `step_n` with a mid-window finish) and must
give identical token streams. TINY_LLAMA W4 g32 packed is carried across
with `convert.params_from_numpy`; JAX runs on its kernel route
(`jax_kernel_route` of tests/test_torch_model.py). Both engines use the
int8 (and here once the int4) cache, asked for explicitly; the default fp
cache is in tests/test_torch_serving_fp.py. `run_pipelined` and the
scheduling clamps are in tests/test_torch_serving_pipelined.py.
"""

import numpy as np
import pytest
import torch

from llama3_quantization_tpu.models import TINY_LLAMA
from llama3_quantization_tpu.serving import ServingEngine as JEngine
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.serving import ServingEngine as TEngine
from test_torch_model import jax_kernel_route, models  # noqa: F401  (fixtures)

torch.set_num_threads(1)

# the interpret-mode decode programs are large CPU compiles (tests/test_windowed.py)
pytestmark = pytest.mark.big_compile


def run_both(models, drive, **kw):
    """`drive(engine)` on a JAX and a port engine built with `kw`; returns
    both results."""
    jparams, tparams = models
    kw.setdefault("quantized_cache", 8)
    jeng = JEngine(jparams, TINY_LLAMA, **kw)
    teng = TEngine(tparams, tcfg.TINY_LLAMA, device="cpu", **kw)
    return drive(jeng), drive(teng)


def streams(eng):
    return {rid: list(r.generated) for rid, r in sorted(eng.requests.items())}


def test_engine_single_sequences(models, jax_kernel_route):
    """Three requests decoded per step (`decode_step_multi`, B4 per layer)."""
    def drive(eng):
        rids = [eng.add_request(p, max_new_tokens=6) for p in ([1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5])]
        eng.run()
        return [eng.result(r) for r in rids]

    ref, got = run_both(models, drive, max_slots=4, max_len=64)
    assert got == ref and all(len(g) == 6 for g in got)


def test_engine_continuous_join_and_slot_reuse(models, jax_kernel_route):
    """A request joins after three steps; two finish and free their slots;
    a third reuses one."""
    def drive(eng):
        r1 = eng.add_request([1, 2, 3], max_new_tokens=8)
        for _ in range(3):
            eng.step()
        r2 = eng.add_request([4, 4, 4, 4], max_new_tokens=5)
        eng.run()
        assert len(eng.free) == 2
        r3 = eng.add_request([7, 8, 9], max_new_tokens=4)
        eng.run()
        return [eng.result(r) for r in (r1, r2, r3)]

    ref, got = run_both(models, drive, max_slots=2, max_len=64)
    assert got == ref


def test_engine_eos_stops(models, jax_kernel_route):
    """eos = the stream's first token: the request ends there and its slot
    frees."""
    def drive(eng):
        probe = eng.add_request([1, 2, 3], max_new_tokens=4)
        eng.run()
        first = eng.result(probe)[0]
        rid = eng.add_request([1, 2, 3], max_new_tokens=50, eos_id=first)
        eng.run()
        assert len(eng.free) == 1
        return first, eng.result(rid)

    ref, got = run_both(models, drive, max_slots=1, max_len=64)
    assert got == ref and got[1] == [got[0]]


@pytest.mark.parametrize("bits", [8, 4])
def test_step_n_windowed(models, jax_kernel_route, bits):
    """k = 4 windows (the windowed decode) with a request that finishes
    mid-window; batched admission of mixed buckets."""
    prompts = [[3, 5, 7], [11, 2], list(range(1, 20))]
    lens = [7, 3, 10]

    def drive(eng):
        rids = eng.add_requests([(p, n, None) for p, n in zip(prompts, lens)])
        eng.run(max_steps=50, step_tokens=4)
        return [list(eng.requests[r].generated) for r in rids]

    ref, got = run_both(models, drive, max_slots=4, max_len=64, quantized_cache=bits)
    assert got == ref
    assert [len(g) for g in got] == lens


def test_engine_guards():
    """Full pool, oversized prompt, an unknown schedule or cache kind; the
    default pool is the fp cache, as in JAX."""
    params = {}
    assert sorted(TEngine(params, tcfg.TINY_LLAMA, device="cpu").cache) == ["k", "v"]
    with pytest.raises(ValueError):
        TEngine(params, tcfg.TINY_LLAMA, quantized_cache=3, device="cpu")
    with pytest.raises(ValueError):
        TEngine(params, tcfg.TINY_LLAMA, schedule="sjf", device="cpu")
    eng = TEngine(params, tcfg.TINY_LLAMA, max_slots=1, max_len=32, device="cpu")
    with pytest.raises(ValueError):
        eng.add_request(list(range(40)))
    with pytest.raises(RuntimeError):
        eng.add_requests([([1], 2, None)] * 2)


def test_engine_sampling_is_seeded(models):
    """temperature > 0 draws from the engine's seeded generator: a seed
    repeats its stream, and greedy ignores the seed."""
    _, tparams = models

    def run(seed, temperature):
        eng = TEngine(tparams, tcfg.TINY_LLAMA, max_slots=2, max_len=64, quantized_cache=8,
                      temperature=temperature, seed=seed, device="cpu")
        rid = eng.add_request(list(range(1, 9)), max_new_tokens=10)
        eng.run(step_tokens=4)
        return eng.result(rid)

    assert run(0, 0.0) == run(5, 0.0)
    s1, s2, s3 = run(1, 1.5), run(1, 1.5), run(2, 1.5)
    assert s1 == s2 and len(s1) == 10
    assert s1 != s3 or s1 != run(0, 0.0)
    assert all(0 <= t < tcfg.TINY_LLAMA.vocab_size for t in s1 + s3)


def test_engine_streams_are_tokens(models):
    """`streams` of a finished engine: every request has its budget."""
    _, tparams = models
    eng = TEngine(tparams, tcfg.TINY_LLAMA, max_slots=2, max_len=64, quantized_cache=8,
                  device="cpu")
    for p, n in (([1, 2], 3), ([4, 5, 6], 5), ([7], 2)):
        eng.submit(p, n)
    eng.run_pipelined(4)
    assert sorted(len(g) for g in streams(eng).values()) == [2, 3, 5]
    assert sorted(eng.free) == [0, 1] and eng.dispatches["windowed"] > 0
    np.testing.assert_array_less(-1, np.concatenate([g for g in streams(eng).values()]))
