"""Port parity: `ServingEngine` on its default pool, the fp cache.

Both engines are built without `quantized_cache`, so both take the fp
cache in `cfg.dtype` (bf16 for TINY_LLAMA, fp32 activations): prefill
into the scratch cache, `_splice` into the pool, per-row decode through
B6 on each layer view (JAX interpreted). `windowed_ok` is False for an fp
cache, so every k-token window runs k per-slot steps. The streams of
`step` / `step_n` / `run_pipelined` must equal the JAX engine's, and
`run_pipelined` the port's own sequential `step_n` loop. Setup as in
tests/test_torch_serving.py.
"""

import pytest
import torch

from llama3_quantization_tpu.models import TINY_LLAMA
from llama3_quantization_tpu.serving import ServingEngine as JEngine
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.serving import ServingEngine as TEngine
from test_torch_model import jax_kernel_route, models  # noqa: F401  (fixtures)
from test_torch_serving import streams
from test_torch_serving_pipelined import LENS, PROMPTS, sequential, submit_all

torch.set_num_threads(1)

pytestmark = pytest.mark.big_compile


def run_default(models, drive, **kw):
    """`drive(engine)` on a JAX and a port engine with the default cache."""
    jparams, tparams = models
    jeng = JEngine(jparams, TINY_LLAMA, **kw)
    teng = TEngine(tparams, tcfg.TINY_LLAMA, device="cpu", **kw)
    assert sorted(teng.cache) == sorted(jeng.cache) == ["k", "v"]
    assert teng.cache["k"].dtype == torch.bfloat16
    return drive(jeng), drive(teng)


def test_fp_engine_step_and_step_n(models, jax_kernel_route):
    """Per-step decode with a request joining mid-flight, then k = 4
    windows with a mid-window finish and slot reuse."""
    def drive(eng):
        r1 = eng.add_request([1, 2, 3], max_new_tokens=8)
        for _ in range(3):
            eng.step()
        r2 = eng.add_request([4, 4, 4, 4], max_new_tokens=5)
        eng.run()
        rids = eng.add_requests([([3, 5, 7], 7, None), (list(range(1, 20)), 3, None)])
        eng.run(max_steps=50, step_tokens=4)
        return [eng.result(r) for r in (r1, r2, *rids)]

    ref, got = run_default(models, drive, max_slots=2, max_len=64)
    assert got == ref and [len(g) for g in got] == [8, 5, 7, 3]


def test_fp_engine_run_pipelined(models, jax_kernel_route):
    def drive(eng):
        submit_all(eng, PROMPTS, LENS)
        eng.run_pipelined(4)
        return streams(eng)

    ref, got = run_default(models, drive, max_slots=2, max_len=64, schedule="ljf")
    assert got == ref and sorted(len(g) for g in got.values()) == sorted(LENS)
    seq = TEngine(models[1], tcfg.TINY_LLAMA, max_slots=2, max_len=64, schedule="ljf",
                  device="cpu")
    assert sequential(seq, PROMPTS, LENS, 4, ljf=True) == sorted(tuple(g) for g in got.values())
    assert seq.dispatches["windowed"] == 0 and seq.dispatches["per_step"] > 0
