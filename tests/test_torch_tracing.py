"""The port's spans and counters (`utils/profiling.py`: `span`, `count`,
`entry_point`, `recording`, `recorded`) at its layer boundaries, on the CPU:

- with no profiler running, the model's forward, `step_n` and
  `run_pipelined` enter no `record_function` and record nothing;
- under `torch.profiler.profile` the spans reach the profiler's trace as
  `user_annotation` events, nested `model.attn` in `model.layer` in
  `model.step` in `engine.dispatch` (the per-slot decode of the fp and int8
  caches, and the windowed decode), except where kineto's events do not
  name their kind (`TRACE_SPANS`);
- the counters equal hand counts: prompt tokens against `max_slots x
  bucket` prefill positions, decode steps, KV positions used against
  reserved, and the MoE's rows under the dense, routed and capacity
  dispatches;
- self time is a span's duration less its children's (a fake clock);
- a second profiled region starts from an empty recording.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import llama3_quantization_tpu_torch as P
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.serving.engine import ServingEngine
from llama3_quantization_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)

EMPTY = {"spans": {}, "counts": {}}


def _params(cfg):
    return P.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                         device="cpu")


def _engine(cfg, quantized_cache, max_slots=4, max_len=64):
    return ServingEngine(_params(cfg), cfg, max_slots=max_slots, max_len=max_len,
                         quantized_cache=quantized_cache, device="cpu")


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered with recording off")


def test_off_enters_no_record_function_and_records_nothing(monkeypatch):
    with prof.recording():
        pass  # an empty recording to compare against
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    cfg = tcfg.TINY_MIXTRAL
    TT.forward_hidden(_params(cfg), torch.randint(0, cfg.vocab_size, (2, 8)), cfg)
    eng = _engine(tcfg.TINY_FALCON, False)
    eng.add_requests([([1, 2, 3], 5, None), ([4, 5, 6, 7], 4, None)])
    eng.step_n(3)
    for p, n in (([1, 2, 3, 4], 6), ([9, 8, 7], 3)):
        eng.submit(p, n)
    eng.run_pipelined(2)
    assert not prof.ON
    assert prof.recorded() == EMPTY


def _annotations(p):
    """{name: [(start, end)]} of the profiler's user annotations."""
    spans = {}
    for e in p.profiler.kineto_results.events():
        if e.activity_type() == "user_annotation":
            spans.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return spans


def _inside(iv, outers):
    return any(a <= iv[0] and iv[1] <= b for a, b in outers)


@pytest.mark.parametrize("cfg,cache,route", [
    (tcfg.TINY_FALCON, False, "per_step"),
    (tcfg.TINY_MIXTRAL, 8, "per_step"),
    (tcfg.TINY_LLAMA, 8, "windowed"),
], ids=["falcon-bf16", "mixtral-int8", "llama-int8-windowed"])
def test_spans_nest_in_the_profilers_trace(cfg, cache, route):
    if not cache:
        cfg = tcfg.ModelConfig(**{**cfg.__dict__, "dtype": "bfloat16"})
    eng = _engine(cfg, cache)
    k = 3
    with profile(activities=[ProfilerActivity.CPU]) as p:
        eng.add_requests([([1, 2, 3], 8, None), ([4, 5, 6, 7, 8], 8, None)])
        eng.step_n(k)
    assert eng.dispatches[route] == 1
    spans = _annotations(p)
    dispatch = spans["engine.dispatch"]
    steps = [iv for iv in spans["model.step"] if _inside(iv, dispatch)]
    layers = [iv for iv in spans["model.layer"] if _inside(iv, steps)]
    attns = [iv for iv in spans["model.attn"] if _inside(iv, layers)]
    assert len(dispatch) == 1 and len(steps) == k
    assert len(layers) == len(attns) == k * cfg.num_layers
    assert all(_inside(iv, spans["model.layer"]) for iv in spans["model.attn"])
    assert all(_inside(iv, spans["engine.admit"]) for iv in spans["engine.prefill"])
    rec = prof.recorded()["spans"]
    assert rec["engine.dispatch"]["model.attn"]["n"] == k * cfg.num_layers
    assert rec["engine.admit"]["model.attn"]["n"] == cfg.num_layers


def test_spans_stay_out_of_a_trace_that_cannot_tell_them_from_kernels(monkeypatch):
    """Where kineto's events do not name their kind (`TRACE_SPANS` off),
    a profiled region records the spans' totals and enters no
    `record_function`."""
    monkeypatch.setattr(prof, "TRACE_SPANS", False)
    eng = _engine(tcfg.TINY_FALCON, False)
    eng.add_requests([([1, 2, 3], 8, None)])
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step_n(2)
    assert prof.recorded()["spans"]["engine.dispatch"]["model.step"]["n"] == 2


def test_engine_counters_equal_hand_counts():
    max_slots, max_len = 4, 64
    eng = _engine(tcfg.TINY_FALCON, False, max_slots, max_len)
    prompts = [list(range(1, n + 1)) for n in (5, 9, 62)]
    with prof.recording():
        eng.add_requests([(p, 8, None) for p in prompts])
        live = list(eng._slot_req)
        pos = eng.pos.copy()
        eng.step_n(3)
        eng.step()
    c = prof.recorded()["counts"]
    assert c["engine.prompt_tokens"] == 5 + 9 + 62
    assert c["engine.prefill_positions"] == max_slots * 63  # bucket min(64, max_len - 1)
    assert c["engine.decode_steps"] == 4
    used = sum(min(pos[s] + i, max_len) for s in live for i in range(4))
    assert c["engine.kv_used"] == used
    assert c["engine.kv_reserved"] == 4 * max_slots * max_len


@pytest.mark.parametrize("capacity,seqlen", [
    pytest.param(None, 8, id="None"),
    pytest.param(1.0, 8, id="1.0"),
    pytest.param(None, 256, id="routed"),
    pytest.param(None, 40, id="routed-padded"),
])
def test_moe_counters_equal_hand_counts(monkeypatch, capacity, seqlen):
    """With the switch set at 64 rows: T = 16, dense (every expert on every
    token) and capacity dispatch; T = 512, routed, each expert on its own
    picks alone (every expert has more than 64); T = 80, routed, each
    expert's ~40 picks padded to the 65 rows of the call's kernel route,
    computed but not routed."""
    cfg = tcfg.TINY_MIXTRAL
    e, k, n_layers = cfg.num_experts, cfg.num_experts_per_tok, cfg.num_layers
    monkeypatch.setattr(TT, "MOE_ROUTED_ABOVE", 64)
    monkeypatch.setattr(TT, "_MOE_CAPACITY", None)
    TT.set_moe_capacity(capacity)
    picks = []
    topk = TT._moe_topk

    def recording_topk(*args):
        out = topk(*args)
        picks.append(out[1].reshape(-1, k))
        return out

    monkeypatch.setattr(TT, "_moe_topk", recording_topk)
    params = _params(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, seqlen),
                           generator=torch.Generator().manual_seed(1))
    t = tokens.numel()
    with prof.recording():
        TT.forward_hidden(params, tokens, cfg)
    c = prof.recorded()["counts"]
    assert len(picks) == n_layers
    per_layer = [np.bincount(pk.reshape(-1).numpy(), minlength=e) for pk in picks]
    if capacity is None and t > 64:
        assert c["moe.rows_computed"] == sum(max(n, 65) for x in per_layer for n in x if n)
        assert c["moe.rows_routed"] == t * k * n_layers
        assert c["moe.tokens_per_expert"] == sum(per_layer).tolist()
        padded = sum(0 < n <= 64 for x in per_layer for n in x)
        assert (padded == 0) if t > 256 else (padded > 0)
    elif capacity is None:
        assert c["moe.rows_computed"] == t * e * n_layers
        assert c["moe.rows_routed"] == t * k * n_layers
        assert c["moe.tokens_per_expert"] == sum(per_layer).tolist()
    else:
        cap = -(-min(t, -(-int(capacity * k * t) // e)) // 8) * 8
        kept = [np.minimum(n, cap) for n in per_layer]
        assert c["moe.rows_computed"] == e * cap * n_layers
        assert c["moe.rows_routed"] == sum(int(x.sum()) for x in kept)
        assert c["moe.tokens_per_expert"] == sum(kept).tolist()


def test_self_time_is_duration_less_children(monkeypatch):
    ticks = iter([0.0, 1.0, 2.0, 5.0, 6.0, 7.0, 9.0, 10.0, 20.0, 23.0])
    monkeypatch.setattr(prof, "_clock", lambda: next(ticks))
    with prof.recording():
        with prof.span("engine.dispatch"):          # 0 .. 10
            with prof.span("model.step"):           # 1 .. 9
                with prof.span("model.layer"):      # 2 .. 5
                    pass
                with prof.span("model.layer"):      # 6 .. 7
                    pass
        with prof.span("model.step"):               # 20 .. 23, under no engine span
            pass
    spans = prof.recorded()["spans"]
    assert spans["engine.dispatch"] == {
        "engine.dispatch": {"n": 1, "total_s": 10.0, "self_s": 2.0},
        "model.step": {"n": 1, "total_s": 8.0, "self_s": 4.0},
        "model.layer": {"n": 2, "total_s": 4.0, "self_s": 4.0},
    }
    assert spans[""] == {"model.step": {"n": 1, "total_s": 3.0, "self_s": 3.0}}


def test_a_second_profiled_region_starts_empty():
    """A profiled region, its recording read and kept while the engine
    runs outside any profiler, then a second profiled region: the
    recording holds the second region's work alone."""
    eng = _engine(tcfg.TINY_FALCON, False)
    with profile(activities=[ProfilerActivity.CPU]):
        eng.add_requests([([1, 2, 3], 12, None)])
        eng.step_n(2)
    assert prof.recorded()["counts"]["engine.decode_steps"] == 2
    eng.step_n(1)
    assert prof.recorded()["counts"]["engine.decode_steps"] == 2  # kept: recording is off
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step_n(3)
    rec = prof.recorded()
    assert rec["counts"]["engine.decode_steps"] == 3
    assert "engine.prompt_tokens" not in rec["counts"] and "engine.admit" not in rec["spans"]
    assert rec["spans"]["engine.dispatch"]["model.step"]["n"] == 3
