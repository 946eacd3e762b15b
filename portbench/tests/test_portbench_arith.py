"""The benchmark's arithmetic on the CPU: percentiles, intervals, the
trace's reduction, the work counts against hand counts, and the seeded
mixes."""

import json

import numpy as np
import pytest
import torch

from portbench import stats, tracing, weights as W, work
from portbench.registry import PACKAGE, Registry


def _cfg(name):
    return json.loads((PACKAGE / "configs" / f"{name}.json").read_text())


MIXTRAL, FALCON = "mixtral-8x7b-w4g128", "falcon-7b-w4g64"


def test_percentile_interpolates_between_ranks():
    xs = list(range(1, 11))
    assert stats.percentile(xs, 90) == pytest.approx(9.1)
    assert stats.percentile(xs, 50) == pytest.approx(5.5)
    assert stats.percentile([3.0], 90) == 3.0
    assert stats.percentile(xs[::-1], 100) == 10
    for q in (10, 37, 90, 99):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_union_of_intervals():
    iv = [(5, 7), (0, 2), (1, 3), (3, 4), (10, 12)]
    assert stats.merge_intervals(iv) == [(0, 4), (5, 7), (10, 12)]
    assert sum(b - a for a, b in stats.merge_intervals(iv)) == 8
    assert stats.gaps(stats.merge_intervals(iv), 0, 11) == [(4, 5), (7, 10)]
    assert stats.gaps(stats.merge_intervals(iv), 1, 6) == [(4, 5)]
    assert stats.gaps([], 2, 3) == [(2, 3)]


def test_trace_reduction():
    ms = 1_000_000
    events = [
        ("bench.window", "user_annotation", 0, 100 * ms),
        ("serve.step_n", "user_annotation", 0, 60 * ms),
        ("aten::mm", "cpu_op", 1 * ms, 1 * ms),
        ("aten::item", "cpu_op", 45 * ms, 1 * ms),
        ("void qmm_gemv_kernel<4, 64>(int)", "kernel", 10 * ms, 15 * ms),
        ("void qmm_gemm_kernel<4>(int)", "kernel", 20 * ms, 20 * ms),  # overlaps the first
        ("flash_fwd_kernel", "kernel", 70 * ms, 10 * ms),
        ("Memcpy HtoD", "gpu_memcpy", 95 * ms, 10 * ms),  # runs past the window
        ("qmm_gemv_kernel_other", "kernel", 200 * ms, 5 * ms),  # outside the window
    ]
    groups = {"qmm": ["qmm_gemv_kernel", "qmm_gemm_kernel"], "flash": ["flash_fwd_kernel"]}
    out = tracing.reduce_events(events, groups)
    assert out["window_s"] == pytest.approx(0.1)
    assert out["busy_s"] == pytest.approx(0.030 + 0.010 + 0.005)
    assert out["group_s"] == pytest.approx({"qmm": 0.035, "flash": 0.010})
    assert out["device_ops"][0] == ["void qmm_gemm_kernel<4>(int)", pytest.approx(0.02)]
    idle = dict(out["idle_gaps"])
    assert idle["serve.step_n / aten::mm"] == pytest.approx(0.010)  # 0-10 ms
    assert idle["serve.step_n / aten::item"] == pytest.approx(0.030)  # 40-70 ms
    assert idle["outside spans / aten::item"] == pytest.approx(0.015)  # 80-95 ms
    assert sum(idle.values()) == pytest.approx(0.1 - out["busy_s"])


def test_kernel_groups_are_files():
    groups = Registry().kernel_groups()
    assert "qmm_gemv_kernel" in groups["qmm"] and "flash_fwd_kernel" in groups["flash"]
    assert not any(n.startswith("#") for names in groups.values() for n in names)


def test_work_counts_match_hand_counts():
    mix, fal = _cfg(MIXTRAL), _cfg(FALCON)
    # a token through Mixtral's linears: q, k, v, o and two of eight experts
    per_layer = 2 * (4096 * 4096 * 2 + 4096 * 1024 * 2) + 2 * 3 * 2 * 4096 * 14336
    assert work.linear_work(mix, 1).flops == 32 * per_layer == 25_232_932_864
    # every weight once: 4-bit codes plus a 2-byte scale and zero per group of 128
    w_layer = (2 * (4096 * 4096 // 2 + 32 * 4096 * 4) + 2 * (4096 * 1024 // 2 + 32 * 1024 * 4)
               + 8 * 3 * (4096 * 14336 // 2 + 32 * 14336 * 4))
    assert work.linear_work(mix, 0).bytes == 32 * w_layer == 24_670_896_128
    # Falcon-7B: q and o 4544 x 4544, k and v 4544 x 64, fc1 and fc2 4544 x 18176, g64
    per_layer = 2 * (2 * 4544 * 4544 + 2 * 4544 * 64 + 2 * 4544 * 18176)
    assert work.linear_work(fal, 1).flops == 32 * per_layer == 13_251_903_488
    w_fal = (2 * (4544 * 4544 // 2 + 71 * 4544 * 4) + 2 * (4544 * 64 // 2 + 71 * 64 * 4)
             + 2 * (4544 * 18176 // 2 + 71 * 18176 * 4))
    assert work.linear_work(fal, 0).bytes == 32 * w_fal == 3_727_097_856
    # causal attention of one 2048 window: 4·H·D·S(S+1)/2 a layer
    assert work.causal_attention_work(mix, [2048]).flops == 32 * 4 * 32 * 128 * 2048 * 2049 / 2
    assert work.causal_attention_work(fal, [2048]).flops == 32 * 4 * 71 * 64 * 2048 * 2049 / 2
    assert work.head_work(mix, 2047).flops == 2 * 2047 * 4096 * 32000
    assert work.router_work(mix, 10).flops == 32 * 2 * 10 * 4096 * 8
    assert work.router_work(fal, 10).flops == 0
    # a decode step: 3 live tokens at contexts 10, 20, 30 on the int8 cache
    step = work.decode_step_work(mix, [10, 20, 30], 1.0)
    assert step["attention"].flops == 32 * 4 * 32 * 128 * 60
    assert step["qmm"].flops == 3 * 25_232_932_864
    # an admission counts the real prompt tokens only
    adm = work.admission_work(mix, [8, 63])
    assert adm["qmm"].flops == 71 * 25_232_932_864
    assert adm["head"].flops == 2 * 2 * 4096 * 32000


def test_bounds():
    mix = _cfg(MIXTRAL)
    # a decode step of 64 tokens is bandwidth-bound: every weight byte once
    assert work.linear_bound_s(mix, 64) == pytest.approx(
        sum(max(w.flops / work.PEAK_FLOPS, w.bytes / work.PEAK_BYTES_PER_S)
            for w in work._layer_linears(mix, 64)) * 32)
    assert work.linear_bound_s(mix, 64) >= work.linear_work(mix, 0).bytes / work.PEAK_BYTES_PER_S
    # a 2048 window is compute-bound
    assert work.linear_bound_s(mix, 2048) == pytest.approx(
        work.linear_work(mix, 2048).flops / work.PEAK_FLOPS, rel=1e-3)


def _driver(kind, seed):
    from portbench.tests.tiny import CONFIGS, TRAFFIC

    traffic = TRAFFIC["tiny-ppl" if kind == "ppl" else "tiny-serve"]
    mod = Registry().module("drivers", traffic["driver"])
    return mod.Driver(cfg=CONFIGS["tiny-mixtral"], traffic=traffic, seed=seed,
                      device=torch.device("cpu"), tracer=tracing.Tracer(False))


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_ppl_windows_repeat_by_seed(seed):
    a, b, c = _driver("ppl", seed), _driver("ppl", seed), _driver("ppl", seed + 1)
    assert np.array_equal(a.tokens(5), b.tokens(5))
    assert not np.array_equal(a.tokens(5), a.tokens(6))
    assert not np.array_equal(a.tokens(5), c.tokens(5))
    assert a.tokens(0).shape == (1, 128)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_serving_mix_repeats_by_seed(seed):
    a, b, c = _driver("serve", seed), _driver("serve", seed), _driver("serve", seed + 1)
    assert a.sizes == b.sizes and a.prompt(3) == b.prompt(3)
    # every seed serves the same sizes in the same order, its own token ids
    assert a.sizes == c.sizes and a.prompt(3) != c.prompt(3)
    prompt, budget = a.prompt(7)
    lo, hi = a.traffic["prompt_len"]
    assert lo <= len(prompt) < hi and a.traffic["budget"][0] <= budget < a.traffic["budget"][1]


def test_weights_repeat_by_place_and_seed():
    from portbench.tests.tiny import CONFIGS

    cfg = CONFIGS["tiny-mixtral"]
    a = W.quant_linear(cfg, 9, 1, "gate", "cpu")
    b = W.quant_linear(cfg, 9, 1, "gate", "cpu")
    c = W.quant_linear(cfg, 9, 0, "gate", "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (4, 64, 128) and int(a[0].max()) <= 15
    w = W.dequant(*W.quant_linear(cfg, 9, 0, "down", "cpu"))  # K = 128
    assert w.std().item() == pytest.approx(1 / 128 ** 0.5, rel=0.05)


def test_outlier_channels_set_the_range_and_weigh_nothing():
    from portbench.tests.tiny import CONFIGS

    cfg = {**CONFIGS["tiny-falcon"],
           "weights": {**CONFIGS["tiny-falcon"]["weights"], "outlier_channels": 4,
                       "outlier_scale": 100.0}}
    rows = W.outlier_channels(cfg, 3, "cpu")
    assert len(set(rows.tolist())) == 4
    ln = W.layer_fp(cfg, 3, 1, "cpu")["ln1"]["w"].float()
    rest = torch.ones(64, dtype=torch.bool)
    rest[rows] = False
    assert ln[rows].abs().min() > 50 and ln[rest].abs().max() < 2
    for name in ("q", "k", "v", "fc1"):  # norm-fed: the outlier rows weigh 0
        w = W.dequant(*W.quant_linear(cfg, 3, 1, name, "cpu"))
        assert w[rows].abs().max() == 0 and w[rest].abs().max() > 0
    w = W.dequant(*W.quant_linear(cfg, 3, 1, "fc2", "cpu"))
    assert w[rows].abs().max() > 0


def test_route_code_picks_two_experts_by_a_wide_margin():
    """With `route_code`, no linear writes to the route channels, so the
    code stays in the residual stream, and every layer's router picks the
    token's two coded experts (through the layer's permutation) with every
    other expert's logit exactly 0."""
    from portbench.reference.decoder import Reference
    from portbench.tests.tiny import CONFIGS

    cfg = CONFIGS["tiny-mixtral-routed"]
    cols = W.route_channels(cfg, 3, "cpu")
    for name in ("o", "down"):
        w = W.dequant(*W.quant_linear(cfg, 3, 1, name, "cpu"))
        assert w[..., cols].abs().max() == 0 and w.abs().max() > 0
    embed = W.globals_fp(cfg, 3, "cpu")["embed"].float()
    code = embed[:, cols]
    assert ((code > 0).sum(-1) == 2).all()
    assert torch.equal(code.amax(-1), torch.full((code.shape[0],), 1.0))
    picked = torch.zeros(4)
    ref = Reference(cfg, 3, "cpu")
    toks = torch.arange(64)[None]
    h = embed[toks]
    for layer in range(cfg["model"]["num_layers"]):
        fp = W.layer_fp(cfg, 3, layer, "cpu")
        h = h + ref._attention(ref._norm(h, fp["ln1"]), layer)
        x = ref._norm(h, fp["ln2"])
        assert torch.equal(x[..., cols] > 0, code[toks] > 0)  # the code survives
        logits = x[0] @ fp["router"].float()
        assert ((logits > 0).sum(-1) == 2).all() and ((logits == 0).sum(-1) == 2).all()
        picked += (logits > 0).sum(0)
        h = h + ref._mlp(x, layer, fp)
    assert (picked > 0).all()  # every expert is picked by some token
