"""Port parity: Mixtral's sparse MoE (`TINY_MIXTRAL`: 4 experts, top 2).

The ten tests of `tests/test_moe.py` that need no mesh, run on both
packages with the same weights (JAX's `init_params`, PRNGKey 0, fp32,
carried by `convert.params_from_numpy`), and the MoE cases of
`tests/test_gptq.py`, `test_serving.py` and `test_nf4_irqlora.py`.
Tolerances:

- dense and capacity forwards with fp weights: within 1e-5 of max|logit|
  of JAX's (the port under JAX's default "xla" backend); the capacity
  path with room for every pick within JAX's own 2e-4 of the dense one;
- decode on the int8 cache and greedy streams (W4 g32 packed, the port's
  kernel route against JAX's, `jax_kernel_route`): teacher-forced decode
  within 2e-2 of the forward's max|logit| (the int8 cache's rounding),
  streams identical; the int8 engine never windows (JAX's
  gate, `windowed.py:107`);
- codes exact for RTN and `recode_model_s8` on the `[L, E, K, N]` expert
  stacks; GPTQ, AWQ and OmniQuant codes agree on more than 99% of entries
  in every linear and expert stack (tests/test_torch_gptq.py); HQQ's and
  IR-QLoRA's logits within 1e-4 and 1e-5 (tests/test_torch_hqq.py,
  tests/test_torch_nf4_irqlora.py); SmoothQuant within 1e-5;
- the loader's tree bit-equal to JAX's on a Mixtral HF directory written
  here.

Mirrored quirk (ROADMAP C): `init_quantized_params(TINY_MIXTRAL)` builds
JAX's tree, `fc1`/`fc2` and biased LayerNorms but no router and no
experts, which neither package's forward can run.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import hf_loader as JL
from llama3_quantization_tpu.models import params as JP
from llama3_quantization_tpu.models import synthetic as JSY
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.quant import QuantSpec as JSpec
from llama3_quantization_tpu.quant import awq as JA
from llama3_quantization_tpu.quant import calibration as JC
from llama3_quantization_tpu.quant import hqq as JH
from llama3_quantization_tpu.quant import irqlora as JI
from llama3_quantization_tpu.quant import mixed as JM
from llama3_quantization_tpu.quant import omniquant as JO
from llama3_quantization_tpu.quant import serving as JS
from llama3_quantization_tpu.quant import smoothquant as JSQ
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import hf_loader as TL
from llama3_quantization_tpu_torch.models import params as TP
from llama3_quantization_tpu_torch.models import synthetic as TSY
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.models import windowed as TW
from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq
from llama3_quantization_tpu_torch.ops import matmul as mm
from llama3_quantization_tpu_torch.quant import awq as TA
from llama3_quantization_tpu_torch.quant import calibration as TC
from llama3_quantization_tpu_torch.quant import hqq as TH
from llama3_quantization_tpu_torch.quant import irqlora as TI
from llama3_quantization_tpu_torch.quant import mixed as TM
from llama3_quantization_tpu_torch.quant import omniquant as TO
from llama3_quantization_tpu_torch.quant import serving as TS
from llama3_quantization_tpu_torch.quant import smoothquant as TSQ
from llama3_quantization_tpu_torch.quant.qtensor import QuantizedTensor
from llama3_quantization_tpu_torch.quant.quantizer import QuantSpec
from llama3_quantization_tpu_torch.serving import ServingEngine as TEngine

from test_torch_model import jax_kernel_route, to_numpy_tree  # noqa: F401  (fixture)
from test_torch_opt_falcon import _np_tree, close_to_scale, configs

torch.set_num_threads(1)

SPEC = dict(n_bits=4, group_size=32)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs("mixtral")
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = convert.params_from_numpy(to_numpy_tree(jp), device="cpu")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, jcfg.vocab_size))
    return jcfg, tcfg, jp, tp, toks


@pytest.fixture
def capacity():
    """`set_moe_capacity(f)` on both packages, reset to dense after."""
    def set_both(f):
        JT.set_moe_capacity(f)
        TT.set_moe_capacity(f)

    try:
        yield set_both
    finally:
        set_both(None)


@pytest.fixture
def drops(monkeypatch, setup):
    """Records the port's top-k expert ids of each MoE call; `drops(f)`
    gives (picks, dropped) for capacity factor f: an expert takes at most
    C = ceil(f * k * T / E) of a call's T tokens (at most T), rounded up to
    a multiple of 8, so one picked n times drops max(0, n - C)."""
    cfg, ids, orig = setup[1], [], TT._moe_topk

    def rec(p, x, c):
        v, i = orig(p, x, c)
        ids.append(i.reshape(-1, i.shape[-1]))
        return v, i

    monkeypatch.setattr(TT, "_moe_topk", rec)

    def count(f):
        e, k = cfg.num_experts, cfg.num_experts_per_tok
        picks = dropped = 0
        for i in ids:
            t = i.shape[0]
            c = -(-min(t, -(-int(f * k * t) // e)) // 8) * 8
            n = torch.bincount(i.reshape(-1), minlength=e)
            picks, dropped = picks + int(n.sum()), dropped + int((n - c).clamp(min=0).sum())
        return picks, dropped

    return count


def logits_both(setup, jparams=None, tparams=None):
    jcfg, tcfg, jp, tp, toks = setup
    ref = np.asarray(JT.forward_logits(jp if jparams is None else jparams, jnp.asarray(toks), jcfg))
    with mm.backend("xla"):
        got = TT.forward_logits(tp if tparams is None else tparams, torch.from_numpy(toks),
                                tcfg).numpy()
    return got, ref


def experts_agree(jq, tq, floor=0.99):
    for name in ("gate", "up", "down"):
        j, t = jq["layers"]["experts"][name]["w"], tq["layers"]["experts"][name]["w"]
        assert isinstance(t, QuantizedTensor) and tuple(t.data.shape) == tuple(j.data.shape)
        agree = (np.asarray(j.data) == t.data.numpy()).mean()
        assert agree > floor, (name, agree)


# ------------------------------------------------- tests/test_moe.py, port ----
def test_moe_forward(setup):
    got, ref = logits_both(setup)
    assert got.shape == (2, 16, setup[0].vocab_size) and np.isfinite(got).all()
    close_to_scale(got, ref, 1e-5)


def test_moe_causality(setup):
    _, tcfg, _, tp, toks = setup
    toks = torch.from_numpy(toks)
    a = TT.forward_logits(tp, toks, tcfg)
    toks2 = toks.clone()
    toks2[:, -1] = (toks2[:, -1] + 1) % tcfg.vocab_size
    b = TT.forward_logits(tp, toks2, tcfg)
    torch.testing.assert_close(a[:, :-1], b[:, :-1], rtol=0, atol=1e-5)


def test_moe_routing_actually_sparse(setup):
    """Zeroing an expert no token picked leaves `_moe_block` unchanged;
    zeroing a picked one changes it; both as JAX's block (1e-6)."""
    jcfg, tcfg, jp, tp, _ = setup
    jl, tl = JC._layer_slice(jp["layers"], 0), TC._layer_slice(tp["layers"], 0)
    h = np.random.default_rng(3).standard_normal((1, 8, jcfg.hidden_size)).astype(np.float32)
    base = TT._moe_block(tl, torch.from_numpy(h), tcfg, TT.NO_QUANT)
    close_to_scale(base, JT._moe_block(jl, jnp.asarray(h), jcfg, JT.NO_QUANT), 1e-6)
    probs = torch.softmax(torch.from_numpy(h) @ tl["router"]["w"], dim=-1)
    used = set(torch.topk(probs, tcfg.num_experts_per_tok).indices.flatten().tolist())

    def zeroed(e):
        p = dict(tl)
        p["experts"] = {n: {"w": ent["w"].clone().index_fill_(0, torch.tensor([e]), 0.0)}
                        for n, ent in tl["experts"].items()}
        return TT._moe_block(p, torch.from_numpy(h), tcfg, TT.NO_QUANT)

    unused = [e for e in range(tcfg.num_experts) if e not in used]
    if unused:
        torch.testing.assert_close(zeroed(unused[0]), base, rtol=0, atol=1e-6)
    assert float((zeroed(min(used)) - base).abs().max()) > 1e-6


# -------------------------------------- routed dispatch above 128 rows ----
def _skewed(layer, case, to):
    """`layer` with its router's channel 0 set for `case`: "every-expert"
    leaves it; "one-idle" sets -8 on expert 3, so that no row whose channel
    0 reads 8 picks it; "one-short" sets -4 on expert 3 and 0 elsewhere, so
    that it takes exactly the rows whose channel 0 reads -8 (the first 40)
    and none of those reading 8. `to` makes the package's array from
    numpy."""
    if case == "every-expert":
        return layer
    w = np.array(layer["router"]["w"])
    if case == "one-short":
        w[0] = 0.0
    w[0, 3] = -8.0 if case == "one-idle" else -4.0
    return {**layer, "router": {"w": to(w)}}


@pytest.mark.parametrize("case", ["every-expert", "one-idle", "one-short"])
@pytest.mark.parametrize("weights", ["fp", "w4"])
def test_moe_routed_matches_dense_and_jax(setup, w4, monkeypatch, weights, case):
    """[2, 320] rows (640 > MOE_ROUTED_ABOVE) take the routed dispatch
    (`_moe_routed`): one expert call per expert with rows (an expert no
    token picks gets none), each on the kernel route of the call's rows (a
    slice of 64 or fewer, the short expert's 40, padded to 65, so W4
    experts never take B1's plain version), the same bits twice; within
    1e-5 of the dense form (each [1, 320] half, the switch set at 320
    rows) and, under "xla", of JAX's dense block."""
    jcfg, tcfg, jp, tp, _ = setup
    jtree, ttree = (jp, tp) if weights == "fp" else w4
    jl = _skewed(JC._layer_slice(jtree["layers"], 0), case, jnp.asarray)
    tl = _skewed(TC._layer_slice(ttree["layers"], 0), case, torch.from_numpy)
    h = np.random.default_rng(5).standard_normal((2, 320, jcfg.hidden_size)).astype(np.float32)
    if case != "every-expert":
        h[..., 0] = 8.0
    if case == "one-short":
        h[0, :40, 0] = -8.0
    x = torch.from_numpy(h)
    calls, gemv, ffn, b1 = [], [], TT._expert_ffn, fq.qmm_gemv_plain

    def counted(e_params, xe, *args):
        calls.append(xe.numel() // xe.shape[-1])
        return ffn(e_params, xe, *args)

    def gemv_counted(x2d, *args):
        gemv.append(x2d.shape[0])
        return b1(x2d, *args)

    def dense():
        with monkeypatch.context() as m:
            m.setattr(TT, "MOE_ROUTED_ABOVE", 320)
            return torch.cat([TT._moe_block(tl, x[i : i + 1], tcfg, TT.NO_QUANT)
                              for i in range(2)])

    monkeypatch.setattr(TT, "_expert_ffn", counted)
    monkeypatch.setattr(fq, "qmm_gemv_plain", gemv_counted)
    routed = TT._moe_block(tl, x, tcfg, TT.NO_QUANT)
    picked = torch.bincount(TT._moe_topk(tl, x, tcfg)[1].reshape(-1), minlength=tcfg.num_experts)
    assert calls == [max(n, 65) for n in picked.tolist() if n]
    assert picked.sum() == 2 * 320 * 2 and gemv == []
    assert picked[3] == 0 if case == "one-idle" else bool((picked > 0).all())
    assert picked[3] == 40 or case != "one-short"
    assert torch.equal(TT._moe_block(tl, x, tcfg, TT.NO_QUANT), routed)
    calls.clear()
    close_to_scale(routed, dense(), 1e-5)
    assert calls == [320] * 2 * tcfg.num_experts and gemv == []
    with mm.backend("xla"):
        got, ref = TT._moe_block(tl, x, tcfg, TT.NO_QUANT), dense()
    close_to_scale(got, ref, 1e-5)
    close_to_scale(got, JT._moe_block(jl, jnp.asarray(h), jcfg, JT.NO_QUANT), 1e-5)


def test_moe_quantization(setup):
    """RTN on every expert (codes exact, router fp) and the quantized
    forward as JAX's."""
    jcfg, tcfg, jp, tp, toks = setup
    jq = JP.quantize_model_rtn(jp, jcfg, JSpec(**SPEC), pack=True)
    tq = TP.quantize_model_rtn(tp, tcfg, QuantSpec(**SPEC), pack=True)
    assert not isinstance(tq["layers"]["router"]["w"], QuantizedTensor)
    experts_agree(jq, tq, floor=1.0 - 1e-12)
    for name in TP.linear_names(tcfg):
        np.testing.assert_array_equal(tq["layers"][name]["w"].data.numpy(),
                                      np.asarray(jq["layers"][name]["w"].data))
    got, ref = logits_both(setup, jq, tq)
    close_to_scale(got, ref, 1e-5)
    fp, _ = logits_both(setup)
    assert 0 < float(np.abs(got - fp).mean()) < 1.0


def test_moe_gptq(setup):
    """Routing-weighted per-expert Hessians (`calibration.py:281-343`) on 8
    x 64 tokens: > 99% of the codes in every linear and expert stack. Both
    packages under JAX's default backend, "xla": down's Hessian reads each
    expert's activation through the process backend in both (JAX pins only
    the capture and the propagation), and the port's default, B1's and B2's
    bf16 rounding of x, moves 1-2% of layer 0's down codes."""
    jcfg, tcfg, jp, tp, _ = setup
    calib = np.random.default_rng(1).integers(0, jcfg.vocab_size, (8, 64))
    jq = JC.gptq_quantize_model(jp, jcfg, calib, JSpec(**SPEC), blocksize=32)
    with mm.backend("xla"):
        tq = TC.gptq_quantize_model(tp, tcfg, calib, QuantSpec(**SPEC), blocksize=32)
    experts_agree(jq, tq)
    for name in TP.linear_names(tcfg):
        agree = (np.asarray(jq["layers"][name]["w"].data)
                 == tq["layers"][name]["w"].data.numpy()).mean()
        assert agree > 0.99, name


def test_moe_capacity_matches_dense_when_roomy(setup, capacity, drops):
    """C >= T: nothing drops; JAX's capacity logits within 1e-5, the dense
    ones within JAX's 2e-4, no pick dropped."""
    factor = float(setup[0].num_experts)
    capacity(factor)
    got, ref = logits_both(setup)
    picks, dropped = drops(factor)
    capacity(None)
    dense, _ = logits_both(setup)
    close_to_scale(got, ref, 1e-5)
    np.testing.assert_allclose(got, dense, rtol=2e-4, atol=2e-4)
    cfg = setup[1]
    assert (picks, dropped) == (cfg.num_layers * 2 * 16 * cfg.num_experts_per_tok, 0)


def test_moe_capacity_drops_tokens_when_tight(setup, capacity, drops):
    """Factor 0.25: finite, JAX's logits within 1e-5, unlike the dense ones,
    and the drops counted (slot-major queues, C = 8 of 64 picks)."""
    capacity(0.25)
    got, ref = logits_both(setup)
    picks, dropped = drops(0.25)
    capacity(None)
    dense, _ = logits_both(setup)
    assert np.isfinite(got).all() and float(np.abs(got - dense).max()) > 0.0
    close_to_scale(got, ref, 1e-5)
    assert 0 < dropped < picks


def test_moe_capacity_validation():
    for f in (0.0, -1.0):
        with pytest.raises(ValueError):
            JT.set_moe_capacity(f)
        with pytest.raises(ValueError, match="positive"):
            TT.set_moe_capacity(f)


def test_moe_awq(setup):
    """ln2 folds into the router and every expert; W8: the folded norms
    within 1e-5 of JAX's, > 99% of the codes, output error < 0.2 of scale."""
    jcfg, tcfg, jp, tp, toks = setup
    jq = JA.awq_quantize_model(jp, jcfg, toks, JSpec(n_bits=8, group_size=32), n_grid=5)
    tq = TA.awq_quantize_model(tp, tcfg, toks, QuantSpec(n_bits=8, group_size=32), n_grid=5)
    for name in ("ln1", "ln2"):
        np.testing.assert_allclose(tq["layers"][name]["w"].numpy(),
                                   np.asarray(jq["layers"][name]["w"]), rtol=1e-5)
    np.testing.assert_allclose(tq["layers"]["router"]["w"].numpy(),
                               np.asarray(jq["layers"]["router"]["w"]), rtol=1e-5, atol=1e-7)
    experts_agree(jq, tq)
    got, _ = logits_both(setup, jq, tq)
    fp, _ = logits_both(setup)
    assert np.abs(got - fp).mean() / (np.abs(fp).mean() + 1e-9) < 0.2


def test_moe_omniquant_lwc_let(setup):
    """Scale-only MoE LET (no fc1_shift) folds as JAX's and keeps the fp
    layer exact (2e-4); one epoch of LWC + LET: > 99% of the codes in every
    linear and expert, per-expert clipping logits `[E, N, G, 1]`."""
    jcfg, tcfg, jp, tp, toks = setup
    jl, tl = JC._layer_slice(jp["layers"], 0), TC._layer_slice(tp["layers"], 0)
    let = TO.init_layer_let(tl, tcfg)
    assert "fc1_shift" not in let and sorted(let) == sorted(JO.init_layer_let(jl, jcfg))
    scale = np.exp(0.3 * np.random.default_rng(7).standard_normal(tuple(let["fc1_scale"].shape)))
    let["fc1_scale"] = torch.from_numpy(scale.astype(np.float32))
    folded = TO.apply_let(tl, let, tcfg)
    jfold = JO.apply_let(jl, {k: jnp.asarray(v.numpy()) for k, v in let.items()}, jcfg)
    for (path, ref), got in zip(jax.tree_util.tree_leaves_with_path(jfold),
                                jax.tree_util.tree_leaves(_np_tree(folded))):
        close_to_scale(got, ref, 1e-6, jax.tree_util.keystr(path))
    h, cos_sin, mask = TC.embed_calibration(tp, tcfg, torch.from_numpy(toks[:1, :8]))
    base = TT.decoder_layer(tl, h, tcfg, TT.NO_QUANT, cos_sin, mask)
    close_to_scale(TT.decoder_layer(folded, h, tcfg, TT.NO_QUANT, cos_sin, mask), base, 2e-4)
    lwc = TO.init_layer_lwc(tl, tcfg, QuantSpec(n_bits=8, group_size=32, lwc=True))
    assert tuple(lwc["experts"]["down"]["up"].shape) == (tcfg.num_experts, tcfg.hidden_size,
                                                        tcfg.intermediate_size // 32, 1)
    ocfg = dict(epochs=1, let=True, batch_size=2)
    jq = JO.omniquant_model(jp, jcfg, toks, JO.OmniConfig(
        wspec=JSpec(n_bits=8, group_size=32, lwc=True), **ocfg))
    tq = TO.omniquant_model(tp, tcfg, toks, TO.OmniConfig(
        wspec=QuantSpec(n_bits=8, group_size=32, lwc=True), **ocfg))
    experts_agree(jq, tq)
    for name in TP.linear_names(tcfg):
        agree = (np.asarray(jq["layers"][name]["w"].data)
                 == tq["layers"][name]["w"].data.numpy()).mean()
        assert agree > 0.99, name


# ------------------------------------------ the MoE cases of other files ----
def test_mixed_precision_gptq_moe(setup):
    """Only real attention linears enter the observer (`tests/test_gptq.py:
    305-322`): the same two upgraded as JAX's."""
    jcfg, tcfg, jp, tp, _ = setup
    calib = np.random.default_rng(1).integers(0, jcfg.vocab_size, (8, 64))
    jq, jup = JM.mixed_precision_gptq(jp, jcfg, calib, JSpec(n_bits=2, group_size=32),
                                      JSpec(n_bits=8, group_size=32), topk=2, blocksize=32)
    with mm.backend("xla"):  # JAX's default, as in test_moe_gptq
        tq, tup = TM.mixed_precision_gptq(tp, tcfg, calib, QuantSpec(n_bits=2, group_size=32),
                                          QuantSpec(n_bits=8, group_size=32), topk=2,
                                          blocksize=32)
    assert sorted(tup) == sorted(jup) and len(tup) == 2
    assert all(k.rsplit(".", 1)[0] in TP.linear_names(tcfg) for k in tup)
    experts_agree(jq, tq)


def test_moe_serving_recode(setup):
    """`recode_model_s8` on the expert stacks: JAX's per-column s8 codes and
    scales exactly; the a8 forward within 0.05 of the W8 forward's scale
    (`tests/test_serving.py:245-270`)."""
    jcfg, tcfg, jp, tp, toks = setup
    jq = JP.quantize_model_rtn(jp, jcfg, JSpec(n_bits=8, group_size=32))
    tq = TP.quantize_model_rtn(tp, tcfg, QuantSpec(n_bits=8, group_size=32))
    jr, tr = JS.recode_model_s8(jq, jcfg), TS.recode_model_s8(tq, tcfg)
    for name in ("gate", "up", "down"):
        j, t = jr["layers"]["experts"][name]["w"], tr["layers"]["experts"][name]["w"]
        assert t.group_size is None and t.sym
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    with mm.backend("xla"):
        ref = TT.forward_logits(tq, torch.from_numpy(toks), tcfg)
    with mm.backend("a8"):
        out = TT.forward_logits(tr, torch.from_numpy(toks), tcfg)
    assert float((out - ref).abs().mean() / (ref.abs().mean() + 1e-9)) < 0.05


def test_hqq_irqlora_cover_moe_experts(setup):
    """(`tests/test_nf4_irqlora.py:169-200`): HQQ quantizes every expert,
    IR-QLoRA dequantizes them in place; logits within 1e-4 / 1e-5 of JAX's."""
    jcfg, tcfg, jp, tp, toks = setup
    jh = JH.hqq_quantize_model(jp, jcfg, JSpec(n_bits=8, group_size=32), iters=5)
    th = TH.hqq_quantize_model(tp, tcfg, QuantSpec(n_bits=8, group_size=32), iters=5)
    assert isinstance(th["layers"]["experts"]["gate"]["w"], QuantizedTensor)
    got, ref = logits_both(setup, jh, th)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    ji = JI.irqlora_quantize_model(jp, jcfg, tau_n=4, blocksize2=16)
    ti = TI.irqlora_quantize_model(tp, tcfg, tau_n=4, blocksize2=16)
    egate = ti["layers"]["experts"]["gate"]["w"]
    assert not isinstance(egate, QuantizedTensor)
    assert float((egate - tp["layers"]["experts"]["gate"]["w"]).abs().max()) > 0
    got, ref = logits_both(setup, ji, ti)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_smoothquant_moe_matches_jax(setup):
    """`experts_in` statistics and `smoothquant_model` (norm2 into the
    router and the experts) within 1e-5 of JAX's (`fold_norm_moe` itself:
    tests/test_torch_smoothing.py)."""
    jcfg, tcfg, jp, tp, toks = setup
    jst, tst = JSQ.collect_act_stats(jp, jcfg, toks), TSQ.collect_act_stats(tp, tcfg, toks)
    assert sorted(tst[0]) == sorted(jst[0]) and "experts_in" in tst[0]
    for jl, tl in zip(jst, tst):
        for name in jl:
            for kind in ("absmax", "mean"):
                close_to_scale(tl[name][kind], jl[name][kind], 1e-5, f"{name}.{kind}")
    js = JSQ.smoothquant_model(jp, jcfg, toks, act_stats=jst)
    ts = TSQ.smoothquant_model(tp, tcfg, toks, act_stats=tst)
    for (path, ref), got in zip(jax.tree_util.tree_leaves_with_path(js["layers"]),
                                jax.tree_util.tree_leaves(_np_tree(ts["layers"]))):
        close_to_scale(got, ref, 1e-5, jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def w4(setup):
    jcfg, tcfg, jp, tp, _ = setup
    return (JP.quantize_model_rtn(jp, jcfg, JSpec(**SPEC), pack=True),
            TP.quantize_model_rtn(tp, tcfg, QuantSpec(**SPEC), pack=True))


def test_moe_decode_and_greedy_streams_match_jax(setup, w4, jax_kernel_route):
    """An 8-token prefill and 8 teacher-forced steps on the int8 cache
    within 2e-2 of the forward's max|logit|; 10 greedy tokens after a
    16-token prefill identical to JAX's."""
    jcfg, tcfg, _, _, toks = setup
    jq, tq = w4
    full = TT.forward_logits(tq, torch.from_numpy(toks), tcfg)
    cache = TT.init_kv_cache(tcfg, 2, 64, quantized=8, device="cpu")
    lg, cache = TT.decode_step(tq, cache, torch.from_numpy(toks[:, :8]), 0, tcfg)
    close_to_scale(lg, full[:, :8], 2e-2)
    for i in range(8, 16):
        lg, cache = TT.decode_step(tq, cache, torch.from_numpy(toks[:, i : i + 1]), i, tcfg)
        close_to_scale(lg[:, 0], full[:, i], 2e-2)
    jc = JT.init_kv_cache(jcfg, 2, 64, quantized=8)
    jl, jc = JT.decode_step(jq, jc, jnp.asarray(toks), jnp.int32(0), jcfg)
    tc = TT.init_kv_cache(tcfg, 2, 64, quantized=8, device="cpu")
    tl, tc = TT.decode_step(tq, tc, torch.from_numpy(toks), 0, tcfg)
    first = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
    assert np.array_equal(tl[:, -1].argmax(-1).numpy()[:, None], first)
    jout, _ = JT.greedy_generate(jq, jc, jnp.asarray(first), jnp.int32(16), 10, jcfg)
    tout, _ = TT.greedy_generate(tq, tc, torch.from_numpy(first.copy()), 16, 10, tcfg)
    assert tout.tolist() == np.asarray(jout).tolist()


def test_moe_engine_never_windows(setup, w4):
    """MoE is never windowed (`windowed.py:107`): the int8 engine's k = 4
    windows run per step and serve every budget."""
    _, tcfg, _, _, _ = setup
    _, tq = w4
    eng = TEngine(tq, tcfg, max_slots=2, max_len=64, quantized_cache=8, device="cpu")
    assert not TW.windowed_ok(tcfg, eng.cache)
    rids = eng.add_requests([([3, 5, 7], 6, None), ([11, 2], 5, None)])
    eng.run(max_steps=20, step_tokens=4)
    assert [len(eng.requests[r].generated) for r in rids] == [6, 5]
    assert eng.dispatches["windowed"] == 0 and eng.dispatches["per_step"] > 0


def test_synthetic_mixtral_tree_is_jaxs_quirk(setup):
    """Mirrored quirk: the synthetic Mixtral tree has JAX's keys and shapes
    (OPT-style fc1/fc2, biased norms, no router or experts), and neither
    package's forward runs it."""
    jcfg, tcfg, _, _, toks = setup
    spec = dict(n_bits=4, group_size=32)
    jsyn = to_numpy_tree(JSY.init_quantized_params(jcfg, JSpec(**spec)))
    tsyn = TSY.init_quantized_params(tcfg, QuantSpec(**spec), device="cpu")

    def shapes(node):
        if isinstance(node, dict) and "data" not in node:
            return {k: shapes(v) for k, v in node.items()}
        if isinstance(node, dict):
            return (tuple(np.shape(node["data"])), tuple(np.shape(node["scale"])))
        if isinstance(node, QuantizedTensor):
            return (tuple(node.data.shape), tuple(node.scale.shape))
        return tuple(node.shape)

    assert shapes(tsyn) == shapes(jsyn)
    assert "fc1" in tsyn["layers"] and "router" not in tsyn["layers"]
    with pytest.raises(KeyError, match="router"):
        JT.forward_logits(JSY.init_quantized_params(jcfg, JSpec(**spec)), jnp.asarray(toks), jcfg)
    with pytest.raises(KeyError, match="router"):
        TT.forward_logits(tsyn, torch.from_numpy(toks), tcfg)


def test_mixtral_hf_dir_loads_as_jax(tmp_path, setup):
    """`block_sparse_moe` (`hf_loader.py:268-313`): router `gate.weight`
    [E, D] to fp [L, D, E], experts w1/w3/w2 to `[L, E, K, N]`; the tree
    bit-equal to JAX's, its forward within 1e-5 of JAX's."""
    from safetensors.numpy import save_file

    jcfg, _, _, _, toks = setup
    rng = np.random.default_rng(0)
    d, i, e, hd = jcfg.hidden_size, jcfg.intermediate_size, jcfg.num_experts, jcfg.head_dim_

    def n(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    t = {"model.embed_tokens.weight": n(jcfg.vocab_size, d, s=0.02),
         "model.norm.weight": 1 + n(d), "lm_head.weight": n(jcfg.vocab_size, d, s=0.02)}
    for l in range(jcfg.num_layers):
        p = f"model.layers.{l}"
        t.update({f"{p}.self_attn.q_proj.weight": n(jcfg.num_heads * hd, d),
                  f"{p}.self_attn.k_proj.weight": n(jcfg.num_kv_heads * hd, d),
                  f"{p}.self_attn.v_proj.weight": n(jcfg.num_kv_heads * hd, d),
                  f"{p}.self_attn.o_proj.weight": n(d, jcfg.num_heads * hd),
                  f"{p}.input_layernorm.weight": 1 + n(d),
                  f"{p}.post_attention_layernorm.weight": 1 + n(d),
                  f"{p}.block_sparse_moe.gate.weight": n(e, d)})
        for x in range(e):
            q = f"{p}.block_sparse_moe.experts.{x}"
            t.update({f"{q}.w1.weight": n(i, d), f"{q}.w3.weight": n(i, d),
                      f"{q}.w2.weight": n(d, i)})
    save_file(t, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "mixtral", "vocab_size": jcfg.vocab_size, "hidden_size": d,
        "intermediate_size": i, "num_hidden_layers": jcfg.num_layers,
        "num_attention_heads": jcfg.num_heads, "num_key_value_heads": jcfg.num_kv_heads,
        "num_local_experts": e, "num_experts_per_tok": 2, "rope_theta": 10000.0,
        "max_position_embeddings": jcfg.max_position_embeddings}))
    jp, jc = JL.from_hf_checkpoint(str(tmp_path), dtype=jnp.float32)
    tp, tc = TL.from_hf_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    assert (tc.arch, tc.num_experts) == ("mixtral", e)
    assert tuple(tp["layers"]["experts"]["down"]["w"].shape) == (jcfg.num_layers, e, i, d)
    np.testing.assert_array_equal(tp["layers"]["router"]["w"][0].numpy(),
                                  t["model.layers.0.block_sparse_moe.gate.weight"].T)
    for (path, ref), got in zip(jax.tree_util.tree_leaves_with_path(jp),
                                jax.tree_util.tree_leaves(_np_tree(tp))):
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=jax.tree_util.keystr(path))
    ref = np.asarray(JT.forward_logits(jp, jnp.asarray(toks), jc))
    close_to_scale(TT.forward_logits(tp, torch.from_numpy(toks), tc).numpy(), ref, 1e-5)
