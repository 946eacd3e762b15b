"""Port parity: the smoothing algebra, SmoothQuant and AWQ
(`quant/smoothing.py`, `quant/smoothquant.py`, `quant/awq.py`).

Each fold is fp-neutral (the layer's function unchanged within 1e-5 of
its scale) and gives JAX's weights within 1e-6; `collect_act_stats` is
within 1e-5 of JAX's; the act-stats file round-trips through both
packages; `smoothquant_model` gives JAX's smoothed weights (1e-5 of
their scale) and, RTN-quantized, over 99% of JAX's codes; AWQ picks JAX's
alpha (its scale within 1e-5) and `awq_quantize_model` gives over 99% of
JAX's codes in every linear; `fold_norm_moe` on TINY_MIXTRAL within 1e-6 of
JAX's and fp-neutral.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.models.params import quantize_model_rtn as j_rtn
from llama3_quantization_tpu.quant import QuantSpec as JSpec
from llama3_quantization_tpu.quant import awq as JA
from llama3_quantization_tpu.quant import smoothing as JS
from llama3_quantization_tpu.quant import smoothquant as JQ
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models.params import linear_names
from llama3_quantization_tpu_torch.models.params import quantize_model_rtn as t_rtn
from llama3_quantization_tpu_torch.quant import awq as TA
from llama3_quantization_tpu_torch.quant import smoothing as TS
from llama3_quantization_tpu_torch.quant import smoothquant as TQ
from llama3_quantization_tpu_torch.quant.quantizer import QuantSpec as TSpec

from test_torch_model import to_numpy_tree

torch.set_num_threads(1)


def _arrs(seed, *shapes, positive=()):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    for i in positive:
        out[i] = np.abs(out[i]) + 0.5
    return out


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("shift", [False, True])
def test_fold_norm_linears_neutral_and_jax(shift):
    x, nw, w1, w2, s, sh = _arrs(0, (5, 16), (16,), (16, 8), (16, 12), (16,), (16,),
                                 positive=(1, 4))
    norm, lins = {"w": nw}, [{"w": w1}, {"w": w2}]
    tn, tl = TS.fold_norm_linears(_t(norm), [_t(l) for l in lins], torch.from_numpy(s),
                                  torch.from_numpy(sh) if shift else None)
    jn, jl = JS.fold_norm_linears(_j(norm), [_j(l) for l in lins], jnp.asarray(s),
                                  jnp.asarray(sh) if shift else None)
    for a, b in [(tn, jn)] + list(zip(tl, jl)):
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_allclose(a[key].numpy(), np.asarray(b[key]), rtol=0, atol=1e-6)
    xt = torch.from_numpy(x)
    for lin, new in zip(lins, tl):
        ref = (xt * torch.from_numpy(nw)) @ torch.from_numpy(lin["w"])
        got = (xt * tn["w"] + tn.get("b", 0.0)) @ new["w"] + new.get("b", 0.0)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_fold_fc_fc_and_v_o_gqa_neutral_and_jax():
    cfg_t, cfg_j = tcfg.TINY_LLAMA, TINY_LLAMA
    hd, g, h = cfg_t.head_dim_, cfg_t.num_kv_heads, cfg_t.num_heads
    x, wv, wo, s = _arrs(1, (3, 64), (64, g * hd), (h * hd, 64), (g * hd,), positive=(3,))
    tv, to = TQ._fold_v_o_gqa({"w": torch.from_numpy(wv)}, {"w": torch.from_numpy(wo)},
                              torch.from_numpy(s), cfg_t)
    jv, jo = JQ._fold_v_o_gqa({"w": jnp.asarray(wv)}, {"w": jnp.asarray(wo)}, jnp.asarray(s),
                              cfg_j)
    np.testing.assert_allclose(tv["w"].numpy(), np.asarray(jv["w"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to["w"].numpy(), np.asarray(jo["w"]), rtol=0, atol=1e-6)
    rep = h // g

    def attn_out(wv_, wo_):  # o's input is v repeated per query head
        v = torch.from_numpy(x) @ wv_
        v = v.reshape(3, g, 1, hd).expand(3, g, rep, hd).reshape(3, h * hd)
        return v @ wo_

    ref = attn_out(torch.from_numpy(wv), torch.from_numpy(wo))
    torch.testing.assert_close(attn_out(tv["w"], to["w"]), ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    w1, w2, s2 = _arrs(2, (16, 8), (8, 12), (8,), positive=(2,))
    t1, t2 = TS.fold_fc_fc({"w": torch.from_numpy(w1)}, {"w": torch.from_numpy(w2)},
                           torch.from_numpy(s2))
    j1, j2 = JS.fold_fc_fc({"w": jnp.asarray(w1)}, {"w": jnp.asarray(w2)}, jnp.asarray(s2))
    np.testing.assert_allclose((t1["w"] @ t2["w"]).numpy(), w1 @ w2, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t1["w"].numpy(), np.asarray(j1["w"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t2["w"].numpy(), np.asarray(j2["w"]), rtol=0, atol=1e-6)


def test_fold_q_k_and_gqa_reduce_match_jax():
    wq, wk, s = _arrs(3, (16, 32), (16, 16), (32,), positive=(2,))
    tq, tk = TS.fold_q_k({"w": torch.from_numpy(wq)}, {"w": torch.from_numpy(wk)},
                         torch.from_numpy(s), head_dim=8)
    jq, jk = JS.fold_q_k({"w": jnp.asarray(wq)}, {"w": jnp.asarray(wk)}, jnp.asarray(s),
                         head_dim=8)
    np.testing.assert_allclose(tq["w"].numpy(), np.asarray(jq["w"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tk["w"].numpy(), np.asarray(jk["w"]), rtol=0, atol=1e-6)
    a, w = _arrs(4, (16,), (16,), positive=(0, 1))
    np.testing.assert_allclose(TS.smoothquant_scale(torch.from_numpy(a), torch.from_numpy(w),
                                                    0.3).numpy(),
                               np.asarray(JS.smoothquant_scale(jnp.asarray(a), jnp.asarray(w),
                                                               0.3)), rtol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    params = init_params(TINY_LLAMA, jax.random.PRNGKey(0), dtype=jnp.float32)
    calib = np.random.default_rng(6).integers(0, TINY_LLAMA.vocab_size, (4, 64))
    return params, convert.params_from_numpy(to_numpy_tree(params), device="cpu"), calib


def test_collect_act_stats_matches_jax(tiny, tmp_path):
    jparams, tparams, calib = tiny
    js = JQ.collect_act_stats(jparams, TINY_LLAMA, calib, batch_size=2)
    ts = TQ.collect_act_stats(tparams, tcfg.TINY_LLAMA, calib, batch_size=2)
    assert len(ts) == len(js) and sorted(ts[0]) == sorted(js[0])
    for tl, jl in zip(ts, js):
        for name in jl:
            for kind in ("absmax", "mean"):
                np.testing.assert_allclose(tl[name][kind].numpy(), np.asarray(jl[name][kind]),
                                           rtol=0, atol=1e-5)
    JQ.save_act_stats(js, str(tmp_path / "jax.npz"))
    back = TQ.load_act_stats(str(tmp_path / "jax.npz"), device="cpu")
    TQ.save_act_stats(back, str(tmp_path / "port.npz"))
    again = JQ.load_act_stats(str(tmp_path / "port.npz"))
    for name in js[1]:
        np.testing.assert_array_equal(np.asarray(again[1][name]["absmax"]),
                                      np.asarray(js[1][name]["absmax"]))
    stats_np = [{n: {k: np.asarray(v) for k, v in d.items()} for n, d in layer.items()}
                for layer in js]
    carried = convert.params_from_numpy(stats_np, device="cpu")
    assert torch.equal(carried[0]["q"]["mean"], back[0]["q"]["mean"])


def test_smoothquant_model_matches_jax(tiny):
    jparams, tparams, calib = tiny
    js = JQ.smoothquant_model(jparams, TINY_LLAMA, calib)
    ts = TQ.smoothquant_model(tparams, tcfg.TINY_LLAMA, calib)
    for name in ("ln1", "ln2") + tuple(linear_names(tcfg.TINY_LLAMA)):
        ref = np.asarray(js["layers"][name]["w"])
        np.testing.assert_allclose(ts["layers"][name]["w"].numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)
    spec = dict(n_bits=4, group_size=32)
    jq, tq = j_rtn(js, TINY_LLAMA, JSpec(**spec)), t_rtn(ts, tcfg.TINY_LLAMA, TSpec(**spec))
    for name in linear_names(tcfg.TINY_LLAMA):
        agree = (np.asarray(jq["layers"][name]["w"].data) == tq["layers"][name]["w"].data.numpy())
        assert agree.mean() > 0.99, name


def test_awq_search_picks_jax_alpha():
    x, w = _arrs(7, (128, 64), (64, 48))
    x[:, 3] *= 20.0  # an outlier channel
    spec = dict(n_bits=4, group_size=32)
    got = TA.awq_search_alpha(torch.from_numpy(x), torch.from_numpy(w), TSpec(**spec))
    ref = np.asarray(JA.awq_search_alpha(jnp.asarray(x), jnp.asarray(w), JSpec(**spec)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_awq_model_matches_jax(tiny):
    jparams, tparams, calib = tiny
    spec = dict(n_bits=4, group_size=32)
    jq = JA.awq_quantize_model(jparams, TINY_LLAMA, calib, JSpec(**spec), sample_tokens=128)
    tq = TA.awq_quantize_model(tparams, tcfg.TINY_LLAMA, calib, TSpec(**spec), sample_tokens=128)
    for name in ("ln1", "ln2"):  # the folded scales: the chosen alphas
        ref = np.asarray(jq["layers"][name]["w"])
        np.testing.assert_allclose(tq["layers"][name]["w"].numpy(), ref, rtol=1e-5,
                                   err_msg=name)
    for name in linear_names(tcfg.TINY_LLAMA):
        agree = (np.asarray(jq["layers"][name]["w"].data) == tq["layers"][name]["w"].data.numpy())
        assert agree.mean() > 0.99, name


def test_moe_fold_raises_naming_the_roadmap():
    """(The name is kept from when the port refused MoE.) `fold_norm_moe` (`smoothing.py:150-175`) on TINY_MIXTRAL's layer 0:
    the norm, the router and every expert's gate/up within 1e-6 of JAX's,
    down untouched, the MoE block's output unchanged (1e-5 of its scale);
    a shift raises in both packages (the experts have no bias)."""
    from llama3_quantization_tpu.models.configs import TINY_MIXTRAL
    from llama3_quantization_tpu.quant.calibration import _layer_slice as j_slice
    from llama3_quantization_tpu_torch.models import transformer as TT
    from llama3_quantization_tpu_torch.quant.calibration import _layer_slice as t_slice

    jp = init_params(TINY_MIXTRAL, jax.random.PRNGKey(0), dtype=jnp.float32)
    jl = j_slice(jp["layers"], 0)
    tl = t_slice(convert.params_from_numpy(to_numpy_tree(jp), device="cpu")["layers"], 0)
    (s,) = _arrs(4, (TINY_MIXTRAL.hidden_size,), positive=(0,))
    jout = JS.fold_norm_moe(jl["ln2"], jl["router"], jl["experts"], jnp.asarray(s))
    tout = TS.fold_norm_moe(tl["ln2"], tl["router"], tl["experts"], torch.from_numpy(s))
    for j, t in zip(jax.tree_util.tree_leaves(jout),
                    jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                        lambda x: x.numpy(), list(tout)))):
        np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=1e-6)
    assert torch.equal(tout[2]["down"]["w"], tl["experts"]["down"]["w"])
    x, = _arrs(5, (1, 6, TINY_MIXTRAL.hidden_size))
    x = torch.from_numpy(x)
    ref = TT._moe_block(tl, TT.rms_norm(x, tl["ln2"]["w"], 1e-5), tcfg.TINY_MIXTRAL, TT.NO_QUANT)
    p = dict(tl, router=tout[1], experts=tout[2])
    got = TT._moe_block(p, TT.rms_norm(x, tout[0]["w"], 1e-5), tcfg.TINY_MIXTRAL, TT.NO_QUANT)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    with pytest.raises(ValueError, match="scale-only"):
        JS.fold_norm_moe(jl["ln2"], jl["router"], jl["experts"], jnp.asarray(s),
                         jnp.zeros_like(jnp.asarray(s)))
    with pytest.raises(ValueError, match="scale-only"):
        TS.fold_norm_moe(tl["ln2"], tl["router"], tl["experts"], torch.from_numpy(s),
                         torch.zeros(TINY_MIXTRAL.hidden_size))