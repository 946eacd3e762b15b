"""Port parity: GPTQ and observer-driven mixed precision
(`quant/gptq.py`, `quant/calibration.py`, `quant/mixed.py`).

The port's `gptq_solve` against JAX's and against the NumPy oracle of
`tests/test_gptq.py` with JAX's own bounds (more than 99% of codes agree,
scales within rtol 1e-4, loss within 5%), act-order with `g_idx` too;
`inv_cholesky_upper` within 1e-5 (of max|U|) of JAX's blocked form;
streaming Hessians equal to one batch's; `gptq_quantize_model` (plain and
true-sequential) and `mixed_precision_gptq` on TINY_LLAMA against JAX's:
over 99% of codes agree in every linear, and the same linears upgraded.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.quant import QuantSpec as JSpec
from llama3_quantization_tpu.quant import calibration as JC
from llama3_quantization_tpu.quant import gptq as JG
from llama3_quantization_tpu.quant import mixed as JM
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.quant import calibration as TC
from llama3_quantization_tpu_torch.quant import gptq as TG
from llama3_quantization_tpu_torch.quant import mixed as TM
from llama3_quantization_tpu_torch.quant.quantizer import QuantSpec as TSpec

from test_gptq import np_gptq, np_gptq_actorder
from test_torch_model import to_numpy_tree

torch.set_num_threads(1)


def _problem(seed, r=24, k=64, skew=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((256, k)).astype(np.float32)
    if skew:
        x *= np.logspace(0, 1.5, k).astype(np.float32)[rng.permutation(k)]
    h = ((2 / 256) * x.T @ x).astype(np.float32)
    return rng.standard_normal((r, k)).astype(np.float32), h


@pytest.mark.parametrize("gs", [None, 16, 64])
def test_solve_matches_jax_and_the_oracle(gs):
    w, h = _problem(1)
    codes, scales, zeros, g_idx, loss = TG.gptq_solve(torch.from_numpy(w), torch.from_numpy(h),
                                                      n_bits=4, group_size=gs, blocksize=16)
    jcodes, jscales, _, _, jloss = JG.gptq_solve(jnp.asarray(w), jnp.asarray(h), n_bits=4,
                                                 group_size=gs, blocksize=16)
    q_np, s_np, _, loss_np = np_gptq(w, h, 4, gs)
    for ref_codes, ref_scales, ref_loss in ((np.asarray(jcodes), np.asarray(jscales),
                                             float(jloss)), (q_np, s_np, loss_np)):
        assert (codes.numpy() == ref_codes).mean() > 0.99
        np.testing.assert_allclose(scales.numpy(), ref_scales, rtol=1e-4, atol=1e-6)
        assert abs(float(loss) - ref_loss) / max(ref_loss, 1e-9) < 0.05
    assert codes.dtype == torch.uint8 and torch.equal(g_idx, torch.arange(64) // (gs or 64))


def test_actorder_grouped_matches_jax_and_the_oracle():
    w, h = _problem(2, skew=True)
    codes, scales, _, g_idx, loss = TG.gptq_solve(torch.from_numpy(w), torch.from_numpy(h),
                                                  n_bits=4, group_size=16, blocksize=16,
                                                  actorder=True)
    jcodes, jscales, _, jg, _ = JG.gptq_solve(jnp.asarray(w), jnp.asarray(h), n_bits=4,
                                              group_size=16, blocksize=16, actorder=True)
    q_np, s_np, _, g_np, loss_np = np_gptq_actorder(w, h, 4, 16)
    assert (codes.numpy() == np.asarray(jcodes)).mean() > 0.99
    assert (codes.numpy() == q_np).mean() > 0.99
    np.testing.assert_array_equal(g_idx.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(g_idx.numpy(), g_np)
    np.testing.assert_allclose(scales.numpy(), np.asarray(jscales), rtol=1e-4, atol=1e-6)
    assert abs(float(loss) - loss_np) / loss_np < 0.05
    qt, _ = TG.gptq_quantize_weight(torch.from_numpy(w.T.copy()), torch.from_numpy(h),
                                    TSpec(n_bits=4, group_size=16), blocksize=16, actorder=True)
    assert qt.g_idx is not None and torch.equal(qt.g_idx.long(), g_idx)


def test_inv_cholesky_upper_matches_the_blocked_form():
    """K = 1024 takes JAX's blocked Cholesky and triangular inverse."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4096, 1024)).astype(np.float32)
    hd = (x.T @ x / 4096 + 0.1 * np.eye(1024)).astype(np.float32)
    got = TG.inv_cholesky_upper(torch.from_numpy(hd)).numpy()
    ref = np.asarray(JG.inv_cholesky_upper(jnp.asarray(hd)))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(np.tril(got, -1), 0)


def test_hessian_streaming_matches_batch():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 10, 32)).astype(np.float32)
    st = TG.hessian_init(32)
    for i in range(0, 6, 2):
        st = TG.hessian_update(st, torch.from_numpy(x[i : i + 2]))
    one = TG.hessian_update(TG.hessian_init(32), torch.from_numpy(x))
    assert st.nsamples == one.nsamples == 6
    torch.testing.assert_close(st.H, one.H, rtol=1e-5, atol=1e-6)
    ref = JG.hessian_update(JG.hessian_init(32), jnp.asarray(x))
    np.testing.assert_allclose(one.H.numpy(), np.asarray(ref.H), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    params = init_params(TINY_LLAMA, jax.random.PRNGKey(0), dtype=jnp.float32)
    calib = np.random.default_rng(5).integers(0, TINY_LLAMA.vocab_size, (4, 64))
    return params, convert.params_from_numpy(to_numpy_tree(params), device="cpu"), calib


def _codes_agree(jq, tq, names):
    for name in names:
        jw, tw = jq["layers"][name]["w"], tq["layers"][name]["w"]
        agree = (np.asarray(jw.data) == tw.data.numpy()).mean()
        assert agree > 0.99, f"{name}: {agree}"
        np.testing.assert_allclose(tw.scale.numpy(), np.asarray(jw.scale), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("true_sequential", [False, True])
def test_gptq_model_matches_jax(tiny, true_sequential):
    jparams, tparams, calib = tiny
    spec = dict(n_bits=4, group_size=32)
    jq = JC.gptq_quantize_model(jparams, TINY_LLAMA, calib, JSpec(**spec), blocksize=32,
                                true_sequential=true_sequential)
    snr = []
    tq = TC.gptq_quantize_model(tparams, tcfg.TINY_LLAMA, calib, TSpec(**spec), blocksize=32,
                                true_sequential=true_sequential, snr_log=snr)
    _codes_agree(jq, tq, TC.linear_names(tcfg.TINY_LLAMA))
    assert len(snr) == 7 * TINY_LLAMA.num_layers
    assert all(np.isfinite(r["fp_inp_snr"]) and r["fp_inp_snr"] < 1 for r in snr)
    assert TG.format_snr_table(snr).count("\n") == len(snr) + 1


def test_mixed_precision_matches_jax(tiny):
    jparams, tparams, calib = tiny
    jq, jup = JM.mixed_precision_gptq(jparams, TINY_LLAMA, calib, JSpec(n_bits=4, group_size=32),
                                      JSpec(n_bits=8, group_size=32), topk=3, blocksize=32)
    tq, tup = TM.mixed_precision_gptq(tparams, tcfg.TINY_LLAMA, calib,
                                      TSpec(n_bits=4, group_size=32),
                                      TSpec(n_bits=8, group_size=32), topk=3, blocksize=32)
    assert sorted(tup) == sorted(jup) and len(tup) == 3
    for key in tup:
        assert abs(tup[key] - jup[key]) <= 1e-3 * abs(jup[key])
    _codes_agree(jq, tq, TC.linear_names(tcfg.TINY_LLAMA))
    with pytest.raises(ValueError, match="unpacked"):
        TM.mixed_precision_gptq(tparams, tcfg.TINY_LLAMA, calib, TSpec(n_bits=4, group_size=32),
                                TSpec(n_bits=8, group_size=32), pack=True)


def test_other_archs_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="A 4"):
        TC.capture_aliases(tcfg.NAMED_CONFIGS["opt-125m"] if "opt-125m" in tcfg.NAMED_CONFIGS
                           else next(c for c in tcfg.NAMED_CONFIGS.values() if c.arch != "llama"))
