"""Port parity: HQQ (`quant/hqq.py`).

`hqq_solve` against JAX's at 2, 3, 4 and 8 bits and group sizes 32, 64,
128 and K: the scale bit-equal, the zero within 1e-5, the codes differing
on at most 0.1% of entries and each by one step (JAX's `pow` and the
port's may round an ulp apart). `hqq_quantize_weight`'s storage (packed,
and unpacked signed) equal to JAX's `from_codes` on the same codes; the
oracles of `tests/test_algorithms.py:158-186` (HQQ beats RTN's
reconstruction on heavy-tailed weights, the model runs); the TINY_LLAMA
forward of `hqq_quantize_model` within 1e-4 of JAX's; a padded HQQ weight
(`ops/padding.pad_qtensor`) computes the same function, its float zeros
confined to zero x columns; TINY_MIXTRAL's expert stacks at the solve's
bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA, forward_logits, init_params
from llama3_quantization_tpu.quant import QuantSpec as JSpec
from llama3_quantization_tpu.quant import hqq as JH
from llama3_quantization_tpu.quant.qtensor import from_codes as j_from_codes
from llama3_quantization_tpu_torch import api, convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq
from llama3_quantization_tpu_torch.ops import padding
from llama3_quantization_tpu_torch.quant import hqq as TH
from llama3_quantization_tpu_torch.quant.qtensor import QuantizedTensor, dequantize, quantize_rtn
from llama3_quantization_tpu_torch.quant.quantizer import QuantSpec

from test_torch_model import to_numpy_tree

torch.set_num_threads(1)


def _weight(seed, k=256, n=96):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    return w * np.exp(rng.standard_normal((k, n)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("gs", [32, 64, 128, None])
@pytest.mark.parametrize("n_bits", [2, 3, 4, 8])
def test_hqq_solve_matches_jax(n_bits, gs):
    w = _weight(n_bits * 10 + (gs or 0))
    k = w.shape[0]
    jc, js, jz = (np.asarray(x) for x in JH.hqq_solve(jnp.asarray(w), n_bits, gs or k))
    tc, ts, tz = (x.numpy() for x in TH.hqq_solve(torch.from_numpy(w), n_bits, gs or k))
    np.testing.assert_array_equal(ts.view(np.uint32), js.view(np.uint32))
    np.testing.assert_allclose(tz, jz, rtol=0, atol=1e-5)
    flips = tc != jc
    assert flips.mean() <= 1e-3
    assert np.abs(tc.astype(int) - jc.astype(int)).max() <= 1
    assert tc.dtype == np.uint8 and ts.shape == tz.shape == (k // (gs or k), w.shape[1])


@pytest.mark.parametrize("iters", [1, 5, 25])
def test_hqq_solve_iterations_match_jax(iters):
    w = _weight(7, k=128, n=64)
    jc, js, jz = (np.asarray(x) for x in JH.hqq_solve(jnp.asarray(w), 4, 64, iters=iters))
    tc, ts, tz = (x.numpy() for x in TH.hqq_solve(torch.from_numpy(w), 4, 64, iters=iters))
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tz, jz, rtol=0, atol=1e-5)
    assert (tc != jc).mean() <= 1e-3


@pytest.mark.parametrize("n", [16, 32, 48, 64, 96, 128, 512, 1024])
def test_xla_group_sum_order(n):
    """The group sum adds in the order XLA's CPU code does: the mean of
    `hqq_solve`'s zero update, jitted, bit for bit."""
    x = np.random.default_rng(n).standard_normal((3, n, 40)).astype(np.float32) * 100
    ref = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(jnp.asarray(x)))
    got = TH.xla_group_sum(torch.from_numpy(x), dim=1).numpy()
    close = np.isclose(got, ref, rtol=1e-5, atol=1e-4)
    assert close.all()
    if n > 32 and n % 32 == 0:
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("gs", [32, 64, 128, None])
def test_plain_sum_misses_the_zero_bound(monkeypatch, gs):
    """Why the zero update adds in XLA's order: with a plain sum instead,
    8-bit zeros (|z| near 128, where an ulp is 7.6e-6) move by a few ulps,
    past the 1e-5 bound, and at g64 a code flip carries a zero 0.156 away."""
    monkeypatch.setattr(TH, "xla_group_sum", lambda x, dim=1: x.sum(dim))
    w = _weight(80 + (gs or 0))
    k = w.shape[0]
    _, _, jz = JH.hqq_solve(jnp.asarray(w), 8, gs or k)
    _, _, tz = TH.hqq_solve(torch.from_numpy(w), 8, gs or k)
    assert np.abs(tz.numpy() - np.asarray(jz)).max() > 1e-5


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("n_bits,gs", [(4, 32), (3, 64), (2, 128), (8, 32)])
def test_hqq_storage_matches_jax_from_codes(n_bits, gs, pack):
    w = _weight(3)
    spec = QuantSpec(n_bits=n_bits, group_size=gs)
    qt = TH.hqq_quantize_weight(torch.from_numpy(w), spec, pack=pack)
    codes, scale, zero = TH.hqq_solve(torch.from_numpy(w), n_bits, gs)
    ref = j_from_codes(jnp.asarray(codes.numpy()), jnp.asarray(scale.numpy()),
                       jnp.asarray(zero.numpy()), JSpec(n_bits=n_bits, group_size=gs), pack=pack,
                       out_dtype=jnp.float32)
    assert (qt.packed, qt.bits, qt.group_size, qt.k, qt.n, qt.sym) == (
        ref.packed, ref.bits, ref.group_size, ref.k, ref.n, ref.sym)
    np.testing.assert_array_equal(qt.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(qt.zero.numpy(), np.asarray(ref.zero))
    assert qt.out_dtype == torch.float32


def test_hqq_beats_rtn_reconstruction(rng):
    """`test_algorithms.py:163-175`: the l_p objective on heavy-tailed weights."""
    k, n = 64, 32
    w = rng.standard_normal((k, n)).astype(np.float32)
    w *= np.exp(rng.standard_normal((k, n)) * 1.0).astype(np.float32)
    spec = QuantSpec(n_bits=3, group_size=32)
    wt = torch.from_numpy(w)
    e_h = (dequantize(TH.hqq_quantize_weight(wt, spec, iters=25), torch.float32) - wt).abs()
    e_r = (dequantize(quantize_rtn(wt, spec), torch.float32) - wt).abs()
    assert float((e_h**0.7).mean()) < float((e_r**0.7).mean())


def test_hqq_rejects_ragged_groups():
    with pytest.raises(ValueError, match="not divisible"):
        TH.hqq_quantize_weight(torch.zeros(48, 16), QuantSpec(n_bits=4, group_size=32))


@pytest.fixture(scope="module")
def tiny():
    jp = init_params(TINY_LLAMA, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, convert.params_from_numpy(to_numpy_tree(jp), device="cpu")


@pytest.mark.parametrize("pack", [True, False])
def test_hqq_model_matches_jax(tiny, pack):
    """`hqq_quantize_model` on TINY_LLAMA (`test_algorithms.py:178-186`),
    the forward under JAX's default backend (xla) within 1e-4 of JAX's."""
    from llama3_quantization_tpu_torch.ops import matmul as mm

    jp, tp = tiny
    spec = QuantSpec(n_bits=4, group_size=32)
    jq = JH.hqq_quantize_model(jp, TINY_LLAMA, JSpec(n_bits=4, group_size=32), iters=10,
                               pack=pack)
    tq = api.quantize(tp, tcfg.TINY_LLAMA, "hqq", spec, pack=pack, iters=10)
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        w = tq["layers"][name]["w"]
        assert isinstance(w, QuantizedTensor) and w.packed == pack and w.data.shape[0] == 2
    toks = np.random.default_rng(1).integers(0, TINY_LLAMA.vocab_size, (2, 16))
    ref = np.asarray(forward_logits(jq, jnp.asarray(toks), TINY_LLAMA))
    fp = np.asarray(forward_logits(jp, jnp.asarray(toks), TINY_LLAMA))
    with mm.backend("xla"):
        got = TT.forward_logits(tq, torch.from_numpy(toks), tcfg.TINY_LLAMA).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert float(np.abs(got - fp).mean()) < 0.1


def test_hqq_float_zeros_through_padding():
    """A padded HQQ weight on B1's and B2's plain versions: the padded
    rows' codes meet zero x columns, so a group's float zero adds nothing
    there, and the call equals the unpadded one."""
    w = torch.from_numpy(_weight(11, k=96, n=40))
    qt = TH.hqq_quantize_weight(w, QuantSpec(n_bits=4, group_size=24), pack=True)
    assert float((qt.zero - qt.zero.round()).abs().max()) > 0.01  # continuous zeros
    pw = padding.PaddedWeight(padding.pad_qtensor(qt), qt.k, qt.n, qt.group_size)
    x = torch.randn(5, 96, generator=torch.Generator().manual_seed(0))
    for plain in (fq.qmm_gemv_plain, fq.qmm_gemm_plain):
        ref = plain(x, qt, torch.float32)
        got = pw.matmul(x, lambda a, b: plain(a, b, torch.float32))
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def test_hqq_refuses_moe():
    """(The name is kept from when the port refused MoE expert stacks.)
    HQQ on TINY_MIXTRAL's `[L, E, K, N]` expert stacks (`hqq.py:126-135`),
    at `test_hqq_solve_matches_jax`'s bounds: scales bit-equal, zeros within
    1e-5, codes apart on at most 0.1% of entries, by one step."""
    from llama3_quantization_tpu.models.configs import TINY_MIXTRAL

    jp = init_params(TINY_MIXTRAL, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = convert.params_from_numpy(to_numpy_tree(jp), device="cpu")
    jq = JH.hqq_quantize_model(jp, TINY_MIXTRAL, JSpec(n_bits=4, group_size=32), iters=5)
    tq = TH.hqq_quantize_model(tp, tcfg.TINY_MIXTRAL, QuantSpec(n_bits=4, group_size=32),
                               iters=5)
    for name in ("gate", "up", "down"):
        j, t = jq["layers"]["experts"][name]["w"], tq["layers"]["experts"][name]["w"]
        assert isinstance(t, QuantizedTensor) and tuple(t.data.shape) == tuple(j.data.shape)
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        np.testing.assert_allclose(t.zero.numpy(), np.asarray(j.zero), rtol=0, atol=1e-5)
        diff = np.abs(t.data.numpy().astype(np.int32) - np.asarray(j.data).astype(np.int32))
        assert (diff != 0).mean() <= 1e-3 and diff.max() <= 1, name