"""Port parity: NF4 and IR-QLoRA (`quant/nf4.py`, `quant/irqlora.py`).

The codebooks bit-equal to JAX's (NF4, the dynamic FP8 map signed and
unsigned); `quantize_to_codebook` equal to JAX's argmin on random values
and on every float within 64 ulps of each flip point and each midpoint;
`nf4_quantize` with equal packed bytes, absmax and double-quant codes on
odd shapes too, and `nf4_dequantize` within 1e-7 of each block's scale
where the fp32 mean of the absmax agrees (JAX sums it in XLA's order);
`icq_search`'s factor grid and medians bit-equal, the chosen factor equal
on at least 99% of blocks (where it differs, JAX's entropies for the two
factors within 4 ulps), and codes, absmax and tau codes equal wherever it
is equal; `icq_dequantize` exact; `irqlora_quantize_model(TINY_LLAMA,
tau_n=10, blocksize2=4)` logits within 1e-5; TINY_MIXTRAL's expert
stacks within 1e-6 on at least 99% of entries; `ice_lora_apply` within
1e-5; and the oracle checks of `tests/test_nf4_irqlora.py`.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA, forward_logits, init_params
from llama3_quantization_tpu.quant import irqlora as JI
from llama3_quantization_tpu.quant import nf4 as JN
from llama3_quantization_tpu_torch import api, convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.quant import irqlora as TI
from llama3_quantization_tpu_torch.quant import nf4 as TN

from test_torch_model import to_numpy_tree

torch.set_num_threads(1)


def bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


# ------------------------------------------------------------- codebooks ----
def test_nf4_code_bit_equal():
    np.testing.assert_array_equal(bits(TN.NF4_CODE.numpy()), bits(JN.NF4_CODE))


@pytest.mark.parametrize("signed", [True, False])
def test_dynamic_map_bit_equal(signed):
    got = TN.make_dynamic_map(signed=signed).numpy()
    np.testing.assert_array_equal(bits(got), bits(JN.make_dynamic_map(signed=signed)))
    assert len(got) == 256
    np.testing.assert_array_equal(bits(TN.DYNAMIC_FP8_MAP.numpy()), bits(JN.DYNAMIC_FP8_MAP))


def test_dynamic_map_overflow_guard():
    with pytest.raises(ValueError, match="dynamic map"):
        TN.make_dynamic_map(signed=False, max_exponent_bits=8)


def _near(points: np.ndarray, ulps: int = 64) -> np.ndarray:
    """Every float32 within `ulps` of each point."""
    out = [points]
    for p in points:
        x = np.float32(p)
        up, down = [x], [x]
        for _ in range(ulps):
            up.append(np.nextafter(up[-1], np.float32(np.inf)))
            down.append(np.nextafter(down[-1], np.float32(-np.inf)))
        out.append(np.asarray(up + down, dtype=np.float32))
    return np.concatenate(out)


@pytest.mark.parametrize("which", ["nf4", "fp8"])
def test_quantize_to_codebook_is_the_argmin(which):
    tcode, jcode = ((TN.NF4_CODE, JN.NF4_CODE) if which == "nf4"
                    else (TN.DYNAMIC_FP8_MAP, JN.DYNAMIC_FP8_MAP))
    c = tcode.numpy().astype(np.float64)
    mids = ((c[:-1] + c[1:]) / 2).astype(np.float32)
    flips = TN.codebook_flips(tcode).numpy()
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1.1, 1.1, 20000).astype(np.float32),
                        tcode.numpy(), _near(mids), _near(flips)])
    got = TN.quantize_to_codebook(torch.from_numpy(x), tcode).numpy()
    ref = np.asarray(JN.quantize_to_codebook(jnp.asarray(x), jcode))
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.uint8


def test_codebook_roundtrip_exact():
    idx = TN.quantize_to_codebook(TN.NF4_CODE, TN.NF4_CODE)
    np.testing.assert_array_equal(idx.numpy(), np.arange(16))
    assert torch.equal(TN.dequantize_codebook(idx, TN.NF4_CODE), TN.NF4_CODE)


# -------------------------------------------------------------------- NF4 ----
@pytest.mark.parametrize("shape", [(7, 13), (64, 320), (300, 70), (256, 256)])
@pytest.mark.parametrize("double_quant", [False, True])
def test_nf4_quantize_matches_jax(shape, double_quant):
    w = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    t = TN.nf4_quantize(torch.from_numpy(w), double_quant=double_quant)
    j = JN.nf4_quantize(jnp.asarray(w), double_quant=double_quant)
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(t.absmax.numpy(), np.asarray(j.absmax))  # codes under dq
    np.testing.assert_array_equal(TN.nf4_codes(t).numpy(), np.asarray(JN.nf4_codes(j)))
    assert (t.shape, t.block_size) == (tuple(j.shape), j.block_size)
    got, ref = TN.nf4_dequantize(t).numpy(), np.asarray(JN.nf4_dequantize(j))
    assert got.shape == shape
    if not double_quant:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
        return
    # the per-group scale and mean offset are fp32 reductions in another
    # order: where they agree the values agree within 1e-7, and an ulp of
    # the mean moves each value by at most that ulp
    mean_ulp = np.spacing(np.float32(j.absmax_mean))
    same = float(t.absmax_mean) == float(j.absmax_mean) and np.array_equal(
        t.absmax_scale.numpy(), np.asarray(j.absmax_scale))
    tol = 1e-7 if same else 4 * mean_ulp * (1 + np.abs(TN.NF4_CODE.numpy()).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    np.testing.assert_allclose(t.absmax_scale.numpy(), np.asarray(j.absmax_scale), rtol=1e-6)


@pytest.mark.parametrize("shape", [(7, 13), (64, 320), (300, 70)])
def test_nf4_odd_shapes_roundtrip(shape):
    """`test_nf4_irqlora.py:152-166`: padded blocks and partial absmax groups."""
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    out = TN.nf4_dequantize(TN.nf4_quantize(w, double_quant=True))
    assert out.shape == shape
    assert float((out - w).norm() / w.norm()) < 0.12


def test_nf4_error_bounded_and_double_quant_close(rng):
    """`test_nf4_irqlora.py:36-57`."""
    w = rng.standard_normal((64, 128)).astype(np.float32) * 0.1
    back = TN.nf4_dequantize(TN.nf4_quantize(torch.from_numpy(w), double_quant=False)).numpy()
    blocks = w.reshape(-1, 64)
    absmax = np.abs(blocks).max(1, keepdims=True)
    gap = np.diff(TN.NF4_CODE.numpy()).max() / 2
    assert np.all(np.abs(back.reshape(-1, 64) - blocks) <= absmax * gap + 1e-6)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    e1, e2 = (np.abs(TN.nf4_dequantize(TN.nf4_quantize(torch.from_numpy(w), double_quant=dq))
                     .numpy() - w).mean() for dq in (False, True))
    assert e2 < e1 * 1.2


# -------------------------------------------------------------------- ICQ ----
@pytest.mark.parametrize("tau_range", [0.1, 0.05, 0.2])
@pytest.mark.parametrize("tau_n", [2, 3, 10, 16, 17, 51, 100])
def test_icq_factors_bit_equal(tau_range, tau_n):
    """The grid as JAX compiles it with `tau_range` passed, a traced
    argument of the jitted function."""
    ref = jax.jit(lambda t: jnp.linspace(-t * JI.SIGMA, t * JI.SIGMA, 2 * tau_n + 1))(tau_range)
    np.testing.assert_array_equal(bits(TI.icq_factors(tau_range, tau_n)), bits(ref))


@partial(jax.jit, static_argnames=("tau_n", "blocksize2"))
def _jax_icq_grid(w, tau_range, tau_n, blocksize2):
    """`icq_search`'s own steps up to its argmax (`irqlora.py:68-88`):
    medians, every factor's entropies and the chosen index."""
    wb = w.astype(jnp.float32).reshape(-1, blocksize2, 64)
    tau0 = jnp.median(wb, axis=2, keepdims=True)
    absmax0 = jnp.max(jnp.abs(wb - tau0), axis=2, keepdims=True)
    factors = jnp.linspace(-tau_range * JI.SIGMA, tau_range * JI.SIGMA, tau_n * 2 + 1)

    def eval_factor(factor):
        codes, _ = JI._nf4_block_quant(wb - (factor * absmax0 + tau0))
        return JI._block_entropy(codes)

    ent = jax.vmap(eval_factor)(factors)
    return tau0, ent, jnp.argmax(ent, axis=0)


ICQ_CASES = [  # (seed, tau_n, blocksize2, rows2, bias)
    (0, 10, 256, 4, 0.05), (1, 51, 256, 4, 0.3), (2, 10, 4, 64, 0.0), (3, 100, 256, 2, 0.05),
    (4, 3, 16, 16, 0.1),
]


@pytest.mark.parametrize("seed,tau_n,bs2,rows,bias", ICQ_CASES)
def test_icq_search_matches_jax(seed, tau_n, bs2, rows, bias):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(rows * bs2 * 64) * 0.2 + bias).astype(np.float32)
    wt = torch.from_numpy(w)
    jtau0, jent, jbest = (np.asarray(x) for x in _jax_icq_grid(jnp.asarray(w), 0.1, tau_n, bs2))
    wb = wt.reshape(-1, bs2, 64)
    tau0 = TI._median(wb)
    np.testing.assert_array_equal(bits(tau0.numpy()), bits(jtau0))
    absmax0 = (wb - tau0).abs().amax(dim=2, keepdim=True)
    best = TI.icq_best(wb, tau0, absmax0, torch.from_numpy(TI.icq_factors(0.1, tau_n))).numpy()
    same = best == jbest
    assert same.mean() >= 0.99
    r, c = np.nonzero(~same)
    a, b = jent[jbest[r, c], r, c], jent[best[r, c], r, c]
    assert np.all(np.abs(a.view(np.int32) - b.view(np.int32)) <= 4)

    q, j = TI.icq_search(wt, tau_n=tau_n, blocksize2=bs2), JI.icq_search(
        jnp.asarray(w), tau_range=0.1, tau_n=tau_n, blocksize2=bs2)
    codes_eq = (q.codes.numpy() == np.asarray(j.codes)).all(-1).reshape(same.shape)
    absmax_eq = (q.absmax.numpy() == np.asarray(j.absmax)).reshape(same.shape)
    tau_eq = (q.tau_codes.numpy() == np.asarray(j.tau_codes)).reshape(same.shape)
    assert (codes_eq & absmax_eq & tau_eq)[same].all()
    assert q.shape == tuple(j.shape) and q.codes.dtype == torch.uint8
    # icq_dequantize is exact on the same stored codes
    jq = JI.ICQWeight(*(jnp.asarray(x.numpy()) for x in (q.codes, q.absmax, q.tau_codes,
                                                          q.tau_absmax)), q.shape)
    np.testing.assert_array_equal(bits(TI.icq_dequantize(q).numpy()),
                                  bits(JI.icq_dequantize(jq)))


def test_icq_jax_default_call_within_bound():
    """JAX's `icq_search(w)` with `tau_range` left at its default folds the
    grid as a constant, an ulp away from the traced grid on some points;
    the port's `icq_search(w)` is held to it at the ICQ bound: the same
    codes on at least 99% of blocks."""
    w = (np.random.default_rng(9).standard_normal(4 * 256 * 64) * 0.2).astype(np.float32)
    q = TI.icq_search(torch.from_numpy(w), tau_n=51)
    j = JI.icq_search(jnp.asarray(w), tau_n=51)
    same = (q.codes.numpy() == np.asarray(j.codes)).all(-1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(q.absmax.numpy()[same], np.asarray(j.absmax)[same], rtol=1e-6)


def test_icq_improves_entropy(rng):
    """`test_nf4_irqlora.py:60-70`."""
    w = torch.from_numpy((rng.standard_normal((4 * 256 * 64,)) * 0.2 + 0.3).astype(np.float32))
    q = TI.icq_search(w, tau_n=10)
    codes0, _ = TI._nf4_block_quant(w.reshape(-1, 64))
    assert float(TI._block_entropy(q.codes).mean()) >= float(TI._block_entropy(codes0).mean()) - 1e-6


def test_icq_reconstruction_reasonable(rng):
    """`test_nf4_irqlora.py:73-78`."""
    w = rng.standard_normal((256 * 64 * 2,)).astype(np.float32)
    back = TI.icq_dequantize(TI.icq_search(torch.from_numpy(w), tau_n=5)).numpy().reshape(-1)
    assert np.corrcoef(back, w)[0, 1] > 0.98


def test_block_entropy_matches_jax():
    """Each factor's block entropies as `icq_search`'s fused computation
    adds them (its 16 terms in halves), on the codes that computation
    made."""
    @jax.jit
    def grid(w):
        wb = w.reshape(-1, 256, 64)
        tau0 = jnp.median(wb, axis=2, keepdims=True)
        absmax0 = jnp.max(jnp.abs(wb - tau0), axis=2, keepdims=True)

        def ev(f):
            codes, _ = JI._nf4_block_quant(wb - (f * absmax0 + tau0))
            return codes, JI._block_entropy(codes)

        return jax.vmap(ev)(jnp.linspace(-0.05, 0.05, 21))

    w = (np.random.default_rng(5).standard_normal(2 * 256 * 64) * 0.2 + 0.1).astype(np.float32)
    codes, ent = (np.asarray(x) for x in grid(jnp.asarray(w)))
    got = TI._block_entropy(torch.from_numpy(codes.copy())).numpy()
    np.testing.assert_array_equal(bits(got), bits(ent))


def test_ice_lora_apply_matches_jax(rng):
    k, n, r = 64, 256, 8
    w = rng.standard_normal((k, n)).astype(np.float32)
    q = TI.icq_search(torch.from_numpy(w.reshape(-1)), tau_n=3)
    q.shape = (k, n)
    jq = JI.ICQWeight(*(jnp.asarray(x.numpy()) for x in (q.codes, q.absmax, q.tau_codes,
                                                          q.tau_absmax)), (k, n))
    x = rng.standard_normal((4, k)).astype(np.float32)
    la = (rng.standard_normal((k, r)) * 0.01).astype(np.float32)
    lb = (rng.standard_normal((r, n)) * 0.01).astype(np.float32)
    for a_s, b_s in ((0.0, 0.0), (0.3, -0.2)):
        got = TI.ice_lora_apply(torch.from_numpy(x), q, torch.from_numpy(la), torch.from_numpy(lb),
                                a_s, b_s, scaling=0.5).numpy()
        ref = np.asarray(JI.ice_lora_apply(jnp.asarray(x), jq, jnp.asarray(la), jnp.asarray(lb),
                                           jnp.float32(a_s), jnp.float32(b_s), scaling=0.5))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # zero LoRA and scales: the base path (`test_nf4_irqlora.py:81-93`)
    base = TI.ice_lora_apply(torch.from_numpy(x), q, torch.from_numpy(la), torch.zeros(r, n),
                             0.0, 0.0).numpy()
    np.testing.assert_allclose(base, x @ TI.icq_dequantize(q).numpy(), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ model ----
@pytest.fixture(scope="module")
def tiny():
    jp = init_params(TINY_LLAMA, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, convert.params_from_numpy(to_numpy_tree(jp), device="cpu")


def test_irqlora_model_matches_jax(tiny):
    """The golden row's settings: every TINY_LLAMA linear ICQ-quantized."""
    jp, tp = tiny
    jq = JI.irqlora_quantize_model(jp, TINY_LLAMA, tau_n=10, blocksize2=4)
    tq = api.quantize(tp, tcfg.TINY_LLAMA, "irqlora", tau_n=10, blocksize2=4)
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        assert not torch.equal(tq["layers"][name]["w"], tp["layers"][name]["w"]), name
    toks = np.random.default_rng(1).integers(0, TINY_LLAMA.vocab_size, (2, 16))
    ref = np.asarray(forward_logits(jq, jnp.asarray(toks), TINY_LLAMA))
    got = TT.forward_logits(tq, torch.from_numpy(toks), tcfg.TINY_LLAMA).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_irqlora_skips_unblockable_and_refuses_moe(tiny):
    """(The name is kept from when the port refused MoE expert stacks.)
    The reference skips shapes that are not whole blocks (fp kept); on
    TINY_MIXTRAL every expert of the `[L, E, K, N]` stacks is ICQ-quantized
    and dequantized in place (`irqlora.py:152-172`): each stack within 1e-6
    of JAX's wherever ICQ chose JAX's factor, on at least 99% of entries."""
    from llama3_quantization_tpu.models.configs import TINY_MIXTRAL

    _, tp = tiny
    out = api.quantize(tp, tcfg.TINY_LLAMA, "irqlora", tau_n=2)  # blocksize2 256: too small
    for name in ("q", "down"):
        assert torch.equal(out["layers"][name]["w"], tp["layers"][name]["w"])
    jp = init_params(TINY_MIXTRAL, jax.random.PRNGKey(0), dtype=jnp.float32)
    mp = convert.params_from_numpy(to_numpy_tree(jp), device="cpu")
    jq = JI.irqlora_quantize_model(jp, TINY_MIXTRAL, tau_n=4, blocksize2=16)
    tq = TI.irqlora_quantize_model(mp, tcfg.TINY_MIXTRAL, tau_n=4, blocksize2=16)
    for name in ("gate", "up", "down"):
        got = tq["layers"]["experts"][name]["w"].numpy()
        ref = np.asarray(jq["layers"]["experts"][name]["w"])
        assert not np.array_equal(got, np.asarray(jp["layers"]["experts"][name]["w"]))
        assert (np.abs(got - ref) <= 1e-6).mean() >= 0.99, name