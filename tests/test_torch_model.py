"""Port parity for the slice as a whole: TINY_LLAMA W4 g32 packed.

The JAX parameter tree is flattened to numpy here and carried into the
port with `convert.params_from_numpy`, so both sides run the same weights
(fp32 activations, on the CPU, where the port's kernel wrappers run their
plain versions).

- `forward_logits` against JAX on its kernel route (the "pallas" matmul
  backend, kernels interpreted) with the bf16 tolerance of
  tests/test_pallas.py (rtol 2e-2), and against the JAX default fp32
  dequant path within 2e-2 of the logit scale (the port rounds x to bf16);
- `greedy_generate` (8 steps, int8 cache) against JAX on its kernel route
  with the interpreted decode kernel: identical tokens;
- `sample_logits`: the tokens it can draw are the ones JAX's top-k / top-p
  masks keep, greedy and top_k=1 are argmax, a seeded generator repeats.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA, init_params, quantize_model_rtn
from llama3_quantization_tpu.models import configs as jcfg
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.ops import matmul as jmm
from llama3_quantization_tpu.ops import pallas_qmatmul as jpq
from llama3_quantization_tpu.quant import QuantSpec
from llama3_quantization_tpu.quant.qtensor import QuantizedTensor as JQT
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import transformer as TT

torch.set_num_threads(1)

CFG = TINY_LLAMA
MAX_LEN = 64


def to_numpy_tree(node):
    """JAX params -> nested dicts of numpy arrays, QuantizedTensor as a
    dict of its fields and meta (the input of `params_from_numpy`)."""
    if isinstance(node, JQT):
        def arr(x):
            return None if x is None else np.asarray(x)
        return {"data": arr(node.data), "scale": arr(node.scale), "zero": arr(node.zero),
                "g_idx": arr(node.g_idx), "bits": node.bits, "group_size": node.group_size,
                "k": node.k, "n": node.n, "packed": node.packed, "sym": node.sym,
                "out_dtype": jnp.dtype(node.out_dtype).name}
    if isinstance(node, dict):
        return {k: to_numpy_tree(v) for k, v in node.items()}
    return np.asarray(node)


@pytest.fixture(scope="module")
def models():
    params = init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    jparams = quantize_model_rtn(params, CFG, QuantSpec(n_bits=4, group_size=32), pack=True)
    tparams = convert.params_from_numpy(to_numpy_tree(jparams), device="cpu")
    return jparams, tparams


@pytest.mark.parametrize("name", sorted(jcfg.NAMED_CONFIGS))
def test_config_copy_matches(name):
    jc, tc = jcfg.NAMED_CONFIGS[name], tcfg.NAMED_CONFIGS[name]
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (jc.head_dim_, jc.rope_scaling_) == (tc.head_dim_, tc.rope_scaling_)


def test_params_carried_exactly(models):
    jparams, tparams = models
    jq, tq = jparams["layers"]["gate"]["w"], tparams["layers"]["gate"]["w"]
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert tq.data.dtype == torch.uint8 and tq.packed and tq.bits == 4
    np.testing.assert_array_equal(tparams["embed"].numpy(), np.asarray(jparams["embed"]))


@pytest.fixture
def jax_kernel_route(monkeypatch):
    """JAX on its kernel route, run on the CPU: the "pallas" matmul backend
    with the Pallas kernels interpreted, and the interpreted decode kernel."""
    monkeypatch.setattr(jpq, "fused_dequant_matmul",
                        functools.partial(jpq.fused_dequant_matmul, interpret=True))
    JT.set_decode_kernel("interpret")
    try:
        with jmm.backend("pallas"):
            yield
    finally:
        JT.set_decode_kernel("auto")


def _tokens(b, s):
    return np.random.default_rng(s).integers(0, CFG.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("b,s", [(2, 16), (1, 130)])
def test_forward_logits_matches_jax_kernel_route(models, jax_kernel_route, b, s):
    jparams, tparams = models
    toks = _tokens(b, s)
    ref = np.asarray(JT.forward_logits(jparams, jnp.asarray(toks), CFG))
    got = TT.forward_logits(tparams, torch.from_numpy(toks), tcfg.TINY_LLAMA).numpy()
    assert got.shape == (b, s, CFG.vocab_size)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max() / 10)


@pytest.mark.parametrize("b,s", [(2, 16), (1, 130)])
def test_forward_logits_matches_jax_default(models, b, s):
    """Against the JAX default (fp32 dequant) path: the port's kernels round
    x to bf16, so the gap is bf16-level relative to the logit scale."""
    jparams, tparams = models
    toks = _tokens(b, s)
    ref = np.asarray(JT.forward_logits(jparams, jnp.asarray(toks), CFG))
    got = TT.forward_logits(tparams, torch.from_numpy(toks), tcfg.TINY_LLAMA).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2 * np.abs(ref).max())


@pytest.mark.parametrize("scaling", [None, ("linear", 4.0, 1.0, 4.0, 8192),
                                     ("llama3", 8.0, 1.0, 4.0, 8192)])
def test_rope_matches(scaling):
    pos = np.arange(0, 4000, 37, dtype=np.int32)[None, :]
    jcos, jsin = JT.rope_cos_sin(jnp.asarray(pos), 128, 500000.0, jnp.float32, scaling)
    tcos, tsin = TT.rope_cos_sin(torch.from_numpy(pos), 128, 500000.0, torch.float32, scaling)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), rtol=0, atol=2e-6)
    x = np.random.default_rng(0).standard_normal((1, pos.shape[1], 2, 128)).astype(np.float32)
    np.testing.assert_allclose(
        TT.apply_rope(torch.from_numpy(x), tcos, tsin).numpy(),
        np.asarray(JT.apply_rope(jnp.asarray(x), jcos, jsin)), rtol=0, atol=1e-5)


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((2, 5, 64)).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        TT.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(JT.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pos,s,max_len,sink", [
    (0, 16, 64, 0), (5, 1, 64, 0), (70, 1, 64, 0), (70, 1, 64, 4), (3, 4, 16, 2),
])
def test_ring_write_and_mask_matches(pos, s, max_len, sink):
    jslot, jmask = JT._ring_write_and_mask(jnp.int32(pos), s, max_len, sink)
    tslot, tmask = TT._ring_write_and_mask(pos, s, max_len, sink, "cpu")
    assert int(jslot) == tslot
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_greedy_generate_identical_tokens(models, jax_kernel_route):
    jparams, tparams = models
    b, s, n_steps = 2, 16, 8
    prompt = np.random.default_rng(42).integers(0, CFG.vocab_size, (b, s)).astype(np.int32)

    jcache = JT.init_kv_cache(CFG, b, MAX_LEN, quantized=8)
    jlogits, jcache = JT.decode_step(jparams, jcache, jnp.asarray(prompt), jnp.int32(0), CFG)
    jfirst = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    jtoks, _ = JT.greedy_generate(jparams, jcache, jfirst, jnp.int32(s), n_steps, CFG)

    tcache = TT.init_kv_cache(tcfg.TINY_LLAMA, b, MAX_LEN, quantized=8, device="cpu")
    tlogits, tcache = TT.decode_step(tparams, tcache, torch.from_numpy(prompt), 0, tcfg.TINY_LLAMA)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jlogits)).max())
    tfirst = tlogits[:, -1].argmax(dim=-1)[:, None]
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    ttoks, tcache = TT.greedy_generate(tparams, tcache, tfirst, s, n_steps, tcfg.TINY_LLAMA)
    assert ttoks.shape == (b, n_steps)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 0.8), (0.7, 5, 1.0), (1.3, 6, 0.9)])
def test_sample_logits_kept_set_matches(temperature, top_k, top_p):
    """The port draws from its own `torch.Generator` and does not reproduce
    JAX's random stream, so the draws are compared as sets: 2048 JAX draws
    and 2048 port draws each hit exactly the tokens the port's top-k /
    top-p masks keep (every kept token has probability >= 2%)."""
    logits = np.array([[2.0, 1.5, 1.4, 1.0, 0.9, 0.5, 0.2, 0.1, -1.0, -3.0, -3.5, -6.0]], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 2048)
    jdraws = jax.vmap(lambda k: JT.sample_logits(jnp.asarray(logits), k, temperature, top_k, top_p))(keys)
    kept = TT.sampling_logits(torch.from_numpy(logits), temperature, top_k, top_p)
    kept_set = set(np.flatnonzero(np.isfinite(kept.numpy()[0])).tolist())
    probs = torch.softmax(kept, dim=-1)[0]
    assert float(probs[sorted(kept_set)].min()) >= 0.02 and len(kept_set) < logits.shape[1]
    assert set(np.asarray(jdraws).ravel().tolist()) == kept_set
    gen = torch.Generator().manual_seed(0)
    tdraws = TT.sample_logits(torch.from_numpy(logits).expand(2048, -1), gen, temperature, top_k, top_p)
    assert set(tdraws.tolist()) == kept_set


def test_sample_logits_greedy_and_seeded():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    argmax = logits.argmax(dim=-1)
    assert torch.equal(TT.sample_logits(logits, None, temperature=0.0), argmax)
    assert torch.equal(TT.sample_logits(logits, torch.Generator().manual_seed(3), 2.0, top_k=1), argmax)
    draw = lambda seed: TT.sample_logits(logits, torch.Generator().manual_seed(seed), 1.0)  # noqa: E731
    assert torch.equal(draw(7), draw(7))
    assert any(not torch.equal(draw(7), draw(s)) for s in range(8, 12))
