"""Port parity: the runtime fake-quant hooks (`RuntimeQuantConfig`).

- `fake_quant_dynamic` equal to JAX's eager function: asymmetric 8- and
  4-bit per token, grouped (with a padded tail group), symmetric,
  `disable_zero_point`, and the `fix0to1` softmax metric; a 16-bit spec
  passes its input through.
- `forward_logits` and `decode_step` (fp32 cache) under `act` 8-bit, `k`
  and `v` 4-bit, against JAX on its kernel route: within rtol 1e-4, atol
  1e-4 on TINY_LLAMA fp32 weights (JAX's own criterion), and greedy tokens
  equal with W4 g32 packed weights.
- Routing, shown with spies on the kernel wrappers: any q/k/v/p spec (an
  off one too) keeps the S = 128 forward off B7; an enabled k hook keeps
  `decode_step` off B6 and B5 and `greedy_generate` on an int4 cache off
  the windowed decode, while a disabled one (16 bits) keeps them on.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.quant import quantizer as JQ
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.models import windowed as TW
from llama3_quantization_tpu_torch.quant import quantizer as TQ
from test_torch_model import jax_kernel_route, models, to_numpy_tree  # noqa: F401  (fixtures)

torch.set_num_threads(1)

CFG, TCFG = TINY_LLAMA, tcfg.TINY_LLAMA

SPECS = {
    "asym8": dict(n_bits=8),
    "asym4": dict(n_bits=4),
    "group16": dict(n_bits=4, group_size=16),
    "sym8": dict(n_bits=8, symmetric=True),
    "nozp4": dict(n_bits=4, disable_zero_point=True),
    "fix0to1": dict(n_bits=8, metric="fix0to1"),
    "off": dict(n_bits=16),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_fake_quant_dynamic_matches_jax(name):
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((3, 5, 40)).astype(np.float32) * 3.0
    if name == "fix0to1":
        x = rng.uniform(0.0, 1.0, (3, 5, 40)).astype(np.float32)
    ref = np.asarray(JQ.fake_quant_dynamic(jnp.asarray(x), JQ.QuantSpec(**SPECS[name])))
    got = TQ.fake_quant_dynamic(torch.from_numpy(x), TQ.QuantSpec(**SPECS[name])).numpy()
    np.testing.assert_array_equal(got, ref)
    if name == "off":
        np.testing.assert_array_equal(got, x)


def _rq(mod, **bits):
    """`mod.RuntimeQuantConfig` (JAX's or the port's) with an n-bit spec per hook."""
    spec = JQ.QuantSpec if mod is JT else TQ.QuantSpec
    return mod.RuntimeQuantConfig(**{k: spec(n_bits=b) for k, b in bits.items()})


HOOKS = dict(act=8, k=4, v=4)


@pytest.fixture(scope="module")
def fp32_model():
    p = init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return p, convert.params_from_numpy(to_numpy_tree(p), device="cpu")


def test_hooked_forward_matches_jax(fp32_model, jax_kernel_route):
    jp, tp = fp32_model
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 16)).astype(np.int32)
    ref = JT.forward_logits(jp, jnp.asarray(toks), CFG, _rq(JT, **HOOKS))
    got = TT.forward_logits(tp, torch.from_numpy(toks).long(), TCFG, _rq(TT, **HOOKS))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    plain = TT.forward_logits(tp, torch.from_numpy(toks).long(), TCFG)
    assert float((plain - got).abs().max()) > 1e-3  # the hooks change the numbers


@pytest.mark.parametrize("weights", ["fp32", "w4"])
def test_hooked_decode_matches_jax(fp32_model, models, jax_kernel_route, weights):
    """4-token prefill then 6 single-token steps on an fp32 cache, all under
    the hooks (the eager route: the KV4 hook is enabled)."""
    jp, tp = fp32_model if weights == "fp32" else models
    toks = np.random.default_rng(2).integers(0, CFG.vocab_size, (2, 10)).astype(np.int32)
    jstep = jax.jit(functools.partial(JT.decode_step, cfg=CFG, rq=_rq(JT, **HOOKS)))
    jcache = JT.init_kv_cache(CFG, 2, 64, dtype=jnp.float32)
    tcache = TT.init_kv_cache(TCFG, 2, 64, dtype=torch.float32, device="cpu")
    for i0, i1 in [(0, 4)] + [(i, i + 1) for i in range(4, 10)]:
        jlg, jcache = jstep(jp, jcache, jnp.asarray(toks[:, i0:i1]), jnp.int32(i0))
        tlg, tcache = TT.decode_step(tp, tcache, torch.from_numpy(toks[:, i0:i1]).long(), i0,
                                     TCFG, _rq(TT, **HOOKS))
        if weights == "fp32":
            np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tlg[:, -1].argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(jlg[:, -1], -1)))


class Spy:
    """Counts calls of a wrapped function."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.fixture
def spies(monkeypatch):
    out = {}
    for name in ("flash_attention", "flash_decode_gqa", "flash_decode_gqa_stacked",
                 "flash_decode_gqa_s8_stacked"):
        out[name] = Spy(getattr(TT, name))
        monkeypatch.setattr(TT, name, out[name])
    out["decode_window"] = Spy(TW.decode_window)
    monkeypatch.setattr(TW, "decode_window", out["decode_window"])
    return out


@pytest.mark.parametrize("rq,flash", [
    ({}, True), (dict(q=16), False), (dict(p=8), False), (dict(act=8), True),
])
def test_any_attention_spec_keeps_forward_off_b7(fp32_model, spies, rq, flash):
    _, tp = fp32_model
    toks = torch.randint(0, TCFG.vocab_size, (1, 128), generator=torch.Generator().manual_seed(0))
    TT.forward_logits(tp, toks, TCFG, _rq(TT, **rq))
    assert (spies["flash_attention"].calls > 0) == flash


@pytest.mark.parametrize("quantized,key", [(False, "flash_decode_gqa_stacked"),
                                          (8, "flash_decode_gqa_s8_stacked")])
@pytest.mark.parametrize("bits,kernel", [(4, False), (16, True)])
def test_enabled_hook_keeps_decode_off_kernels(fp32_model, spies, quantized, key, bits, kernel):
    _, tp = fp32_model
    cache = TT.init_kv_cache(TCFG, 2, 64, quantized=quantized, device="cpu")
    toks = torch.randint(0, TCFG.vocab_size, (2, 5), generator=torch.Generator().manual_seed(1))
    rq = _rq(TT, k=bits)
    _, cache = TT.decode_step(tp, cache, toks, 0, TCFG, rq)
    TT.decode_step(tp, cache, toks[:, -1:], 5, TCFG, rq)
    TT.decode_step_multi(tp, cache, toks[:, -1:], torch.tensor([6, 3]), TCFG, rq)
    calls = spies[key].calls + spies["flash_decode_gqa"].calls
    assert calls == (2 * TCFG.num_layers if kernel else 0)


@pytest.mark.parametrize("bits,windowed", [(4, False), (16, True)])
def test_enabled_hook_keeps_int4_greedy_off_windowed(fp32_model, spies, bits, windowed):
    _, tp = fp32_model
    cache = TT.init_kv_cache(TCFG, 1, 64, quantized=4, device="cpu")
    toks = torch.randint(0, TCFG.vocab_size, (1, 6), generator=torch.Generator().manual_seed(2))
    rq = _rq(TT, k=bits)
    _, cache = TT.decode_step(tp, cache, toks, 0, TCFG, rq)
    out, _ = TT.greedy_generate(tp, cache, toks[:, -1:], 6, 4, TCFG, rq)
    assert out.shape == (1, 4)
    assert (spies["decode_window"].calls == 1) == windowed
    assert TW.windowed_ok(TCFG, cache, rq) == windowed
