"""Port parity: `sample_generate` and `speculative_generate`.

- `sample_generate` at temperature 0 gives `greedy_generate`'s tokens and
  JAX's `sample_generate`'s; `top_k=1` is greedy at any temperature; a
  seeded `torch.Generator` repeats its stream and another seed changes it
  (the draws are the generator's own, not JAX's random stream).
- `speculative_generate` against JAX (TINY_LLAMA fp32 weights, the default
  fp cache of 64 slots, `n_rounds=6`, `k=3`, JAX on its kernel route), with
  the target as its own draft and with a mismatched draft: identical
  tokens, counts and final position, and `flatten_speculative` equal to
  the target's greedy stream. The port reproduces JAX's draft-cache hole
  (the draft never writes its k-th proposal), so counts match too.
- the batch-1 guard, and one run on the int8 cache.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import transformer as TT
from test_torch_model import jax_kernel_route, to_numpy_tree  # noqa: F401  (fixtures)

torch.set_num_threads(1)

CFG, TCFG = TINY_LLAMA, tcfg.TINY_LLAMA


@pytest.fixture(scope="module")
def fp32_models():
    """(JAX, port) fp32 TINY_LLAMA weights from PRNGKey 0 (the target) and 9
    (the mismatched draft), as in tests/test_generate.py."""
    out = {}
    for seed in (0, 9):
        p = init_params(CFG, jax.random.PRNGKey(seed), dtype=jnp.float32)
        out[seed] = (p, convert.params_from_numpy(to_numpy_tree(p), device="cpu"))
    return out


def _tcache(b, max_len=32, **kw):
    return TT.init_kv_cache(TCFG, b, max_len, device="cpu", **kw)


def test_sample_temperature_zero_is_greedy(fp32_models, jax_kernel_route):
    jparams, tparams = fp32_models[0]
    first = np.array([[0], [7]], np.int32)
    jtoks, _ = JT.sample_generate(jparams, JT.init_kv_cache(CFG, 2, 32), jnp.asarray(first), 0, 8,
                                  CFG, jax.random.PRNGKey(7), temperature=0.0)
    ttoks, _ = TT.sample_generate(tparams, _tcache(2), torch.from_numpy(first).long(), 0, 8, TCFG,
                                  torch.Generator().manual_seed(7), temperature=0.0)
    greedy, _ = TT.greedy_generate(tparams, _tcache(2), torch.from_numpy(first).long(), 0, 8, TCFG)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert torch.equal(ttoks, greedy)


def test_sample_top_k1_is_greedy(fp32_models):
    _, tparams = fp32_models[0]
    first = torch.zeros((2, 1), dtype=torch.long)
    greedy, _ = TT.greedy_generate(tparams, _tcache(2), first, 0, 8, TCFG)
    s, _ = TT.sample_generate(tparams, _tcache(2), first, 0, 8, TCFG,
                              torch.Generator().manual_seed(3), temperature=0.7, top_k=1)
    assert torch.equal(s, greedy)


def test_sample_seeded_deterministic_and_varied(fp32_models):
    _, tparams = fp32_models[0]
    first = torch.zeros((2, 1), dtype=torch.long)

    def run(seed):
        toks, cache = TT.sample_generate(tparams, _tcache(2), first, 0, 12, TCFG,
                                         torch.Generator().manual_seed(seed), temperature=1.5,
                                         top_p=0.9)
        return toks

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (2, 12) and bool(((a >= 0) & (a < TCFG.vocab_size)).all())


@pytest.mark.parametrize("draft_seed", [0, 9])
def test_speculative_matches_jax(fp32_models, jax_kernel_route, draft_seed):
    """Draft = target (seed 0) and a mismatched draft (seed 9)."""
    (jp, tp), (jd, td) = fp32_models[0], fp32_models[draft_seed]
    n_rounds, k = 6, 3
    jtoks, jcounts, _, _, jpos = JT.speculative_generate(
        jp, jd, JT.init_kv_cache(CFG, 1, 64), JT.init_kv_cache(CFG, 1, 64),
        jnp.zeros((1, 1), jnp.int32), 0, n_rounds, k, CFG)
    ttoks, tcounts, tcache, _, tpos = TT.speculative_generate(
        tp, td, _tcache(1, 64), _tcache(1, 64), torch.zeros((1, 1), dtype=torch.long), 0,
        n_rounds, k, TCFG)
    assert ttoks.shape == (n_rounds, k + 1) and tcounts.shape == (n_rounds,)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert tpos == int(jpos) == int(tcounts.sum())
    spec = TT.flatten_speculative(ttoks, tcounts)
    assert spec == JT.flatten_speculative(jtoks, jcounts)
    greedy, _ = TT.greedy_generate(tp, _tcache(1, 64), torch.zeros((1, 1), dtype=torch.long), 0,
                                   len(spec), TCFG)
    assert spec == greedy[0].tolist()
    assert TT.flatten_speculative(ttoks, tcounts, limit=5) == spec[:5]


def test_speculative_batch_guard(fp32_models):
    _, tp = fp32_models[0]
    with pytest.raises(ValueError, match="batch=1"):
        TT.speculative_generate(tp, tp, _tcache(2), _tcache(2), torch.zeros((2, 1), dtype=torch.long),
                                0, 2, 2, TCFG)


def test_speculative_on_int8_cache(fp32_models):
    """The quantized cache through the same rounds: the emitted stream is
    the target's greedy stream on that cache."""
    (_, tp), (_, td) = fp32_models[0], fp32_models[9]
    first = torch.zeros((1, 1), dtype=torch.long)
    toks, counts, _, _, pos = TT.speculative_generate(
        tp, td, _tcache(1, 64, quantized=8), _tcache(1, 64, quantized=8), first, 0, 5, 3, TCFG)
    spec = TT.flatten_speculative(toks, counts)
    greedy, _ = TT.greedy_generate(tp, _tcache(1, 64, quantized=8), first, 0, len(spec), TCFG)
    assert spec == greedy[0].tolist() and pos == len(spec)
    assert int(counts.min()) >= 1 and int(counts.max()) <= 4
