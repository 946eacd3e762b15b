"""Port parity: causal full-sequence attention, kernel B7.

The port's plain version (what its wrapper runs on CPU tensors) against the
JAX package's eager `_attention` under `causal_mask`, which is what JAX
runs off the TPU in place of the Pallas flash kernel. fp32, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

B, H, G, D = 2, 4, 2, 16


def _qkv(s, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, s, H, D)).astype(np.float32),
            rng.standard_normal((B, s, G, D)).astype(np.float32),
            rng.standard_normal((B, s, G, D)).astype(np.float32))


@pytest.mark.parametrize("s", [128, 160])
def test_plain_matches_eager_causal(s):
    q, k, v = _qkv(s, s)
    ref = np.asarray(JT._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   JT.causal_mask(s), TINY_LLAMA, JT.NO_QUANT))
    got = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (B, s, H, D)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_causal_mask_matches():
    for s, t, off in ((5, None, 0), (3, 7, 4)):
        np.testing.assert_array_equal(fa.causal_mask(s, t, off).numpy(),
                                      np.asarray(JT.causal_mask(s, t, off)))



@pytest.mark.parametrize("b,s,h,bq", [(1, 2048, 32, 128), (1, 128, 32, 64), (8, 128, 32, 128),
                                      (1, 512, 32, 64), (2, 1000, 4, 64)])
def test_q_tile_fills_the_card(b, s, h, bq):
    """128-row q tiles where they give at least one block per H100 SM."""
    assert fa.q_tile(b, s, h) == bq


@pytest.fixture
def no_build(monkeypatch):
    from llama3_quantization_tpu_torch.ops import _build

    def refuse(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load", refuse)


@pytest.mark.parametrize("q,k", [((1, 128, 4, 96), (1, 128, 2, 96)),     # D = 96
                                 ((1, 128, 3, 64), (1, 128, 2, 64)),     # H % G != 0
                                 ((1, 128, 4, 64), (1, 160, 2, 64)),     # K/V of another S
                                 ((1, 128, 4, 64), (1, 128, 2, 64))])    # CPU tensors
def test_flash_kernel_refuses_before_build(no_build, q, k):
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(torch.zeros(q, dtype=torch.bfloat16),
                                torch.zeros(k, dtype=torch.bfloat16),
                                torch.zeros(k, dtype=torch.bfloat16))
