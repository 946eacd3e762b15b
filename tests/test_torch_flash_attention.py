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

