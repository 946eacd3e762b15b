"""Port parity: quantized-KV flash decode, kernel B4/B5.

The port's plain version (what its wrapper runs on CPU tensors) against
the JAX Pallas kernels `flash_decode_gqa_s8(_stacked)` in interpret mode,
on the int8 cache and the int4 T-pair pack, with and without the m/l
statistics, with T = 2 * block_t so that the per-block probability
re-quantization runs twice, and with masked slots. The s32 partials must
be bit-exact on equal integer inputs. Output tolerance `atol = 2e-3 *
max|out|`: a 1-ulp `exp` difference can move one probability code by one
step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.ops.decode_attention import NEG as J_NEG
from llama3_quantization_tpu.ops.decode_attention import _split_s8_rows
from llama3_quantization_tpu.ops.decode_attention import flash_decode_gqa_s8 as j_decode_layer
from llama3_quantization_tpu.ops.decode_attention import flash_decode_gqa_s8_stacked as j_decode
from llama3_quantization_tpu.ops.kvcache import kv4_quantize as j_kv4_quantize
from llama3_quantization_tpu.ops.kvcache import kv_quantize as j_kv_quantize
from llama3_quantization_tpu_torch.ops import decode_attention as da
from llama3_quantization_tpu_torch.ops.kvcache import kv_quantize as t_kv_quantize

torch.set_num_threads(1)

L, B, G, REP, D, BLOCK_T = 2, 2, 2, 2, 16, 32
T = 2 * BLOCK_T


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, G * REP, D)).astype(np.float32)
    kv = rng.standard_normal((2, L, B, G, T, D)).astype(np.float32)
    mask = rng.uniform(-2.0, 0.0, (B, T)).astype(np.float32)
    mask[0, T - 11:] = J_NEG  # tail of row 0 masked (crosses into block 2)
    mask[1, :5] = J_NEG
    mask[1, BLOCK_T + 3 : BLOCK_T + 9] = J_NEG
    return q, kv, mask


def test_kv_quantize_exact():
    _, kv, _ = _inputs()
    jc, js = j_kv_quantize(jnp.asarray(kv))
    tc, ts = t_kv_quantize(torch.from_numpy(kv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("layer", [0, 1])
def test_plain_matches_pallas_stacked(layer):
    q, kv, mask = _inputs(layer)
    kq, ks = j_kv_quantize(jnp.asarray(kv[0]))
    vq, vs = j_kv_quantize(jnp.asarray(kv[1]))
    ref = np.asarray(j_decode(jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(mask), layer,
                              out_dtype=jnp.float32, block_t=BLOCK_T, interpret=True))
    t = [torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)]
    got = da.flash_decode_gqa_s8_stacked(torch.from_numpy(q), *t, torch.from_numpy(mask), layer,
                                         out_dtype=torch.float32, block_t=BLOCK_T).numpy()
    assert got.shape == (B, 1, G * REP, D)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * np.abs(ref).max())


def test_single_block_is_one_softmax():
    """With T == block_t the blocked recurrence is one exact softmax pass:
    cross-check against a direct (non-online) computation."""
    q, kv, mask = _inputs(5)
    kq, ks = t_kv_quantize(torch.from_numpy(kv[0][0]))
    vq, vs = t_kv_quantize(torch.from_numpy(kv[1][0]))
    got = da.decode_s8_plain(torch.from_numpy(q), kq, ks, vq, vs, torch.from_numpy(mask),
                             torch.float32, block_t=T)
    kf, vf = kq.float() * ks, vq.float() * vs
    qg = torch.from_numpy(q).reshape(B, G, REP, D)
    s = torch.einsum("bgrd,bgtd->bgrt", qg, kf) / D**0.5 + torch.from_numpy(mask)[:, None, None]
    ref = torch.einsum("bgrt,bgtd->bgrd", torch.softmax(s, -1), vf).reshape(B, 1, G * REP, D)
    # s8 quantization of q and of the probabilities: ~1% of the output scale
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-2 * float(ref.abs().max()))


@pytest.mark.parametrize("shape", [((3, 5, 16), (3, 16, 9)), ((2, 4, 1024), (2, 1024, 128))])
def test_s8_dot_bit_exact(shape):
    rng = np.random.default_rng(1)
    a = rng.integers(-127, 128, shape[0], dtype=np.int8)
    b = rng.integers(-127, 128, shape[1], dtype=np.int8)
    a[0, 0, :] = 127
    b[0, :, 0] = 127  # the largest partial the decode dots can form
    ref = np.asarray(jax.lax.dot_general(
        jnp.asarray(a), jnp.asarray(b), (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32))
    got = da.s8_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def _cache(kv, int4):
    """(k_q, k_s, v_q, v_s) JAX arrays from kv [2, ..., T, D]: int8 codes,
    or the int4 T-pair pack."""
    quantize = j_kv4_quantize if int4 else j_kv_quantize
    kq, ks = quantize(jnp.asarray(kv[0]))
    vq, vs = quantize(jnp.asarray(kv[1]))
    return kq, ks, vq, vs


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("layer", [0, 1])
def test_stats_and_int4_match_pallas_stacked(int4, layer):
    """B5 with `return_stats` (int8 and int4) and B5-int4 without: o within
    2e-3 * max|o|, m within 1e-6 * |m|, l within 1e-5 * l. Row 1 of the
    batch is all masked: m = -1e30 and l = T on both sides (the finite mask
    makes every p = 1; the merge weights the row out through m)."""
    q, kv, mask = _inputs(layer + 10)
    mask[1, :] = J_NEG
    arrs = _cache(kv, int4)
    t = [torch.from_numpy(np.array(a)) for a in arrs]
    jo, jm, jl = j_decode(jnp.asarray(q), *arrs, jnp.asarray(mask), layer, out_dtype=jnp.float32,
                          block_t=BLOCK_T, interpret=True, return_stats=True)
    to, tm, tl = da.flash_decode_gqa_s8_stacked(torch.from_numpy(q), *t, torch.from_numpy(mask),
                                                layer, out_dtype=torch.float32, block_t=BLOCK_T,
                                                return_stats=True)
    jo, jm, jl = np.asarray(jo), np.asarray(jm), np.asarray(jl)
    assert tm.shape == tl.shape == (B, G, REP)
    np.testing.assert_allclose(to.numpy(), jo, rtol=0, atol=2e-3 * np.abs(jo).max())
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=0)
    assert np.all(tm.numpy()[1] == np.float32(J_NEG)) and np.all(tl.numpy()[1] == T)
    plain = da.flash_decode_gqa_s8_stacked(torch.from_numpy(q), *t, torch.from_numpy(mask),
                                           layer, out_dtype=torch.float32, block_t=BLOCK_T)
    np.testing.assert_array_equal(plain.numpy(), to.numpy())


def test_int4_per_layer_matches_pallas():
    """B4 on an int4 layer cache (the per-slot decode route)."""
    q, kv, mask = _inputs(7)
    kq, ks, vq, vs = _cache(kv[:, 0], True)
    ref = np.asarray(j_decode_layer(jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(mask),
                                    out_dtype=jnp.float32, block_t=BLOCK_T, interpret=True))
    t = [torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)]
    assert t[0].dtype == torch.uint8 and t[0].shape[2] == T // 2
    got = da.flash_decode_gqa_s8(torch.from_numpy(q), *t, torch.from_numpy(mask),
                                 out_dtype=torch.float32, block_t=BLOCK_T).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * np.abs(ref).max())


def test_int4_split_dot_is_exact():
    """The TPU's int4 dot splits each s8 operand in [-119, 119] into two int4
    rows (`_split_s8_rows`); recombined it equals the plain s8 dot over the
    unpacked codes, so the port's integers are the TPU's."""
    rng = np.random.default_rng(3)
    a = rng.integers(-119, 120, (4, 32)).astype(np.int32)
    a[0, :] = 119
    a[1, :] = -119
    c = rng.integers(-8, 8, (32, 24)).astype(np.int8)
    hi, lo = _split_s8_rows(jnp.asarray(a))
    dot = lambda x: np.asarray(x, np.int64) @ c.astype(np.int64)  # noqa: E731
    split = 16 * dot(hi) + dot(lo)
    got = da.s8_dot(torch.from_numpy(a.astype(np.int8)), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), split)
