"""Port parity: the int8 and int4 KV caches (`ops/kvcache.py`).

Every comparison here is exact: the int4 codes, the T-pair pack and its
unpack, and the cache writes (scalar and per-row vector positions, single
tokens and spans at either nibble parity) give byte-identical buffers to
the JAX package's on the same inputs, as does the sink+ring write slot and
mask with per-row positions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.ops import kvcache as jkv
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.ops import kvcache as tkv

torch.set_num_threads(1)

L, B, H, T, D = 2, 3, 2, 16, 8


def _same(got, ref):
    got = [g.numpy() for g in got]
    ref = [np.asarray(r) for r in ref]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def _kv(seed, s, b=B):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, b, s, H, D)) * rng.uniform(0.1, 3.0, (2, b, s, H, 1))).astype(np.float32)


def test_kv4_codes_pack_unpack_exact():
    x = _kv(0, T)[0].transpose(0, 2, 1, 3)  # [B, H, T, D]
    x[0, 0, 3] = 0.0  # an all-zero token: the 1e-8 scale floor
    jc, js = jkv.kv4_codes(jnp.asarray(x))
    tc, ts = tkv.kv4_codes(torch.from_numpy(x))
    _same((tc, ts), (jc, js))
    assert int(tc.min()) >= -7 and int(tc.max()) <= 7
    jp, tp = jkv.kv4_pack(jc), tkv.kv4_pack(tc)
    _same((tp,), (jp,))
    _same((tkv.kv4_unpack_codes(tp),), (jkv.kv4_unpack_codes(jp),))
    np.testing.assert_array_equal(tkv.kv4_unpack_codes(tp).numpy(), tc.numpy())
    _same(tkv.kv4_quantize(torch.from_numpy(x)), jkv.kv4_quantize(jnp.asarray(x)))
    np.testing.assert_allclose(
        tkv.kv4_dequantize(tp, ts, torch.float32).numpy(),
        np.asarray(jkv.kv4_dequantize(jp, js, jnp.float32)), rtol=0, atol=0)


def _caches(bits, seed=1):
    """A non-trivial starting cache, the same bytes on both sides."""
    class Cfg:
        num_layers, num_kv_heads, head_dim_ = L, H, D
    jc = jkv.init_quantized_kv_cache(Cfg, B, T, bits=bits)
    tc = tkv.init_quantized_kv_cache(Cfg, B, T, "cpu", bits=bits)
    _same([tc[k] for k in tkv.CACHE_KEYS], [jc[k] for k in tkv.CACHE_KEYS])
    rng = np.random.default_rng(seed)
    start = {}
    for k, v in jc.items():
        if k.endswith("_q"):
            start[k] = rng.integers(0, 256 if bits == 4 else 127, v.shape).astype(np.asarray(v).dtype)
        else:
            start[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    jc = {k: jnp.asarray(v) for k, v in start.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    return jc, tc


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("pos,s", [(0, 1), (5, 1), (6, 1), (0, 16), (3, 6), (4, 5), (1, 15), (9, 7)])
def test_cache_update_scalar_pos_exact(bits, pos, s):
    """Scalar pos, one token or a span, both nibble parities for int4: the
    per-layer and the layer-stacked writes."""
    jc, tc = _caches(bits)
    kv = _kv(pos * 31 + s, s)
    keys = tkv.CACHE_KEYS
    layer = 1
    jl = jkv.cache_update(tuple(jc[k][layer] for k in keys), jnp.asarray(kv[0]),
                          jnp.asarray(kv[1]), jnp.int32(pos))
    tl = tkv.cache_update(tkv.layer_view(tc, layer), torch.from_numpy(kv[0]),
                          torch.from_numpy(kv[1]), pos)
    _same(tl, jl)
    jc2, tc2 = _caches(bits)
    js = jkv.cache_update_stacked(tuple(jc2[k] for k in keys), layer, jnp.asarray(kv[0]),
                                  jnp.asarray(kv[1]), jnp.int32(pos))
    tkv.cache_update_stacked(tc2, layer, torch.from_numpy(kv[0]), torch.from_numpy(kv[1]), pos)
    _same(tuple(tc2[k] for k in keys), js)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("pos", [[0, 1, 2], [7, 7, 14], [15, 4, 9]])
def test_cache_update_vector_pos_exact(bits, pos):
    """Per-row positions (multi-slot decode, S == 1)."""
    jc, tc = _caches(bits, seed=2)
    kv = _kv(sum(pos), 1)
    keys = tkv.CACHE_KEYS
    p = np.asarray(pos, np.int32)
    jl = jkv.cache_update(tuple(jc[k][0] for k in keys), jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                          jnp.asarray(p))
    tl = tkv.cache_update(tkv.layer_view(tc, 0), torch.from_numpy(kv[0]),
                          torch.from_numpy(kv[1]), torch.from_numpy(p.astype(np.int64)))
    _same(tl, jl)
    jc2, tc2 = _caches(bits, seed=2)
    js = jkv.cache_update_stacked(tuple(jc2[k] for k in keys), 1, jnp.asarray(kv[0]),
                                  jnp.asarray(kv[1]), jnp.asarray(p))
    tkv.cache_update_stacked(tc2, 1, torch.from_numpy(kv[0]), torch.from_numpy(kv[1]),
                             torch.from_numpy(p.astype(np.int64)))
    _same(tuple(tc2[k] for k in keys), js)


@pytest.mark.parametrize("bits", [8, 4])
def test_cache_read_matches(bits):
    jc, tc = _caches(bits, seed=3)
    jl = jkv.cache_read(tuple(jc[k][1] for k in tkv.CACHE_KEYS), jnp.float32)
    tl = tkv.cache_read(tkv.layer_view(tc, 1), torch.float32)
    _same(tl, jl)


@pytest.mark.parametrize("pos,max_len,sink", [
    ([0, 5, 63], 64, 0), ([70, 3, 64], 64, 0), ([70, 130, 2], 64, 4), ([-1, 0, 17], 32, 3),
])
def test_ring_write_and_mask_vector_pos(pos, max_len, sink):
    p = np.asarray(pos, np.int32)
    jslot, jmask = JT._ring_write_and_mask(jnp.asarray(p), 1, max_len, sink)
    tslot, tmask = TT._ring_write_and_mask(torch.from_numpy(p.astype(np.int64)), 1, max_len,
                                           sink, "cpu")
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    assert tuple(tmask.shape) == (len(pos), 1, max_len)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_kernel_mask_keeps_each_row():
    """A per-row [B, 1, T] mask gives row b its own row, not the last one."""
    rng = np.random.default_rng(4)
    mask = np.where(rng.random((3, 1, 16)) < 0.5, -np.inf, 0.0).astype(np.float32)
    ref = np.asarray(JT._kernel_mask(jnp.asarray(mask), 3, 16))
    got = TT._kernel_mask(torch.from_numpy(mask), 3, 16).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got[0], got[2])
