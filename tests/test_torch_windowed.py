"""Port parity: the window write-combined decode (`models/windowed.py`).

- `merge_window_into_cache` writes the same bytes as the JAX merge (its
  bounded-scratch piece merge, or the gather merge for odd-sink int4) for
  int8 and int4 caches, sink 0, 2 and 3, scalar and per-row positions, and
  windows that wrap the ring.
- B5 with stats merged with the exact window attention equals eager
  attention over the dequantized main and window keys (op check).
- `decode_window` (kv 8 and 4, per-row pos0) and `greedy_generate` on the
  int4 cache, including the ring-crossing gate of tests/test_windowed.py,
  give the JAX package's tokens on TINY_LLAMA W4 g32 packed, JAX on its
  kernel route (`jax_kernel_route` of tests/test_torch_model.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.models import windowed as JW
from llama3_quantization_tpu.ops import kvcache as jkv
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.models import windowed as TW
from llama3_quantization_tpu_torch.ops import decode_attention as da
from llama3_quantization_tpu_torch.ops import kvcache as tkv
from test_torch_model import jax_kernel_route, models  # noqa: F401  (fixtures)

torch.set_num_threads(1)

CFG = TINY_LLAMA
TCFG = tcfg.TINY_LLAMA


def _merge_inputs(packed, seed):
    L, B, H, T, D, KW = 2, 3, 2, 16, 4, 5
    rng = np.random.default_rng(seed)
    codes = rng.integers(-7, 8, (L, B, H, T, D)).astype(np.int8)
    cache = {
        "k_q": codes, "v_q": codes[:, ::-1].copy(),
        "k_s": rng.normal(size=(L, B, H, T, 1)).astype(np.float32),
        "v_s": rng.normal(size=(L, B, H, T, 1)).astype(np.float32),
    }
    if packed:
        cache["k_q"] = np.asarray(jkv.kv4_pack(jnp.asarray(cache["k_q"])))
        cache["v_q"] = np.asarray(jkv.kv4_pack(jnp.asarray(cache["v_q"])))
    win = (
        rng.integers(-7, 8, (L, B, H, KW, D)).astype(np.int8),
        rng.normal(size=(L, B, H, KW, 1)).astype(np.float32),
        rng.integers(-7, 8, (L, B, H, KW, D)).astype(np.int8),
        rng.normal(size=(L, B, H, KW, 1)).astype(np.float32),
    )
    return cache, win


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("sink", [0, 2, 3])
@pytest.mark.parametrize("pos0", [0, 7, 13, 29, [0, 2, 3], [3, 12, 14], [11, 20, 33]])
def test_merge_window_bit_identical(packed, sink, pos0):
    cache, win = _merge_inputs(packed, seed=sink * 7 + (pos0 if isinstance(pos0, int) else sum(pos0)))
    jp0 = jnp.asarray(np.asarray(pos0, np.int32))
    ref = JW.merge_window_into_cache({k: jnp.asarray(v) for k, v in cache.items()},
                                     tuple(jnp.asarray(w) for w in win), jp0, CFG, sink)
    tp0 = pos0 if isinstance(pos0, int) else torch.tensor(pos0)
    got = TW.merge_window_into_cache({k: torch.from_numpy(v.copy()) for k, v in cache.items()},
                                     tuple(torch.from_numpy(w) for w in win), tp0, TCFG, sink)
    for k in tkv.CACHE_KEYS:
        assert got[k].numpy().dtype == np.asarray(ref[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_merge_rejects_a_window_as_wide_as_the_ring():
    cache, win = _merge_inputs(False, 0)
    with pytest.raises(ValueError):
        TW.merge_window_into_cache({k: torch.from_numpy(v) for k, v in cache.items()},
                                   tuple(torch.from_numpy(w) for w in win), 0, TCFG, sink=11)


@pytest.mark.parametrize("int4", [False, True])
def test_window_merge_op_matches_eager(int4):
    """B5 with stats over the main cache (frozen mask) merged with the exact
    window attention equals one eager softmax over the dequantized main and
    window keys together; the s8 quantization of q and probabilities in the
    kernel segment is the only difference (2e-2 of max|out|)."""
    rng = np.random.default_rng(5 + int4)
    B, G, REP, D, T, KW, pos0 = 2, 2, 2, 16, 64, 6, 40
    quantize = tkv.kv4_quantize if int4 else tkv.kv_quantize
    codes = tkv.kv4_codes if int4 else tkv.kv_quantize
    kq, ks = quantize(torch.from_numpy(rng.standard_normal((B, G, T, D)).astype(np.float32)))
    vq, vs = quantize(torch.from_numpy(rng.standard_normal((B, G, T, D)).astype(np.float32)))
    wk, wks = codes(torch.from_numpy(rng.standard_normal((B, G, KW, D)).astype(np.float32)))
    wv, wvs = codes(torch.from_numpy(rng.standard_normal((B, G, KW, D)).astype(np.float32)))
    q = torch.from_numpy(rng.standard_normal((B, 1, G * REP, D)).astype(np.float32))
    mask = torch.where(torch.arange(T) < pos0, 0.0, da.NEG).expand(B, T).contiguous()
    o1, m1, l1 = da.flash_decode_gqa_s8(q, kq, ks, vq, vs, mask, torch.float32, 32, True)
    qg = q.reshape(B, G, REP, D)
    o2, m2, l2 = TW._window_attn(qg, wk, wks, wv, wvs, torch.zeros(1, 1, 1, KW))
    got = TW._merge_attn(o1.reshape(B, G, REP, D), m1, l1, o2, m2, l2)
    k_all, v_all = tkv.cache_read((kq, ks, vq, vs), torch.float32)
    keys = torch.cat([k_all[:, :, :pos0], wk.float() * wks], dim=2)
    vals = torch.cat([v_all[:, :, :pos0], wv.float() * wvs], dim=2)
    p = torch.softmax(torch.einsum("bgrd,bgjd->bgrj", qg, keys) / D**0.5, dim=-1)
    ref = torch.einsum("bgrj,bgjd->bgrd", p, vals)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-2 * float(ref.abs().max()))


def _prefill(jparams, tparams, bits, toks, t):
    jc = JT.init_kv_cache(CFG, toks.shape[0], t, quantized=bits)
    jlg, jc = JT.decode_step(jparams, jc, jnp.asarray(toks), jnp.int32(0), CFG)
    tc = TT.init_kv_cache(TCFG, toks.shape[0], t, quantized=bits, device="cpu")
    tlg, tc = TT.decode_step(tparams, tc, torch.from_numpy(toks.astype(np.int64)), 0, TCFG)
    jtok = jnp.argmax(jlg[:, -1:, :], axis=-1).astype(jnp.int32)
    ttok = tlg[:, -1:, :].argmax(dim=-1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    return jc, jtok, tc, ttok


# the interpret-mode scans compile large CPU programs (see tests/test_windowed.py)
@pytest.mark.big_compile
@pytest.mark.parametrize("bits", [8, 4])
def test_decode_window_tokens_match_jax(models, jax_kernel_route, bits):
    """Per-row pos0 (the engine's shape): rows 8 and 6 of a 32-slot ring."""
    jparams, tparams = models
    toks = np.random.default_rng(bits).integers(0, CFG.vocab_size, (2, 8)).astype(np.int32)
    jc, jtok, tc, ttok = _prefill(jparams, tparams, bits, toks, 32)
    pos0 = np.asarray([8, 6], np.int32)
    jt, jc = JW.decode_window(jparams, jc, jtok, jnp.asarray(pos0), 6, CFG)
    tt, tc = TW.decode_window(tparams, tc, ttok, torch.from_numpy(pos0.astype(np.int64)), 6, TCFG)
    assert tt.shape == (2, 6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for k in ("k_s", "v_s"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-4, atol=1e-6)


@pytest.mark.big_compile
def test_greedy_generate_int4_gates_ring_crossing(models, jax_kernel_route):
    """tests/test_windowed.py:320 on both sides: four 4-token greedy
    dispatches on a 16-slot int4 ring from pos 8; the ones at pos 16 and 20
    cross the ring and run per step. Same tokens as JAX."""
    jparams, tparams = models
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (1, 8), 0, CFG.vocab_size))
    jc, jtok, tc, ttok = _prefill(jparams, tparams, 4, toks, 16)
    assert TW.windowed_ok(TCFG, tc, sink_tokens=0)
    ref_cache = {k: v.clone() for k, v in tc.items()}
    jseq, tseq = [], []
    for wi in range(4):
        jw, jc = JT.greedy_generate(jparams, jc, jtok, jnp.int32(8 + 4 * wi), 4, CFG)
        tw, tc = TT.greedy_generate(tparams, tc, ttok, 8 + 4 * wi, 4, TCFG)
        jseq.extend(np.asarray(jw)[0].tolist())
        tseq.extend(tw[0].tolist())
        jtok, ttok = jw[:, -1:].astype(jnp.int32), tw[:, -1:]
    assert tseq == jseq
