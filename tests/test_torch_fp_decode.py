"""Port parity: the fp KV cache and its flash decode, kernel B6.

- B6's plain version (what its wrapper runs on CPU tensors) against the
  JAX Pallas kernels `flash_decode_gqa` and `flash_decode_gqa_stacked` in
  interpret mode: B = 2, G = 2, rep in {1, 2, 4}, D = 32, T = 64 in one
  block and T = 128 in two blocks of 64 (the online merge), fp32 and bf16,
  row 1 fully masked. Tolerance: fp32 `max|got - ref| <= 1e-5 * max|ref|`
  (summation order); bf16 one bf16 ulp of max|ref| (p or the output may
  round the other way after an exp one ulp apart).
- `init_kv_cache`'s fp cache: JAX's shapes and dtypes (`cfg.dtype` by
  default, bf16 for TINY_LLAMA even with fp32 params).
- TINY_LLAMA with fp32 weights, and RTN W4 g32 packed (fp32 activations),
  on a bf16 and an fp32 cache against JAX on its kernel route (B6
  interpreted): a 4-token prefill then 8 teacher-forced `decode_step`s,
  `decode_step_multi` at staggered positions, and `greedy_generate`.
  Tokens identical. fp32 weights on the fp32 cache: logits and caches
  within rtol 1e-4, atol 1e-4 (JAX's own criterion, tests/test_kvcache.py:
  256-258). Otherwise within 1e-2 of their scale: a bf16 K/V or attention
  output one ulp apart, or, with W4 weights, an activation that B1/B2 round
  to the neighbouring bf16 value after an fp32 sum in another order (one
  such flip moves a K entry by 2.4e-3).
- A prefill or verify of S tokens that runs past `max_len`: JAX's
  `dynamic_update_slice` clamps the write to the last S slots and keeps its
  mask; the port's logits and caches (fp32, int8 and int4) equal JAX's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.ops.decode_attention import NEG as J_NEG
from llama3_quantization_tpu.ops.decode_attention import flash_decode_gqa as j_fd
from llama3_quantization_tpu.ops.decode_attention import flash_decode_gqa_stacked as j_fd_stacked
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.ops import decode_attention as da
from test_torch_model import jax_kernel_route, models, to_numpy_tree  # noqa: F401  (fixtures)

torch.set_num_threads(1)

CFG, TCFG = TINY_LLAMA, tcfg.TINY_LLAMA
B, G, D, L = 2, 2, 32, 2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rep, t, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, G * rep, D)).astype(np.float32)
    kv = rng.standard_normal((2, L, B, G, t, D)).astype(np.float32)
    mask = rng.uniform(-2.0, 0.0, (B, t)).astype(np.float32)
    mask[0, t - 11:] = J_NEG  # tail of row 0 masked (crosses a block edge at t = 128)
    mask[1, :] = J_NEG  # row 1 all masked: the mean of v
    return q, kv, mask


def _check(got, ref, dtype):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    scale = np.abs(ref).max()
    if dtype == "float32":
        tol = 1e-5 * scale
    else:
        tol = 2.0 ** (np.floor(np.log2(scale)) - 7)  # one bf16 ulp of max|ref|
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("t,block_t", [(64, 64), (128, 64)])
@pytest.mark.parametrize("rep", [1, 2, 4])
def test_plain_matches_pallas_stacked(rep, t, block_t, dtype):
    jdt, tdt = DTYPES[dtype]
    q, kv, mask = _inputs(rep, t, seed=rep * 10 + t)
    layer = 1
    ref = j_fd_stacked(jnp.asarray(q).astype(jdt), jnp.asarray(kv[0]).astype(jdt),
                       jnp.asarray(kv[1]).astype(jdt), jnp.asarray(mask), layer,
                       block_t=block_t, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, kv[0], kv[1]))
    got = da.flash_decode_gqa_stacked(tq, tk, tv, torch.from_numpy(mask), layer, block_t)
    assert got.shape == (B, 1, G * rep, D) and got.dtype == tdt
    _check(got, ref, dtype)
    # the all-masked row attends every slot alike: the mean of v
    mean_v = tv[layer, 1].float().mean(dim=1).repeat_interleave(rep, dim=0)
    np.testing.assert_allclose(got[1, 0].float().numpy(), mean_v.numpy(), rtol=0, atol=1e-2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("t,block_t", [(64, 64), (128, 64)])
def test_plain_matches_pallas_per_layer(t, block_t, dtype):
    jdt, tdt = DTYPES[dtype]
    q, kv, mask = _inputs(2, t, seed=t + 1)
    ref = j_fd(jnp.asarray(q).astype(jdt), jnp.asarray(kv[0, 0]).astype(jdt),
               jnp.asarray(kv[1, 0]).astype(jdt), jnp.asarray(mask), block_t=block_t,
               interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, kv[0, 0], kv[1, 0]))
    _check(da.flash_decode_gqa(tq, tk, tv, torch.from_numpy(mask), block_t), ref, dtype)


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_init_kv_cache_fp_matches_jax(dtype):
    jc = JT.init_kv_cache(CFG, 3, 48, dtype=None if dtype is None else jnp.float32)
    tc = TT.init_kv_cache(TCFG, 3, 48, dtype=None if dtype is None else torch.float32,
                          device="cpu")
    assert sorted(tc) == sorted(jc) == ["k", "v"]
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape
        assert str(tc[key].dtype).split(".")[-1] == jnp.dtype(jc[key].dtype).name
        assert not tc[key].any()
    assert TT.cache_len(tc) == 48


@pytest.fixture(scope="module")
def both_models(models):
    """{"fp32": fp32 weights, "w4": RTN W4 g32 packed}, each (JAX, port)."""
    params = init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return {"fp32": (params, convert.params_from_numpy(to_numpy_tree(params), device="cpu")),
            "w4": models}


def _close(got, ref, exact):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    if exact:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())


def _cache_check(tcache, jcache, exact):
    for key in ("k", "v"):
        _close(tcache[key].float().numpy(), jcache[key], exact)


def _caches(dtype, b, max_len=64):
    jdt, tdt = DTYPES[dtype]
    return (JT.init_kv_cache(CFG, b, max_len, dtype=jdt),
            TT.init_kv_cache(TCFG, b, max_len, dtype=tdt, device="cpu"))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("weights", ["fp32", "w4"])
def test_decode_steps_match_jax(both_models, jax_kernel_route, weights, dtype):
    """4-token prefill, then 8 teacher-forced single-token steps (stacked B6)."""
    jparams, tparams = both_models[weights]
    exact = weights == "fp32" and dtype == "float32"
    toks = np.random.default_rng(3).integers(0, CFG.vocab_size, (2, 12)).astype(np.int32)
    jstep = jax.jit(functools.partial(JT.decode_step, cfg=CFG))
    jcache, tcache = _caches(dtype, 2)
    jlg, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, :4]), jnp.int32(0))
    tlg, tcache = TT.decode_step(tparams, tcache, torch.from_numpy(toks[:, :4]).long(), 0, TCFG)
    _close(tlg.numpy(), jlg, exact)
    for i in range(4, 12):
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        tlg, tcache = TT.decode_step(tparams, tcache, torch.from_numpy(toks[:, i:i + 1]).long(),
                                     i, TCFG)
        _close(tlg.numpy(), jlg, exact)
        np.testing.assert_array_equal(tlg[:, -1].argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(jlg[:, -1], -1)))
    _cache_check(tcache, jcache, exact)


@pytest.mark.parametrize("weights,dtype", [("fp32", "float32"), ("w4", "bfloat16")])
def test_decode_step_multi_matches_jax(both_models, jax_kernel_route, weights, dtype):
    """Per-row positions (row 1 three tokens behind, as a shorter prompt
    in the engine): B6 on each layer view under its own `[B, T]` mask."""
    jparams, tparams = both_models[weights]
    exact = weights == "fp32"
    toks = np.random.default_rng(4).integers(0, CFG.vocab_size, (2, 6)).astype(np.int32)
    jmulti = jax.jit(functools.partial(JT.decode_step_multi, cfg=CFG))
    jcache, tcache = _caches(dtype, 2)
    _, jcache = JT.decode_step(jparams, jcache, jnp.asarray(toks), jnp.int32(0), CFG)
    _, tcache = TT.decode_step(tparams, tcache, torch.from_numpy(toks).long(), 0, TCFG)
    pos = np.array([6, 3], np.int32)
    jtok, ttok = jnp.asarray(toks[:, -1:]), torch.from_numpy(toks[:, -1:]).long()
    for _ in range(4):
        jlg, jcache = jmulti(jparams, jcache, jtok, jnp.asarray(pos))
        tlg, tcache = TT.decode_step_multi(tparams, tcache, ttok, torch.from_numpy(pos).long(),
                                           TCFG)
        _close(tlg.numpy(), jlg, exact)
        jtok = jnp.argmax(jlg[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = tlg[:, -1].argmax(-1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        pos = pos + 1
    _cache_check(tcache, jcache, exact)


@pytest.mark.parametrize("weights,dtype", [("fp32", "float32"), ("w4", "bfloat16")])
def test_greedy_generate_matches_jax(both_models, jax_kernel_route, weights, dtype):
    jparams, tparams = both_models[weights]
    prompt = np.random.default_rng(5).integers(0, CFG.vocab_size, (2, 10)).astype(np.int32)
    jcache, tcache = _caches(dtype, 2)
    jlg, jcache = JT.decode_step(jparams, jcache, jnp.asarray(prompt), jnp.int32(0), CFG)
    jfirst = jnp.argmax(jlg[:, -1], axis=-1).astype(jnp.int32)[:, None]
    jtoks, jcache = JT.greedy_generate(jparams, jcache, jfirst, jnp.int32(10), 8, CFG)
    tlg, tcache = TT.decode_step(tparams, tcache, torch.from_numpy(prompt).long(), 0, TCFG)
    tfirst = tlg[:, -1].argmax(dim=-1)[:, None]
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    ttoks, tcache = TT.greedy_generate(tparams, tcache, tfirst, 10, 8, TCFG)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    _cache_check(tcache, jcache, weights == "fp32")


def test_write_cache_in_place():
    """`_write_cache_stacked` writes the token slots of one layer in place,
    cast to the cache dtype: a span at a scalar position, or one slot per
    row."""
    buf = torch.zeros((2, 3, 2, 8, 4), dtype=torch.bfloat16)
    new = torch.randn((3, 2, 2, 4))  # [B, S, H, D]
    TT._write_cache_stacked(buf, new, 1, 5)
    torch.testing.assert_close(buf[1, :, :, 5:7], new.transpose(1, 2).to(torch.bfloat16))
    assert not buf[0].any() and not buf[1, :, :, :5].any()
    pos = torch.tensor([0, 7, 3])
    TT._write_cache_stacked(buf, new[:, :1], 0, pos)
    for row, p in enumerate(pos.tolist()):
        torch.testing.assert_close(buf[0, row, :, p], new[row, 0].to(torch.bfloat16))
    assert int((buf[0] != 0).any(dim=-1).sum()) == 3 * 2


@pytest.mark.parametrize("pos,s", [(28, 6), (31, 5), (27, 8)])
@pytest.mark.parametrize("kind", ["float32", 8, 4])
def test_prefill_past_max_len_matches_jax(both_models, kind, pos, s):
    """`decode_step` of S tokens at `pos` with pos + S > max_len (32) after
    a 20-token prefill, fp32 weights. fp32 cache: logits and cache within
    1e-4. int8 / int4 caches: codes at most one step apart (an fp32 ulp of K
    or V at a rounding tie moves a code; later layers then differ by a code
    step, ~1e-3 of the logits), scales within 1e-3, logits within 1e-2 of
    their scale, argmax identical."""
    from llama3_quantization_tpu_torch.ops.kvcache import kv4_unpack_codes

    jparams, tparams = both_models["fp32"]
    toks = np.random.default_rng(pos + s).integers(0, CFG.vocab_size, (2, 20 + s))
    toks = toks.astype(np.int32)
    if kind == "float32":
        jcache, tcache = _caches("float32", 2, max_len=32)
    else:
        jcache = JT.init_kv_cache(CFG, 2, 32, quantized=kind)
        tcache = TT.init_kv_cache(TCFG, 2, 32, quantized=kind, device="cpu")
    _, jcache = JT.decode_step(jparams, jcache, jnp.asarray(toks[:, :20]), jnp.int32(0), CFG)
    _, tcache = TT.decode_step(tparams, tcache, torch.from_numpy(toks[:, :20]).long(), 0, TCFG)
    jlg, jcache = JT.decode_step(jparams, jcache, jnp.asarray(toks[:, 20:]), jnp.int32(pos), CFG)
    tlg, tcache = TT.decode_step(tparams, tcache, torch.from_numpy(toks[:, 20:]).long(), pos,
                                 TCFG)
    exact = kind == "float32"
    _close(tlg.numpy(), jlg, exact)
    np.testing.assert_array_equal(tlg.argmax(-1).numpy(), np.asarray(jnp.argmax(jlg, -1)))
    for key in jcache:
        got, ref = tcache[key], torch.from_numpy(np.array(jcache[key]))
        if key in ("k", "v"):
            _close(got.numpy(), ref.numpy(), True)
        elif key in ("k_s", "v_s"):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-3, atol=0)
        else:
            if kind == 4:
                got, ref = kv4_unpack_codes(got), kv4_unpack_codes(ref)
            assert int((got.int() - ref.int()).abs().max()) <= 1, key
