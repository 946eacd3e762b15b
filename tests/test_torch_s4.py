"""Port parity: the s4 backend (`ops/s4_matmul.py`, kernel B3's plain version).

The same inputs, made from numpy seeds, go through the JAX package and the
port on the CPU:

- `s4_matmul` / `s4w_matmul` on `tests/test_s4.py`'s grid of bits, group
  size, packing and batch, and its symmetric cases, within 5e-6 of max|ref|
  in fp32 (the integers are exact; JAX sums the groups through an einsum,
  the port in order);
- `prepare_s4`: the signed 4-bit codes and the centered int8 `zero8` equal
  JAX's, and a stacked weight's `.layer(i)` views them without a copy;
- the backend switch: `s4` routes codes up to 4 bits to `s4_matmul` and
  8-bit containers to `a8_matmul`; `prepare_decode_params` converts once;
- TINY_LLAMA `greedy_generate` under `s4` with `fuse_for_decode` (int8
  cache, the JAX decode kernel interpreted): identical tokens to JAX under
  `s4`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA, init_params, quantize_model_rtn
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.ops import matmul as jmm
from llama3_quantization_tpu.ops import s4_matmul as js4
from llama3_quantization_tpu.quant import QuantSpec
from llama3_quantization_tpu.quant import serving as jserv
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.ops import matmul as tmm
from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa
from llama3_quantization_tpu_torch.ops import s4_matmul as ts4
from llama3_quantization_tpu_torch.ops.a8_matmul import a8_matmul
from llama3_quantization_tpu_torch.quant import serving as tserv
from llama3_quantization_tpu_torch.quant.qtensor import QuantizedTensor
from test_torch_a8 import _jqt, assert_rel, carry
from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

K, N = 128, 96


def _x(b, k=K, seed=1):
    return np.random.default_rng(seed).normal(size=(b, k)).astype(np.float32)


@pytest.mark.parametrize(
    "bits,gs,pack,b",
    [(4, 32, True, 1), (4, 32, False, 1), (4, 32, True, 4), (4, 32, True, 64),
     (4, None, True, 1), (3, 32, True, 1), (2, 32, True, 2), (4, 32, True, 70)],
)
def test_s4_matmul_matches_jax(bits, gs, pack, b):
    jq = _jqt(bits, gs, pack)
    x = _x(b)
    ref = js4.s4_matmul(jnp.asarray(x), jq, out_dtype=jnp.float32)
    got = ts4.s4_matmul(torch.from_numpy(x), carry(jq), out_dtype=torch.float32)
    assert_rel(got.numpy(), ref)


@pytest.mark.parametrize("sym,no_zp", [(True, False), (False, True)])
def test_s4_symmetric_matches_jax(sym, no_zp):
    jq = _jqt(4, 32, False, sym=sym, no_zp=no_zp, n=64)
    assert (jq.zero is None) == no_zp
    x = _x(1, seed=2)
    ref = js4.s4_matmul(jnp.asarray(x), jq, out_dtype=jnp.float32)
    got = ts4.s4_matmul(torch.from_numpy(x), carry(jq), out_dtype=torch.float32)
    assert_rel(got.numpy(), ref)


@pytest.mark.parametrize("bits,gs,pack", [(4, 32, True), (3, 32, True), (2, 32, True),
                                          (4, 32, False), (4, None, False)])
def test_prepare_s4_codes_and_zero8(bits, gs, pack):
    jq = _jqt(bits, gs, pack, seed=bits)
    jw = js4.prepare_s4(jq)
    tw = ts4.prepare_s4(carry(jq))
    assert tw.data4.dtype == torch.uint8 and tuple(tw.data4.shape) == (K // 2, N)
    codes = qa.codes_of(tw.data4, "s4", K, gs or K)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jw.data4.astype(jnp.int8)))
    np.testing.assert_array_equal(tw.zero8.numpy(), np.asarray(jw.zero8))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))


def test_s4_rejects_wide_codes_and_keeps_leading_shape():
    with pytest.raises(ValueError):
        ts4.s4_matmul(torch.ones((1, 64)), carry(_jqt(8, 32, False, k=64, n=32)))
    y = ts4.s4_matmul(torch.from_numpy(_x(6, 64)).reshape(2, 3, 64),
                      carry(_jqt(4, 32, True, k=64, n=48)))
    assert y.shape == (2, 3, 48)


def test_stacked_weight_layer_views():
    """`prepare_s4` on a layer-stacked tensor; `.layer(i)` is a view that
    equals preparing layer i alone."""
    qts = [carry(_jqt(4, 32, True, seed=s)) for s in (0, 1, 2)]
    stacked = QuantizedTensor(
        data=torch.stack([q.data for q in qts]), scale=torch.stack([q.scale for q in qts]),
        zero=torch.stack([q.zero for q in qts]), bits=4, group_size=32, k=K, n=N, packed=True)
    w = ts4.prepare_s4(stacked)
    one = w.layer(1)
    assert one.data4.data_ptr() == w.data4[1].data_ptr()
    alone = ts4.prepare_s4(qts[1])
    np.testing.assert_array_equal(one.data4.numpy(), alone.data4.numpy())
    np.testing.assert_array_equal(one.zero8.numpy(), alone.zero8.numpy())


def test_backend_dispatch():
    """s4 routes 4-bit tensors to the s4 path and 8-bit per-column tensors
    (the s8 head recode) to the a8 dot; S4Weights always take `s4w_matmul`."""
    qt4 = carry(_jqt(4, 32, True, k=64, n=48))
    w_head = np.random.default_rng(4).normal(size=(64, 32)).astype(np.float32)
    qt8 = tserv.recode_head_s8(torch.from_numpy(w_head))
    x = torch.from_numpy(_x(1, 64, seed=5))
    with tmm.backend("s4"):
        y4 = tmm.qmatmul(x, qt4, out_dtype=torch.float32)
        y8 = tmm.qmatmul(x, qt8, out_dtype=torch.float32)
        prepared = tmm.prepare_decode_params({"a": {"w": qt4}, "h": qt8})
    np.testing.assert_array_equal(y4.numpy(), ts4.s4_matmul(x, qt4, torch.float32).numpy())
    np.testing.assert_array_equal(y8.numpy(), a8_matmul(x, qt8, torch.float32).numpy())
    assert isinstance(prepared["a"]["w"], ts4.S4Weight) and prepared["h"] is qt8
    with tmm.backend("pallas"):
        np.testing.assert_array_equal(tmm.qmatmul(x, prepared["a"]["w"], torch.float32).numpy(),
                                      y4.numpy())
        assert tmm.prepare_decode_params(prepared) is prepared
    jref = js4.s4_matmul(jnp.asarray(x.numpy()), _jqt(4, 32, True, k=64, n=48),
                         out_dtype=jnp.float32)
    assert_rel(y4.numpy(), jref)


@pytest.fixture
def jax_s4_route():
    """JAX under the s4 backend, its decode kernel interpreted on the CPU."""
    JT.set_decode_kernel("interpret")
    try:
        with jmm.backend("s4"):
            yield
    finally:
        JT.set_decode_kernel("auto")


@pytest.mark.big_compile
def test_fused_greedy_generate_s4_matches_jax(jax_s4_route):
    """TINY_LLAMA W4 g32 packed with an s4 head recode, fused: a 16-token
    prefill then 8 greedy steps on the int8 cache, identical tokens."""
    params = init_params(TINY_LLAMA, jax.random.PRNGKey(0), dtype=jnp.float32)
    jp = quantize_model_rtn(params, TINY_LLAMA, QuantSpec(n_bits=4, group_size=32), pack=True)
    jp = {**jp, "lm_head": jserv.recode_head_s4(jp["lm_head"])}
    tp = convert.params_from_numpy(to_numpy_tree(jp), device="cpu")
    jp = jserv.fuse_for_decode(jp, TINY_LLAMA)
    tp = tserv.fuse_for_decode(tp, tcfg.TINY_LLAMA)
    b, s, n_steps = 2, 16, 8
    prompt = np.random.default_rng(42).integers(0, TINY_LLAMA.vocab_size, (b, s)).astype(np.int32)

    jcache = JT.init_kv_cache(TINY_LLAMA, b, 64, quantized=8)
    jlogits, jcache = JT.decode_step(jp, jcache, jnp.asarray(prompt), jnp.int32(0), TINY_LLAMA)
    jfirst = jnp.argmax(jlogits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    jtoks, _ = JT.greedy_generate(jp, jcache, jfirst, jnp.int32(s), n_steps, TINY_LLAMA)

    with tmm.backend("s4"):
        tcache = TT.init_kv_cache(tcfg.TINY_LLAMA, b, 64, quantized=8, device="cpu")
        tlogits, tcache = TT.decode_step(tp, tcache, torch.from_numpy(prompt), 0, tcfg.TINY_LLAMA)
        assert_rel(tlogits.numpy(), jlogits, 1e-4)
        tfirst = tlogits[:, -1].argmax(dim=-1)[:, None]
        np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
        ttoks, _ = TT.greedy_generate(tp, tcache, tfirst, s, n_steps, tcfg.TINY_LLAMA)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert len(set(ttoks.flatten().tolist())) > 2
