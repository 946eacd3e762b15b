"""Port parity: packed storage, quantizer and QuantizedTensor.

The same numpy inputs go through the JAX package and the PyTorch port
(`llama3_quantization_tpu_torch`). Integer paths must match exactly:
packed bytes, RTN codes and scales, and the fp32 dequantization.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama3_quantization_tpu.quant import pack as jpack
from llama3_quantization_tpu.quant import qtensor as jqt
from llama3_quantization_tpu.quant.quantizer import QuantSpec as JSpec
from llama3_quantization_tpu.quant.quantizer import fake_quant as jfake_quant
from llama3_quantization_tpu.quant.quantizer import minmax_scale_zp as jminmax
from llama3_quantization_tpu_torch.quant import pack as tpack
from llama3_quantization_tpu_torch.quant import qtensor as tqt
from llama3_quantization_tpu_torch.quant.quantizer import QuantSpec as TSpec
from llama3_quantization_tpu_torch.quant.quantizer import fake_quant as tfake_quant
from llama3_quantization_tpu_torch.quant.quantizer import minmax_scale_zp as tminmax

torch.set_num_threads(1)


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_pack_subbyte_bytes_identical(bits, gs):
    rng = np.random.default_rng(1000 * bits + gs)
    k, n = 256, 24
    q = rng.integers(0, 2**bits, (k, n), dtype=np.uint8)
    ref = np.asarray(jpack.pack_subbyte(jnp.asarray(q), bits, gs))
    got = tpack.pack_subbyte(torch.from_numpy(q), bits, gs).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert got.shape[0] == tpack.packed_rows(k, bits)
    back = tpack.unpack_subbyte(torch.from_numpy(got), bits, k, gs).numpy()
    np.testing.assert_array_equal(back, q)


def test_adjacent_rows_do_not_share_a_byte():
    """Group-local layout: rows j and gs/2 + j share byte j, rows j, j+1 don't."""
    q = np.zeros((64, 1), np.uint8)
    q[0, 0], q[1, 0], q[32, 0] = 1, 2, 3
    packed = tpack.pack_subbyte(torch.from_numpy(q), 4, 64).numpy()
    assert packed[0, 0] == 1 | (3 << 4)
    assert packed[1, 0] == 2


SPECS = [
    (dict(n_bits=4, group_size=32), True),
    (dict(n_bits=4, group_size=64), False),
    (dict(n_bits=2, group_size=64), True),
    (dict(n_bits=3, group_size=32), True),
    (dict(n_bits=8, group_size=128), False),
    (dict(n_bits=8, group_size=None), True),
    (dict(n_bits=4, group_size=32, symmetric=True), True),
    (dict(n_bits=4, group_size=32, disable_zero_point=True), True),
    (dict(n_bits=8, group_size=64, disable_zero_point=True), False),
]


def _assert_qt_equal(jq, tq):
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    if jq.zero is None:
        assert tq.zero is None
    else:
        np.testing.assert_array_equal(tq.zero.numpy(), np.asarray(jq.zero))
    assert (tq.bits, tq.group_size, tq.sym, tq.k, tq.n, tq.packed) == (
        jq.bits, jq.group_size, jq.sym, jq.k, jq.n, jq.packed)


@pytest.mark.parametrize("spec,pack", SPECS)
def test_quantize_rtn_and_dequantize_exact(spec, pack):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((256, 48)).astype(np.float32)
    jq = jqt.quantize_rtn(jnp.asarray(w), JSpec(**spec), pack=pack)
    tq = tqt.quantize_rtn(torch.from_numpy(w), TSpec(**spec), pack=pack)
    _assert_qt_equal(jq, tq)
    np.testing.assert_array_equal(
        tqt.dequantize(tq, torch.float32).numpy(),
        np.asarray(jqt.dequantize(jq, jnp.float32)),
    )


@pytest.mark.parametrize("pack", [True, False])
def test_from_codes_with_g_idx_exact(pack):
    rng = np.random.default_rng(3)
    k, n, gs = 128, 16, 32
    codes = rng.integers(0, 16, (k, n), dtype=np.uint8)
    scale = rng.uniform(0.01, 0.1, (k // gs, n)).astype(np.float32)
    zero = rng.integers(0, 16, (k // gs, n)).astype(np.float32)
    g_idx = rng.permutation(np.arange(k) // gs).astype(np.int32)
    jspec, tspec = JSpec(n_bits=4, group_size=gs), TSpec(n_bits=4, group_size=gs)
    jq = jqt.from_codes(jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(zero), jspec,
                        pack=pack, g_idx=jnp.asarray(g_idx))
    tq = tqt.from_codes(torch.from_numpy(codes), torch.from_numpy(scale), torch.from_numpy(zero),
                        tspec, pack=pack, g_idx=torch.from_numpy(g_idx))
    _assert_qt_equal(jq, tq)
    np.testing.assert_array_equal(
        tqt.dequantize(tq, torch.float32).numpy(),
        np.asarray(jqt.dequantize(jq, jnp.float32)),
    )


@pytest.mark.parametrize("spec", [dict(n_bits=4, group_size=16), dict(n_bits=8),
                                  dict(n_bits=4, group_size=24, symmetric=True)])
def test_minmax_and_fake_quant_exact(spec):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 40)).astype(np.float32)
    js, ts = JSpec(**spec), TSpec(**spec)
    jscale, jzp = jminmax(jnp.asarray(x), js)
    tscale, tzp = tminmax(torch.from_numpy(x), ts)
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(tzp.numpy(), np.asarray(jzp))
    np.testing.assert_array_equal(
        tfake_quant(torch.from_numpy(x), tscale, tzp, ts).numpy(),
        np.asarray(jfake_quant(jnp.asarray(x), jscale, jzp, js)),
    )
