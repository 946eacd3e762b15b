"""Port parity: fused dequant-matmul, kernels B1 (M <= 64) and B2 (M > 64).

The port's plain versions (what its wrapper runs on CPU tensors) against
the JAX Pallas kernels in interpret mode, `version=2` (B1) and `version=1`
(B2). Tolerance `atol = 1e-4 * max|ref|`: both sides share the same bf16
rounding points (x to bf16; B2's dequantized weight to bf16), so only the
fp32 summation order differs. The CUDA kernels are checked against the
same plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama3_quantization_tpu.ops.pallas_qmatmul import fused_dequant_matmul as j_fused
from llama3_quantization_tpu.quant import QuantSpec, quantize_rtn
from llama3_quantization_tpu_torch.convert import params_from_numpy
from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq
from llama3_quantization_tpu_torch.ops.matmul import qmatmul
from llama3_quantization_tpu_torch.quant.qtensor import dequantize

torch.set_num_threads(1)

K, N, GS = 256, 128, 64
WEIGHTS = {"w4_packed": (4, True), "w2_packed": (2, True), "w8_unpacked": (8, False)}


def _weights(kind):
    bits, pack = WEIGHTS[kind]
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jq = quantize_rtn(jnp.asarray(w), QuantSpec(n_bits=bits, group_size=GS), pack=pack)
    tree = {"data": np.asarray(jq.data), "scale": np.asarray(jq.scale),
            "zero": np.asarray(jq.zero), "bits": jq.bits, "group_size": jq.group_size,
            "k": jq.k, "n": jq.n, "packed": jq.packed, "sym": jq.sym}
    return jq, params_from_numpy({"w": tree}, device="cpu")["w"]


@pytest.mark.parametrize("kind", list(WEIGHTS))
@pytest.mark.parametrize("m", [1, 8, 64, 65, 128])
def test_plain_matches_pallas(kind, m):
    jq, tq = _weights(kind)
    x = np.random.default_rng(m).standard_normal((m, K)).astype(np.float32)
    version = 2 if m <= fq.GEMV_MAX_M else 1
    ref = np.asarray(j_fused(jnp.asarray(x), jq, out_dtype=jnp.float32, interpret=True,
                             version=version))
    # the wrapper routes a CPU tensor to B1's or B2's plain version by M
    got = fq.fused_dequant_matmul(torch.from_numpy(x), tq, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    plain = fq.qmm_gemv_plain if m <= fq.GEMV_MAX_M else fq.qmm_gemm_plain
    np.testing.assert_array_equal(plain(torch.from_numpy(x), tq, torch.float32).numpy(), got)


def test_qmatmul_routes_and_leading_shape():
    jq, tq = _weights("w4_packed")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, K)).astype(np.float32))
    y = qmatmul(x, tq)
    assert y.shape == (2, 3, N) and y.dtype == torch.float32
    ref = fq.qmm_gemv_plain(x.reshape(-1, K), tq, torch.float32).reshape(2, 3, N)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    # zero-free storage rides the dequant reference route
    sym = dataclasses.replace(tq, zero=None, data=torch.zeros((K // 2, N), dtype=torch.uint8))
    with pytest.raises(NotImplementedError):
        fq.fused_dequant_matmul(x, sym)
    torch.testing.assert_close(qmatmul(x.to(torch.bfloat16), sym),
                               x.to(torch.bfloat16) @ dequantize(sym))


@pytest.mark.parametrize("m", [1, 8, 65, 128])
def test_three_bit_planes_match_pallas_v1(m):
    """3-bit bit-plane weights `[3, K/8, N]` take B2 at every M, as the TPU
    wrapper sends them to v1 (`pallas_qmatmul.py:345-348`): B2's plain
    version against the v1 kernel in interpret mode."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jq = quantize_rtn(jnp.asarray(w), QuantSpec(n_bits=3, group_size=GS), pack=True)
    tree = {"data": np.asarray(jq.data), "scale": np.asarray(jq.scale),
            "zero": np.asarray(jq.zero), "bits": 3, "group_size": GS, "k": K, "n": N,
            "packed": True, "sym": jq.sym}
    tq = params_from_numpy({"w": tree}, device="cpu")["w"]
    assert tuple(tq.data.shape) == (3 * K // 8, N)
    x = np.random.default_rng(m).standard_normal((m, K)).astype(np.float32)
    ref = np.asarray(j_fused(jnp.asarray(x), jq, out_dtype=jnp.float32, interpret=True))
    got = fq.fused_dequant_matmul(torch.from_numpy(x), tq, out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_array_equal(fq.qmm_gemm_plain(torch.from_numpy(x), tq, torch.float32)
                                  .numpy(), got)
