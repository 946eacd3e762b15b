"""Port parity: the a8 backend, the v3 route, the serving recodes and fusion.

The same inputs, made from numpy seeds, go through the JAX package and the
port (CPU, where B3's wrapper runs its plain version):

- `quantize_activations_s8` bit-equal; the s32 group dots and activation
  sums exact against JAX's integer `dot_general`;
- `a8_matmul` (per-column `g == 1` and grouped, with and without a zero
  point) and `fused_dequant_matmul(version=3)` (JAX's v3 kernel in
  interpret mode) within 5e-6 of max|ref| in fp32 (`tests/test_s4.py`'s
  oracle bound: the integers are exact, only the fp32 order of the sum over
  groups differs);
- unpacked uint8 8-bit codes (`quantize_rtn(bits=8, pack=True)`) under
  v3 (codes cast to int8, wrapping above 127, as JAX's kernel casts them),
  a8 (the promoted dot, exact in s32) and the s4 backend (which sends such
  weights to a8; `prepare_s4` refuses them on both sides), within the same
  5e-6, and exactly equal for per-column weights;
- `recode_s8_percol`, `recode_head_s8`, `recode_head_s4`: codes
  byte-identical, scales equal; `fuse_for_decode`: the same keys and
  concatenated tensors; `params_from_numpy` on `percol_s8` trees;
- `ServingEngine(fuse=True)` under the a8 backend on an int8 cache, on
  RTN weights recoded per column (head included): identical streams to the
  JAX engine under a8 with its interpreted decode kernel.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA
from llama3_quantization_tpu.models import synthetic as jsyn
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.ops import a8_matmul as ja8
from llama3_quantization_tpu.ops import matmul as jmm
from llama3_quantization_tpu.ops import pallas_qmatmul as jpq
from llama3_quantization_tpu.quant import QuantSpec
from llama3_quantization_tpu.quant import quantize_rtn as j_quantize_rtn
from llama3_quantization_tpu.quant import serving as jserv
from llama3_quantization_tpu.quant.pack import unpack_subbyte as j_unpack
from llama3_quantization_tpu.serving import ServingEngine as JEngine
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.ops import fused_qmatmul as tfq
from llama3_quantization_tpu_torch.ops import matmul as tmm
from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa
from llama3_quantization_tpu_torch.ops.a8_matmul import a8_matmul
from llama3_quantization_tpu_torch.quant import serving as tserv
from llama3_quantization_tpu_torch.serving import ServingEngine as TEngine
from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

K, N = 128, 96
REL = 5e-6


def carry(jqt):
    """One JAX QuantizedTensor into the port, through `params_from_numpy`."""
    return convert.params_from_numpy({"w": to_numpy_tree(jqt)}, device="cpu")["w"]


def _jqt(bits, gs, pack, seed=0, sym=False, no_zp=False, k=K, n=N):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.05
    spec = QuantSpec(n_bits=bits, group_size=gs, symmetric=sym, disable_zero_point=no_zp)
    return j_quantize_rtn(jnp.asarray(w), spec, pack=pack)


def _x(m, k=K, seed=1):
    return np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32)


def assert_rel(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30)
    assert err < rel, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_bit_equal(dtype):
    x = _x(5, 64, seed=3) * np.linspace(0.1, 30.0, 64, dtype=np.float32)
    x[0, :4] = [127.0, 63.5, -0.5, 1.5]  # rounding ties
    jx = jnp.asarray(x).astype(dtype)
    jq, js = ja8.quantize_activations_s8(jx)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    tq, ts = qa.quantize_activations_s8(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bits,gs,pack", [(4, 32, True), (2, 32, True), (8, 32, False),
                                          (4, None, False)])
def test_group_partials_exact(bits, gs, pack):
    """s32 group dots and sums equal JAX's integer dot_general."""
    jq = _jqt(bits, gs, pack)
    xq, _ = ja8.quantize_activations_s8(jnp.asarray(_x(3)))
    g = gs or K
    codes = j_unpack(jq.data, bits, K, gs) if pack else jq.data
    jparts = jax.lax.dot_general(
        xq.reshape(3, K // g, g), codes.astype(jnp.int8).reshape(K // g, g, N),
        (((2,), (1,)), ((1,), (0,))), preferred_element_type=jnp.int32)
    jsum = jnp.sum(xq.reshape(3, K // g, g).astype(jnp.int32), axis=2)
    tq = carry(jq)
    tcodes = qa.codes_of(tq.data, {4: "u4", 2: "u2"}[bits] if pack else "s8", K, g)
    dots, xsum = qa.group_partials(torch.from_numpy(np.asarray(xq)), tcodes, g)
    np.testing.assert_array_equal(dots.numpy().astype(np.int64), np.asarray(jparts, np.int64))
    np.testing.assert_array_equal(xsum.numpy().astype(np.int64), np.asarray(jsum, np.int64))


@pytest.mark.parametrize("m", [1, 4, 70])
@pytest.mark.parametrize("bits,gs,zp", [(4, 32, "asym"), (8, 32, "asym"), (4, None, "asym"),
                                        (8, 32, "none"), (8, None, "percol")])
def test_a8_matmul_matches_jax(bits, gs, zp, m):
    jq = _jqt(bits, gs, pack=False, no_zp=zp == "none")
    if zp == "percol":
        jq = jserv.recode_s8_percol(jq)
    assert (jq.zero is None) == (zp != "asym")
    x = _x(m)
    ref = ja8.a8_matmul(jnp.asarray(x), jq, out_dtype=jnp.float32)
    got = a8_matmul(torch.from_numpy(x), carry(jq), out_dtype=torch.float32)
    assert_rel(got.numpy(), ref)
    if zp == "percol":  # g == 1: the same fp32 operations in the same order
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _jqt_u8(gs, seed=0):
    """`quantize_rtn(bits=8, pack=True)`: unpacked uint8 codes, fp32 zero."""
    jq = _jqt(8, gs, pack=True, seed=seed)
    assert jq.data.dtype == jnp.uint8 and not jq.packed and int(jq.data.max()) > 127
    return jq


@pytest.mark.parametrize("route", ["v3", "a8"])
def test_uint8_codes_partials_exact(route):
    """B3's s32 group partials on unpacked uint8 codes equal JAX's integer
    dots: a8's `dot_general` promotes the codes, v3 casts them to int8."""
    jq = _jqt_u8(32)
    xq, _ = ja8.quantize_activations_s8(jnp.asarray(_x(3)))
    codes = jq.data.astype(jnp.int8) if route == "v3" else jq.data
    jparts = jax.lax.dot_general(
        xq.reshape(3, K // 32, 32), codes.reshape(K // 32, 32, N),
        (((2,), (1,)), ((1,), (0,))), preferred_element_type=jnp.int32)
    tdata = carry(jq).data
    tcodes = qa.codes_of(tdata.view(torch.int8) if route == "v3" else tdata,
                         "s8" if route == "v3" else "u8", K, 32)
    dots, _ = qa.group_partials(torch.from_numpy(np.asarray(xq)), tcodes, 32)
    np.testing.assert_array_equal(dots.numpy().astype(np.int64), np.asarray(jparts, np.int64))


@pytest.mark.parametrize("m", [1, 4, 70])
@pytest.mark.parametrize("gs", [32, None])
@pytest.mark.parametrize("route", ["v3", "a8", "s4"])
def test_uint8_codes_match_jax(route, gs, m):
    """v3, a8 and the s4 backend on `quantize_rtn(bits=8, pack=True)` codes."""
    jq = _jqt_u8(gs, seed=m)
    tq = carry(jq)
    assert tq.data.dtype == torch.uint8
    x = _x(m)
    if route == "v3":
        ref = jpq.fused_dequant_matmul(jnp.asarray(x), jq, out_dtype=jnp.float32,
                                       interpret=True, version=3)
        got = tfq.fused_dequant_matmul(torch.from_numpy(x), tq, out_dtype=torch.float32,
                                       version=3)
    elif route == "a8":
        ref = ja8.a8_matmul(jnp.asarray(x), jq, out_dtype=jnp.float32)
        got = a8_matmul(torch.from_numpy(x), tq, out_dtype=torch.float32)
    else:
        with jmm.backend("s4"):
            ref = jmm.qmatmul(jnp.asarray(x), jq, out_dtype=jnp.float32)
        with tmm.backend("s4"):
            got = tmm.qmatmul(torch.from_numpy(x), tq, out_dtype=torch.float32)
    assert_rel(got.numpy(), ref)
    if route != "v3" and gs is None:  # g == 1: the same fp32 operations in the same order
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_s4_prepare_refuses_8_bit_codes():
    from llama3_quantization_tpu.ops import s4_matmul as js4
    from llama3_quantization_tpu_torch.ops import s4_matmul as ts4

    jq = _jqt_u8(32)
    with pytest.raises(ValueError):
        js4.prepare_s4(jq)
    with pytest.raises(ValueError):
        ts4.prepare_s4(carry(jq))


def test_a8_rejects_packed_and_keeps_leading_shape():
    tq = carry(_jqt(4, 32, pack=True))
    with pytest.raises(ValueError):
        a8_matmul(torch.ones((2, K)), tq)
    tq8 = carry(_jqt(8, 32, pack=False))
    y = a8_matmul(torch.from_numpy(_x(6)).reshape(2, 3, K), tq8)
    assert y.shape == (2, 3, N) and y.dtype == torch.float32


@pytest.mark.parametrize("m", [1, 8, 65])
@pytest.mark.parametrize("bits,pack", [(4, True), (2, True), (8, False), (4, False)])
def test_v3_matches_jax_interpret(bits, pack, m):
    """`fused_dequant_matmul(version=3)` against JAX's `_qmm_v3_kernel`."""
    jq = _jqt(bits, 32, pack)
    x = _x(m)
    ref = jpq.fused_dequant_matmul(jnp.asarray(x), jq, out_dtype=jnp.float32, interpret=True,
                                   version=3)
    got = tfq.fused_dequant_matmul(torch.from_numpy(x), carry(jq), out_dtype=torch.float32,
                                   version=3)
    assert_rel(got.numpy(), ref)


@pytest.mark.parametrize("env,fn", [("3", "v3"), ("1", "b2"), ("2", "b1")])
def test_qmm_version_env(monkeypatch, env, fn):
    """`L3Q_QMM_V` picks the kernel at version 0, as in JAX (`:399-403`)."""
    tq = carry(_jqt(4, 32, True))
    x = torch.from_numpy(_x(4))
    monkeypatch.setenv("L3Q_QMM_V", env)
    got = tfq.fused_dequant_matmul(x, tq, out_dtype=torch.float32)
    want = {"v3": lambda: tfq.fused_dequant_matmul(x, tq, torch.float32, version=3),
            "b2": lambda: tfq.qmm_gemm_plain(x, tq, torch.float32),
            "b1": lambda: tfq.qmm_gemv_plain(x, tq, torch.float32)}[fn]()
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("bits,gs,pack", [(4, 32, True), (2, 32, True), (4, 32, False),
                                          (8, None, False)])
def test_recode_s8_percol_byte_identical(bits, gs, pack):
    jq = _jqt(bits, gs, pack, seed=bits)
    ref = jserv.recode_s8_percol(jq)
    got = tserv.recode_s8_percol(carry(jq))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert got.zero is None and got.bits == 8 and got.group_size is None and not got.packed


@pytest.mark.parametrize("which", ["s8", "s4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recode_head_byte_identical(which, dtype):
    w = jnp.asarray(np.random.default_rng(5).normal(size=(64, 200)).astype(np.float32) * 0.02)
    w = w.astype(dtype)
    jfn, tfn = {"s8": (jserv.recode_head_s8, tserv.recode_head_s8),
                "s4": (jserv.recode_head_s4, tserv.recode_head_s4)}[which]
    ref = jfn(w)
    tw = torch.from_numpy(np.array(w.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tfn(tw)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert (got.bits, got.zero, got.out_dtype) == (ref.bits, None, getattr(torch, dtype))


def _jax_model(kind):
    """TINY_LLAMA quantized W4 g32: packed, or recoded per column (head too)."""
    from llama3_quantization_tpu.models import init_params, quantize_model_rtn

    params = init_params(TINY_LLAMA, jax.random.PRNGKey(0), dtype=jnp.float32)
    q = quantize_model_rtn(params, TINY_LLAMA, QuantSpec(n_bits=4, group_size=32),
                           pack=kind == "packed")
    if kind == "percol":
        q = jserv.recode_model_s8(q, TINY_LLAMA, include_head=True)
    return q


@pytest.mark.parametrize("kind", ["packed", "percol"])
def test_fuse_for_decode_matches_jax(kind):
    jp = _jax_model(kind)
    jf = jserv.fuse_for_decode(jp, TINY_LLAMA)
    tp = convert.params_from_numpy(to_numpy_tree(jp), device="cpu")
    tf = tserv.fuse_for_decode(tp, tcfg.TINY_LLAMA)
    assert sorted(tf["layers"]) == sorted(jf["layers"]) == ["down", "gateup", "ln1", "ln2",
                                                            "o", "qkv"]
    for name in ("qkv", "gateup"):
        jw, tw = jf["layers"][name]["w"], tf["layers"][name]["w"]
        assert (tw.n, tw.k, tw.bits, tw.packed) == (jw.n, jw.k, jw.bits, jw.packed)
        for field in ("data", "scale", "zero"):
            jv = getattr(jw, field)
            if jv is None:
                assert getattr(tw, field) is None
            else:
                np.testing.assert_array_equal(getattr(tw, field).numpy(), np.asarray(jv))


def test_recode_model_s8_matches_jax():
    jp = _jax_model("packed")
    jr = jserv.recode_model_s8(jp, TINY_LLAMA)
    tr = tserv.recode_model_s8(convert.params_from_numpy(to_numpy_tree(jp), device="cpu"),
                               tcfg.TINY_LLAMA)
    for name in ("q", "gate", "down"):
        jw, tw = jr["layers"][name]["w"], tr["layers"][name]["w"]
        np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
        np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
        assert tw.zero is None and tw.data.shape[0] == TINY_LLAMA.num_layers


def test_params_from_numpy_percol_s8_tree():
    """A `percol_s8` tree with s8 and s4 heads: unpacked int8 containers,
    zero None, bits 8 (linears, s8 head) or 4 (s4 head), carried exactly."""
    for head in ("head_s8", "head_s4"):
        jp = jsyn.init_quantized_params(TINY_LLAMA, QuantSpec(n_bits=4, group_size=32),
                                        pack=False, dtype=jnp.float32, percol_s8=True,
                                        **{head: True})
        tp = convert.params_from_numpy(to_numpy_tree(jp), device="cpu")
        for tw, jw in ((tp["layers"]["gate"]["w"], jp["layers"]["gate"]["w"]),
                       (tp["lm_head"], jp["lm_head"])):
            assert tw.zero is None and not tw.packed and tw.data.dtype == torch.int8
            assert tw.bits == jw.bits and tw.group_size is None
            np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
            np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
        assert tp["lm_head"].bits == (8 if head == "head_s8" else 4)


def test_a8_packed_weights_warn_once(monkeypatch):
    """a8 with packed weights takes the dequant route and warns once."""
    monkeypatch.setattr(tmm, "_A8_PACKED_WARNED", False)
    tq = carry(_jqt(4, 32, True))
    x = torch.from_numpy(_x(2))
    with tmm.backend("a8"):
        with pytest.warns(UserWarning, match="PACKED"):
            y = tmm.qmatmul(x, tq)
        with tmm.backend("xla"):
            ref = tmm.qmatmul(x, tq)
        np.testing.assert_array_equal(y.numpy(), ref.numpy())


@pytest.fixture
def jax_a8_route():
    """JAX under the a8 backend, its decode kernel interpreted on the CPU."""
    JT.set_decode_kernel("interpret")
    try:
        with jmm.backend("a8"):
            yield
    finally:
        JT.set_decode_kernel("auto")


@pytest.mark.big_compile
def test_fused_engine_a8_matches_jax(jax_a8_route):
    """`ServingEngine(fuse=True)` under a8 on an int8 cache, `run_pipelined`
    and a per-step `run`: identical streams to the JAX engine."""
    jp = _jax_model("percol")
    tp = convert.params_from_numpy(to_numpy_tree(jp), device="cpu")
    reqs = [([1, 2, 3, 4], 9), ([9, 8, 7], 5), ([5] * 20, 7), ([2, 4, 6], 12)]

    def drive(eng):
        for p, n in reqs:
            eng.submit(p, n)
        eng.run_pipelined(4)
        rid = eng.add_request([7, 7, 1], 4)
        eng.run()
        return {r: list(q.generated) for r, q in sorted(eng.requests.items())}, eng.result(rid)

    kw = dict(max_slots=4, max_len=64, quantized_cache=8, schedule="ljf", fuse=True)
    ref = drive(JEngine(jp, TINY_LLAMA, **kw))
    with tmm.backend("a8"):
        teng = TEngine(tp, tcfg.TINY_LLAMA, device="cpu", **kw)
        assert "qkv" in teng.params["layers"] and "q" not in teng.params["layers"]
        got = drive(teng)
    assert got == ref
    assert len({t for s in got[0].values() for t in s}) > 4  # input-dependent streams


def test_backend_switch():
    assert tmm.get_backend() == "pallas"
    with tmm.backend("s4"):
        assert tmm.get_backend() == "s4"
        with pytest.raises(ValueError):
            tmm.set_backend("fp8")
    assert tmm.get_backend() == "pallas"
    tq = carry(_jqt(4, 32, True))
    x = torch.from_numpy(_x(3))
    with tmm.backend("xla"):
        y = tmm.qmatmul(x, tq)
    from llama3_quantization_tpu_torch.quant.qtensor import dequantize

    wd = dequantize(tq)
    np.testing.assert_array_equal(y.numpy(), (x.to(wd.dtype) @ wd).to(x.dtype).numpy())
    ref = functools.partial(jmm.qmatmul, jnp.asarray(x.numpy()), _jqt(4, 32, True))
    with jmm.backend("xla"):
        assert_rel(y.numpy(), np.asarray(ref(), np.float32), 1e-5)


def _stage_ok(k, gs, f, rows):
    """The tiled kernel's stage contract (`l3q_a8_gemm`)."""
    sub = gs // f
    whole = rows % sub == 0 and (k // f) % rows == 0
    return (f * rows in (32, 64, 128) and rows % 8 == 0
            and (sub % rows == 0 if rows <= sub else whole))


@pytest.mark.parametrize("layout", sorted(qa.LAYOUTS))
def test_gemm_plan_keeps_every_group_size(layout):
    """Every (K, group size) the wrapper takes (multiples of 32, gs | K,
    gs = K included) gets a stage the kernel accepts, the largest such;
    the main path's shapes take full 128-k stages."""
    f = qa.LAYOUTS[layout][1]
    for k in (96, 160, 256, 288, 2304, 4096, 14336):
        for gs in [g for g in range(32, k + 1, 32) if k % g == 0]:
            tile, rows = qa.gemm_plan(130, 192, k, gs, f)
            assert tile in (64, 128) and _stage_ok(k, gs, f, rows), (k, gs, rows)
            better = [r for r in (32 // f, 64 // f, 128 // f) if r > rows]
            assert not any(_stage_ok(k, gs, f, r) for r in better), (k, gs, rows)
    for k, gs in ((4096, 128), (14336, 128), (4096, 4096), (14336, 14336)):
        assert f * qa.gemm_plan(128, 28672, k, gs, f)[1] == qa.GEMM_STAGE_K


@pytest.mark.parametrize("m,n,tile", [(128, 28672, 128), (128, 6144, 64), (128, 4096, 64),
                                      (512, 4096, 128), (2048, 4096, 128), (65, 192, 64)])
def test_gemm_plan_tile_from_shape(m, n, tile):
    """128x128 tiles where they give the card about one block per SM (132
    SMs), else 64x64; the same for every K and group size."""
    for k, gs, f in ((4096, 128, 2), (14336, 14336, 1)):
        assert qa.gemm_plan(m, n, k, gs, f)[0] == tile


@pytest.fixture
def no_build(monkeypatch):
    """Any attempt to build or load a kernel library fails the test."""
    from llama3_quantization_tpu_torch.ops import _build

    def refuse(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load", refuse)


def _gemm_args(k=256, n=64, gs=64, layout="u4", m=80):
    f = qa.LAYOUTS[layout][1]
    codes = torch.zeros((k // f, n), dtype=torch.int8 if layout == "s8" else torch.uint8)
    g = k // gs
    return (torch.zeros((m, k), dtype=torch.int8), torch.ones((m, 1)), codes, layout,
            torch.ones((g, n)), torch.zeros((g, n)), gs, torch.float32)


@pytest.mark.parametrize("change,match", [
    ({"k": 96, "gs": 48}, "group_size % 32"),    # group size not a multiple of 32
    ({"n": 40}, "N % 16"),
    ({}, "CUDA"),                                # CPU tensors: the kernel runs on CUDA only
])
def test_a8_gemm_refuses_before_build(no_build, change, match):
    with pytest.raises(ValueError, match=match):
        qa.a8_gemm(*_gemm_args(**change))


def test_a8_gemm_refuses_wrong_codes(no_build):
    args = list(_gemm_args())
    args[2] = args[2].view(torch.int8)  # u4 codes must be uint8
    with pytest.raises(TypeError):
        qa.a8_gemm(*args)
    args = list(_gemm_args(k=256))
    args[2] = torch.zeros((100, 64), dtype=torch.uint8)  # not [K / 2, N]
    with pytest.raises(ValueError):
        qa.a8_gemm(*args)
