"""Port parity: the weight-stream microbench kernels B8-B10 and their entry
points, at small shapes (K = 512, N = 256, bk = 256, bn = 128, L = 2).

Each JAX probe script is loaded by path (`scripts/` stays untouched) and
its Pallas kernel run on the CPU under `pltpu.force_tpu_interpret_mode()`
(the `pallas_call` is built inside that context), on the same
numpy-seeded inputs as the port's plain version (what its wrapper runs on
CPU tensors):

- B8.w4, B8.tiled, B8.depth: exactly equal (small integers summed in f32);
- B9.cast8: within 1e-6 * max|ref| (exact s32 partials; JAX sums the
  fp32 epilogue's rows in another order);
- B10 dot2 and cat: within 1e-6 * max|ref| (the same integers and group
  order); bf16 within 1e-2 * max|ref| (the order inside a bf16 dot).

Interpret mode cannot run the int4 x int4 dots of v4 / bd4, dot4, noscale
and multi on the CPU (XLA: "does not support custom element sizes on
non-sub-byte types"). Those are held instead against a numpy int64
evaluation of each script's formula (exact partials, the fp32 epilogue
summed in order: within 1e-6 * max|ref|), against the identity that v4 over
(xh, xl) is JAX's cast8 kernel (interpret mode) over the block diagonal of
x = 16 xh + xl, and against `microbench_w4_v4.py`'s own oracle. Last, every
`microbench` entry point runs with `--device cpu` at tiny arguments.
"""

import contextlib
import functools
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from llama3_quantization_tpu.quant import QuantSpec
from llama3_quantization_tpu.quant.qtensor import quantize_rtn as j_quantize_rtn
from llama3_quantization_tpu_torch import microbench
from llama3_quantization_tpu_torch.ops import qmm_u8, w4_bd, w4_stream

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
K, N, BK, BN, GS = 512, 256, 256, 128, 128
G, GT = K // GS, BK // GS
REL = 1e-6


@functools.lru_cache(maxsize=None)
def script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_microbench_{name}", ROOT / "scripts" / f"microbench_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def interpret(build, *args):
    """Build a pallas_call inside interpret mode and run it on `args`."""
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(build()(*(jnp.asarray(a) for a in args)))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_rel(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def rng(seed=0):
    return np.random.default_rng(seed)


def packed_w(seed=0, k=K):
    return rng(seed).integers(-128, 128, (k // 2, N)).astype(np.int8)


def scales(seed=1):
    return ((rng(seed).random((G, N)).astype(np.float32) + 0.5) * 0.01)


def int4_np(packed):
    """The TPU's int8 -> int4 bitcast of `[K/2, N]`, int64: row 2r the
    signed low nibble of byte row r, row 2r + 1 its high nibble."""
    p = packed.astype(np.int64)
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
    out[0::2], out[1::2] = ((p & 15) ^ 8) - 8, p >> 4
    return out


def epilogue_np(p_tiles, form, scale):
    """The fp32 epilogue of each script's kernel over tiles of exact P,
    summed in order (float32 numpy: one rounding per operation)."""
    acc = np.zeros(N, np.float32)
    for j, p in enumerate(p_tiles):
        tj = np.zeros(N, np.float32)
        if form in ("v4", "dot4"):
            for r in range(GT):
                tj = tj + (16 * p[r] + p[GT + r]).astype(np.float32) * scale[j * GT + r]
        elif form == "cast8":
            for r in range(GT):
                tj = tj + p[r].astype(np.float32) * scale[j * GT + r]
        else:
            for r in range(p.shape[0]):
                tj = tj + p[r].astype(np.float32)
        acc = acc + tj
    return acc[None]


# ------------------------------------------------------------------- B8 ----


def test_b8_w4_equals_jax_dma_kernel():
    v = script("w4_variants")
    w = packed_w()
    ref = interpret(lambda: v.make_call(v._dma_kernel, K, N, BK, BN, G, [v.spec_w(BK, BN)]), w)
    got = w4_stream.w4_dma(t(w), BK)
    np.testing.assert_array_equal(got.numpy(), ref)
    # row 0 of a block's int4 bitcast is the signed low nibble of its first byte row
    np.testing.assert_array_equal(ref[0], int4_np(w)[0::BK].sum(0).astype(np.float32))


def test_b8_tiled_equals_jax_dma_kernel():
    tl = script("w4_tiled")
    nk, nn = K // BK, N // BN
    wt = rng(2).integers(-128, 128, (nk, nn, BK // 2, BN)).astype(np.int8)

    def build():
        return pl.pallas_call(
            functools.partial(tl._dma_kernel, nsteps=nk), grid=(nn, nk),
            in_specs=[pl.BlockSpec((1, 1, BK // 2, BN), lambda h, j: (j, h, 0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((1, BN), lambda h, j: (0, h), memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((1, N), jnp.float32),
            scratch_shapes=[pltpu.VMEM((1, BN), jnp.float32)],
            compiler_params=pltpu.CompilerParams(dimension_semantics=("parallel", "arbitrary")))

    np.testing.assert_array_equal(w4_stream.w4_dma_tiled(t(wt)).numpy(), interpret(build, wt))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_b8_depth_equals_jax_manual_dma(depth):
    d = script("dma_depth")
    rows, width, chunk = 64, 128, 8
    x = rng(3).integers(-128, 128, (rows, width)).astype(np.int8)
    ref = interpret(lambda: d.make_fn(rows, chunk, depth, width), x)
    np.testing.assert_array_equal(w4_stream.dma_depth(t(x), chunk, depth).numpy(), ref)


def test_b8_rejects_a_depth_it_has_no_form_for():
    with pytest.raises(ValueError):
        w4_stream.dma_depth(torch.zeros((8, 16), dtype=torch.int8), 4, 3)


# ------------------------------------------------------------------- B9 ----


def _cast8_jax(bd1, scale, w):
    v = script("w4_variants")
    specs = [pl.BlockSpec((GT, BK), lambda h, j: (0, j), memory_space=pltpu.VMEM),
             v.spec_s(BK, BN), v.spec_w(BK, BN)]
    return interpret(lambda: v.make_call(v._cast8_kernel, K, N, BK, BN, G, specs),
                     bd1[:GT], scale, w)


def test_b9_cast8_matches_jax_kernel():
    bd1 = rng(4).integers(-120, 120, (G, K)).astype(np.int8)
    w, s = packed_w(5), scales(6)
    ref = _cast8_jax(bd1, s, w)
    assert_rel(w4_bd.w4_cast8(t(bd1), t(s), t(w), BK).numpy(), ref)


def _x_split(seed):
    """x in [-128, 119] and its split x = 16 xh + xl (the script's own)."""
    x = rng(seed).integers(-128, 120, (1, K)).astype(np.int32)
    xh, xl = (np.asarray(a).astype(np.int8) for a in script("w4_v4").split_s8_to_s4(x))
    assert np.array_equal(16 * xh.astype(np.int32) + xl, x)
    return x, xh, xl


def test_b9_v4_is_cast8_over_the_block_diagonal():
    """v4's (xh, xl) rows against JAX's cast8 kernel on the block diagonal
    of x = 16 xh + xl: the same s32 group dots, the same epilogue."""
    x, xh, xl = _x_split(7)
    w, s = packed_w(8), scales(9)
    bd = np.zeros((GT, K), np.int8)
    for j in range(K // BK):
        for r in range(GT):
            cols = slice(j * BK + r * GS, j * BK + (r + 1) * GS)
            bd[r, cols] = x[0, cols]
    ref = _cast8_jax(bd, s, w)
    assert_rel(w4_bd.w4_bd(t(xh), t(xl), t(s), t(w), BK).numpy(), ref)


def _tiles(a_rows, w, ks):
    """Exact P of each tile: a_rows [R, K'] against int4(w) [K', N]."""
    w4 = int4_np(w)
    return [a_rows[:, j * ks:(j + 1) * ks].astype(np.int64) @ w4[j * ks:(j + 1) * ks]
            for j in range(w4.shape[0] // ks)]


@pytest.mark.parametrize("tiled", [False, True])
def test_b9_v4_matches_numpy_formula(tiled):
    x, xh, xl = _x_split(10)
    w, s = packed_w(11), scales(12)
    p = []
    w4 = int4_np(w)
    for j in range(K // BK):
        rows = np.zeros((2 * GT, N), np.int64)
        for r in range(GT):
            ks = slice(j * BK + r * GS, j * BK + (r + 1) * GS)
            rows[r], rows[GT + r] = xh[0, ks].astype(np.int64) @ w4[ks], xl[0, ks].astype(np.int64) @ w4[ks]
        p.append(rows)
    ref = epilogue_np(p, "v4", s)
    arg = w
    if tiled:  # [K/bk, N/bn, bk/2, bn]: block (j, h) holds rows of K block j, columns of N block h
        arg = w.reshape(K // BK, BK // 2, N // BN, BN).transpose(0, 2, 1, 3)
        np.testing.assert_array_equal(w4_bd.untile(t(arg)).numpy(), w)
    assert_rel(w4_bd.w4_bd(t(xh), t(xl), t(s), t(arg), BK, tiled=tiled).numpy(), ref)


@pytest.mark.parametrize("form", ["dot4", "noscale"])
def test_b9_dense_int4_forms_match_numpy_formula(form):
    """dot4 and noscale take rows 0..2gt of bd for every tile (the script's
    block index `(0, j)`)."""
    bd2 = rng(13).integers(-8, 8, (2 * G, K)).astype(np.int8)
    w, s = packed_w(14), scales(15)
    ref = epilogue_np(_tiles(bd2[:2 * GT], w, BK), form, s)
    got = (w4_bd.w4_dot4(t(bd2), t(s), t(w), BK) if form == "dot4"
           else w4_bd.w4_noscale(t(bd2), t(w), BK))
    assert_rel(got.numpy(), ref)


@pytest.mark.parametrize("streams", [1, 2, 4])
def test_b9_multi_matches_numpy_formula(streams):
    ks, rows = K // streams, 2 * GT // streams
    ws = [packed_w(20 + i, k=ks) for i in range(streams)]
    bds = [rng(30 + i).integers(-8, 8, (rows, ks)).astype(np.int8) for i in range(streams)]
    per_stream = [_tiles(b, w, BK // streams) for b, w in zip(bds, ws)]
    p = [sum(ps[j] for ps in per_stream) for j in range(K // BK)]
    got = w4_bd.w4_multi([t(b) for b in bds], [t(w) for w in ws], BK)
    assert_rel(got.numpy(), epilogue_np(p, "noscale", None))


def test_w4_v4_matches_the_scripts_oracle():
    """`v4_matvec` on the script's inputs (its `pack_nibbles`, codes, zero
    points, scales) against its oracle `xq @ dequant(w)` (`:123-131`)."""
    from llama3_quantization_tpu_torch.microbench import w4_v4 as tv4

    jv4 = script("w4_v4")
    r = rng(0)
    codes = r.integers(0, 16, (K, N)).astype(np.int8)
    zero = r.integers(4, 12, (G, N)).astype(np.float32)
    scale = (r.random((G, N)).astype(np.float32) + 0.5) * 0.01
    xq = r.integers(-120, 120, (1, K)).astype(np.int8)
    packed = np.asarray(jv4.pack_nibbles(codes - 8))
    np.testing.assert_array_equal(tv4.pack_nibbles(t(codes - 8)).numpy(), packed)
    grp = np.repeat(np.arange(G), GS)
    exp = xq.astype(np.float32) @ (scale[grp] * (codes.astype(np.float32) - zero[grp]))
    got = tv4.v4_matvec(t(xq), t(packed), t(scale), t(scale * (zero - 8.0)), BK, BN).numpy()
    err = np.abs(got - exp).max() / (np.abs(exp).max() + 1e-9)
    assert err < 1e-5, err


# ------------------------------------------------------------------ B10 ----


@pytest.mark.parametrize("variant", ["dot2", "cat", "bf16"])
def test_b10_matches_jax_u8_kernel(variant):
    u = script("unpack")
    w = rng(40).normal(size=(K, N)).astype(np.float32) * 0.02
    qt = j_quantize_rtn(jnp.asarray(w), QuantSpec(n_bits=4, group_size=GS), pack=True)
    packed, scale, zero = (np.asarray(a) for a in (qt.data, qt.scale, qt.zero))
    xq = rng(41).integers(-127, 128, (qmm_u8.BM, K)).astype(np.int8)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(u.u8_qmm(jnp.asarray(xq), jnp.asarray(packed), jnp.asarray(scale),
                                  jnp.asarray(zero), variant=variant, bn=BN))
    got = qmm_u8.u8_qmm(t(xq), t(packed), t(scale), t(zero), variant).numpy()
    assert_rel(got, ref, 1e-2 if variant == "bf16" else REL)


def test_b10_dot2_cat_are_b3_integers():
    """dot2 and cat compute B3's function on u4 codes without s_x."""
    from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa

    w = torch.from_numpy(rng(42).normal(size=(K, N)).astype(np.float32))
    import llama3_quantization_tpu_torch as P

    qt = P.quantize_rtn(w, P.QuantSpec(n_bits=4, group_size=GS), pack=True)
    xq = t(rng(43).integers(-127, 128, (qmm_u8.BM, K)).astype(np.int8))
    ones = torch.ones((qmm_u8.BM, 1))
    ref = qa.a8_plain(xq, ones, qt.data, "u4", qt.scale, qt.zero, GS, torch.float32)
    for v in ("dot2", "cat"):
        np.testing.assert_array_equal(qmm_u8.u8_qmm(xq, qt.data, qt.scale, qt.zero, v).numpy(),
                                      ref.numpy())


# --------------------------------------------------------- entry points ----

TINY = {"w4_variants": ["512", "256", "256", "128"], "w4_tiled": ["512", "256", "256", "128"],
        "w4_multidma": ["512", "256", "256", "128"], "dma_depth": ["1", "16"],
        "w4_v4": ["512", "256", "256", "128"], "unpack": ["512", "256", "1"]}


@pytest.mark.parametrize("name", microbench.MODULES)
def test_entry_point_runs_on_cpu(name):
    mod = importlib.import_module(f"llama3_quantization_tpu_torch.microbench.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(TINY[name] + ["--device", "cpu"] + ([] if name == "unpack" else ["--steps", "1"]))
    text = buf.getvalue()
    assert "device: cpu" in text and ("us/call" in text or "GB/s" in text)
    times = [v for key, v in out.items() if key not in ("max_rel_err", "rel_err")]
    assert times and all(np.isfinite(times)) and all(x > 0 for x in times)
    if name == "w4_v4":
        assert out["max_rel_err"] < 1e-5
    if name == "unpack":
        assert out["rel_err"]["dot2"] < 1e-5 and out["rel_err"]["bf16"] < 2e-2
