"""Port parity: the JAX package's decode routes, `set_decode_kernel` and
`set_decode_attn` (`models/transformer.py:280-321`), and the codes-direct
int8 route `xla_decode_gqa_s8(_stacked)` (`ops/decode_attention.py:491-586`).

- The study's `serving_a8` row (`tools/reproduce_study.py:232-260`):
  under `set_decode_kernel(False)` the port gives the digest of
  `tests/fixtures/golden_study.json` (JAX's default route, eager on the
  CPU); on its default kernel route, the digest JAX gives under
  `set_decode_kernel("interpret")`.
- `set_decode_kernel(False)`: decode logits on the int8, int4 and fp caches
  equal JAX's default route on the CPU within 1e-5 of max|logit| (both
  eager fp32 attention; only fp32 summation order differs); `windowed_ok`
  is False.
- The codes-direct route against JAX's: the s32 dots are exact, so only
  the fp32 order of the sums (and an ulp of exp) differs: o within 1e-5 of
  max|o|, m within 1e-6 of |m|, l within 1e-5 of l; T = 1536 and 2048
  cover the chunked PV dot.
- `decode_step` / `decode_step_multi` token streams and the windowed
  engine under `set_decode_attn("xla")` equal JAX's under "interpret" +
  "xla".
- Invalid modes raise. Every test that sets a mode resets it in a
  `finally` (`port_route`, `jax_route`).
"""

import contextlib
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.ops import decode_attention as jda
from llama3_quantization_tpu.ops.kvcache import kv_quantize as j_kv_quantize
from llama3_quantization_tpu.serving import ServingEngine as JEngine
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models.params import quantize_model_rtn
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.models import windowed as TW
from llama3_quantization_tpu_torch.ops import decode_attention as da
from llama3_quantization_tpu_torch.ops import matmul as tmm
from llama3_quantization_tpu_torch.quant.quantizer import QuantSpec
from llama3_quantization_tpu_torch.serving import ServingEngine as TEngine
from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

CFG, TCFG = TINY_LLAMA, tcfg.TINY_LLAMA
GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_study.json")
#: the port's (and JAX's interpreted-kernel) digest of the serving_a8 recipe
KERNEL_ROUTE_DIGEST = "af93c59924f5fd76"


@contextlib.contextmanager
def port_route(kernel="auto", attn="auto"):
    TT.set_decode_kernel(kernel)
    TT.set_decode_attn(attn)
    try:
        yield
    finally:
        TT.set_decode_kernel("auto")
        TT.set_decode_attn("auto")


@contextlib.contextmanager
def jax_route(kernel="auto", attn="auto"):
    JT.set_decode_kernel(kernel)
    JT.set_decode_attn(attn)
    try:
        yield
    finally:
        JT.set_decode_kernel("auto")
        JT.set_decode_attn("auto")


@pytest.fixture(scope="module")
def fp_models():
    """TINY_LLAMA fp32 from JAX's `init_params(PRNGKey(0))`, on both sides."""
    jp = init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, convert.params_from_numpy(to_numpy_tree(jp), device="cpu")


def serving_a8_digest(tparams):
    """The study's serving row on the port: RTN W4 g32 unpacked, backend a8,
    `ServingEngine(2, 64, int8 cache)`, the six requests of
    `default_rng(3)`, `run_pipelined(4)`. Returns (digest, tokens, engine)."""
    qp = quantize_model_rtn(tparams, TCFG, QuantSpec(n_bits=4, group_size=32), pack=False)
    with tmm.backend("a8"):
        eng = TEngine(qp, TCFG, max_slots=2, max_len=64, quantized_cache=8, device="cpu")
        rng = np.random.default_rng(3)
        lengths = [(int(rng.integers(4, 12)), int(rng.integers(6, 14))) for _ in range(6)]
        for plen, glen in lengths:
            eng.submit(list(rng.integers(0, TCFG.vocab_size, plen)), glen, None)
        eng.run_pipelined(4)
    streams = [eng.requests[rid].generated for rid in sorted(eng.requests)]
    blob = ";".join(",".join(map(str, s)) for s in streams)
    return hashlib.sha1(blob.encode()).hexdigest()[:16], sum(len(s) for s in streams), eng


def test_serving_a8_golden_digest_with_decode_kernel_off(fp_models):
    """C1: the port reproduces the golden serving row of JAX's default route."""
    with open(GOLDEN) as f:
        golden = json.load(f)["serving_a8"]
    with port_route(kernel=False):
        digest, tokens, eng = serving_a8_digest(fp_models[1])
    assert (digest, tokens) == (golden["digest"], golden["tokens"]) == ("60c808d9d2690be3", 50)
    assert eng.dispatches["windowed"] == 0 and eng.dispatches["per_step"] > 0


def test_serving_a8_default_route_digest(fp_models):
    """The default ("auto") route keeps the kernel routing: B5 windows."""
    digest, tokens, eng = serving_a8_digest(fp_models[1])
    assert (digest, tokens) == (KERNEL_ROUTE_DIGEST, 50)
    assert eng.dispatches["windowed"] > 0


def _logits_trace(step, cache, params, toks, as_pos):
    """Prefill 4 tokens, then 8 single-token steps: the logits."""
    lg, cache = step(params, cache, toks[:, :4], as_pos(0))
    seq = [np.asarray(lg[:, -1])]
    for i in range(4, 12):
        lg, cache = step(params, cache, toks[:, i : i + 1], as_pos(i))
        seq.append(np.asarray(lg[:, 0]))
    return np.stack(seq)


@pytest.mark.parametrize("quantized", [8, 4, False])
def test_decode_kernel_off_matches_jax_default(fp_models, quantized):
    """Under False every cached step is eager on all three caches: the
    port's logits equal JAX's default CPU route (gate False) within 1e-5 of
    max|logit|; the windowed decode is off."""
    jp, tp = fp_models
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 12)).astype(np.int32)
    jq = {8: True, 4: 4, False: False}[quantized]
    jcache = JT.init_kv_cache(CFG, 2, 16, dtype=jnp.float32, quantized=jq)
    ref = _logits_trace(lambda p, c, t, pos: JT.decode_step(p, c, jnp.asarray(t), pos, CFG),
                        jcache, jp, toks, jnp.int32)
    with port_route(kernel=False):
        tcache = TT.init_kv_cache(TCFG, 2, 16, dtype=torch.float32, quantized=quantized,
                                  device="cpu")
        assert not TW.windowed_ok(TCFG, tcache)
        got = _logits_trace(lambda p, c, t, pos: TT.decode_step(p, c, torch.from_numpy(t), pos,
                                                                 TCFG),
                            tcache, tp, toks, int)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _xla_inputs(b, g, rep, d, t, seed, layers=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, g * rep, d)).astype(np.float32)
    kv = rng.standard_normal((2, layers, b, g, t, d)).astype(np.float32)
    mask = rng.uniform(-2.0, 0.0, (b, t)).astype(np.float32)
    mask[0, t - t // 5 :] = jda.NEG  # a masked tail
    if b > 1:
        mask[1, :] = jda.NEG  # an all-masked row: m = -1e30, l = T
    kq, ks = j_kv_quantize(jnp.asarray(kv[0]))
    vq, vs = j_kv_quantize(jnp.asarray(kv[1]))
    return q, (kq, ks, vq, vs), mask


def _assert_o_m_l(got, ref):
    (to, tm, tl), (jo, jm, jl) = got, [np.asarray(x) for x in ref]
    np.testing.assert_allclose(to.numpy(), jo, rtol=0, atol=1e-5 * np.abs(jo).max())
    np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5, atol=0)


# (B, G, rep, D, T): TINY_LLAMA's heads at its cache lengths, and two
# lengths above 1024 (the PV dot summed in exact s32 chunks)
XLA_SHAPES = [(2, 2, 2, 16, 16), (2, 2, 2, 16, 64), (2, 2, 4, 32, 1536), (1, 8, 4, 128, 2048)]


@pytest.mark.parametrize("shape", XLA_SHAPES)
def test_xla_decode_matches_jax(shape):
    b, g, rep, d, t = shape
    q, arrs, mask = _xla_inputs(b, g, rep, d, t, seed=t)
    ref = jda.xla_decode_gqa_s8(jnp.asarray(q), *(a[0] for a in arrs), jnp.asarray(mask),
                                out_dtype=jnp.float32)
    targs = [torch.from_numpy(np.array(a[0])) for a in arrs]
    got = da.xla_decode_gqa_s8(torch.from_numpy(q), *targs, torch.from_numpy(mask),
                               out_dtype=torch.float32)
    assert got.shape == (b, 1, g * rep, d) and got.dtype == torch.float32
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("shape", [XLA_SHAPES[1], XLA_SHAPES[2]])
def test_xla_decode_stacked_stats_match_jax(shape, layer):
    """The stacked form with m/l (the windowed merge's input); the
    all-masked row keeps m = -1e30 and l = T on both sides."""
    b, g, rep, d, t = shape
    q, arrs, mask = _xla_inputs(b, g, rep, d, t, seed=layer + 3, layers=2)
    ref = jda.xla_decode_gqa_s8_stacked(jnp.asarray(q), *arrs, jnp.asarray(mask), layer,
                                        out_dtype=jnp.float32, return_stats=True)
    targs = [torch.from_numpy(np.array(a)) for a in arrs]
    got = da.xla_decode_gqa_s8_stacked(torch.from_numpy(q), *targs, torch.from_numpy(mask),
                                       layer, out_dtype=torch.float32, return_stats=True)
    _assert_o_m_l(got, ref)
    assert np.all(got[1].numpy()[1] == np.float32(jda.NEG)) and np.all(got[2].numpy()[1] == t)


def test_s8_dot_long_exact():
    """The chunked s32 dot is exact past 1024 terms, at its largest partials."""
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (2, 3, 2500), dtype=np.int8)
    b = rng.integers(-127, 128, (2, 2500, 5), dtype=np.int8)
    a[0, 0] = 127
    b[0, :, 0] = 127
    ref = a.astype(np.int64) @ b.astype(np.int64)
    got = da.s8_dot_long(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_decode_streams_xla_match_jax(fp_models):
    """`decode_step` greedy streams and `decode_step_multi` logits under
    "xla", int8 cache: the port against JAX under "interpret" + "xla"
    (tokens identical; per-row logits within 1e-4 of max|logit|, the tolerance
    of tests/test_kvcache.py:322-329)."""
    jp, tp = fp_models
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 12)).astype(np.int32)

    def jax_run():
        cache = JT.init_kv_cache(CFG, 2, 16, quantized=True)
        lg, cache = JT.decode_step(jp, cache, jnp.asarray(toks[:, :4]), jnp.int32(0), CFG)
        tok, stream = np.asarray(lg[:, -1]).argmax(-1), []
        for i in range(4, 12):
            lg, cache = JT.decode_step(jp, cache, jnp.asarray(tok[:, None].astype(np.int32)),
                                       jnp.int32(i), CFG)
            tok = np.asarray(lg[:, 0]).argmax(-1)
            stream.append(tok)
        mcache = JT.init_kv_cache(CFG, 2, 16, quantized=True)
        _, mcache = JT.decode_step(jp, mcache, jnp.asarray(toks[:, :4]), jnp.int32(0), CFG)
        mlg, _ = JT.decode_step_multi(jp, mcache, jnp.asarray(toks[:, 4:5]),
                                      jnp.array([4, 2]), CFG)
        return np.stack(stream), np.asarray(mlg)

    def port_run():
        cache = TT.init_kv_cache(TCFG, 2, 16, quantized=8, device="cpu")
        lg, cache = TT.decode_step(tp, cache, torch.from_numpy(toks[:, :4]), 0, TCFG)
        tok, stream = lg[:, -1].argmax(-1), []
        for i in range(4, 12):
            lg, cache = TT.decode_step(tp, cache, tok[:, None], i, TCFG)
            tok = lg[:, 0].argmax(-1)
            stream.append(tok.numpy())
        mcache = TT.init_kv_cache(TCFG, 2, 16, quantized=8, device="cpu")
        _, mcache = TT.decode_step(tp, mcache, torch.from_numpy(toks[:, :4]), 0, TCFG)
        mlg, _ = TT.decode_step_multi(tp, mcache, torch.from_numpy(toks[:, 4:5]),
                                      torch.tensor([4, 2]), TCFG)
        return np.stack(stream), mlg.numpy()

    with jax_route("interpret", "xla"):
        ref_stream, ref_multi = jax_run()
    with port_route(attn="xla"):
        got_stream, got_multi = port_run()
    np.testing.assert_array_equal(got_stream, ref_stream)
    np.testing.assert_allclose(got_multi, ref_multi, rtol=0, atol=1e-4 * np.abs(ref_multi).max())


@pytest.mark.big_compile
def test_windowed_engine_xla_matches_jax(fp_models):
    """The windowed serving path with the codes-direct main segment (JAX
    `windowed.py:201-205`, `tests/test_windowed.py:137-175`): identical
    streams to JAX under "interpret" + "xla", through windows."""
    jp, tp = fp_models
    prompts, lens = [[1, 2, 3, 4], [9, 8, 7]], [6, 8]

    def drive(eng):
        for pr, n in zip(prompts, lens):
            eng.submit(pr, n, None)
        eng.run_pipelined(4)
        return sorted(tuple(r.generated) for r in eng.requests.values())

    with jax_route("interpret", "xla"):
        ref = drive(JEngine(jp, CFG, max_slots=2, max_len=64, quantized_cache=True))
    with port_route(attn="xla"):
        eng = TEngine(tp, TCFG, max_slots=2, max_len=64, quantized_cache=8, device="cpu")
        assert TW.windowed_ok(TCFG, eng.cache)
        got = drive(eng)
        assert eng.dispatches["windowed"] > 0
    assert got == ref


def test_windowed_ok_follows_decode_kernel():
    cache = TT.init_kv_cache(TCFG, 1, 64, quantized=8, device="cpu")
    assert TW.windowed_ok(TCFG, cache)
    with port_route(kernel=False):
        assert not TW.windowed_ok(TCFG, cache)
    with port_route(kernel=True, attn="xla"):
        assert TW.windowed_ok(TCFG, cache)
    assert TT._DECODE_KERNEL == "auto" and TT._DECODE_ATTN == "auto"


@pytest.mark.parametrize("fn,mode", [
    (TT.set_decode_kernel, "interpret"), (TT.set_decode_kernel, "xla"),
    (TT.set_decode_kernel, None), (TT.set_decode_attn, "interpret"),
    (TT.set_decode_attn, True), (TT.set_decode_attn, "XLA"),
])
def test_invalid_modes_raise(fn, mode):
    with pytest.raises(ValueError):
        fn(mode)
    assert TT._DECODE_KERNEL == "auto" and TT._DECODE_ATTN == "auto"
