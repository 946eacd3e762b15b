"""The kernels' shape predicates and the routes they choose (CPU).

- Each predicate (`b1_takes`, `b2_takes`, `b3_gemv_takes`, `b3_gemm_takes`,
  `b5_takes`, `b6_takes`, `b7_takes`) on a table of shapes in range and
  just out of range; the wrappers' raises read the same predicates (their
  launches recorded, not run).
- The padded weights of B1, B2 and B3 (`ops/padding.py`): a weight whose
  shape one of them does not take is padded, once where the weights are
  prepared (each group to whole 32-row runs, K to whole 64-row tiles, N
  to a multiple of 16), to one that every kernel takes (their wrappers
  launch on it, launches recorded), and a matmul on it (zero x columns in
  place, output sliced back) gives the plain version's result on the
  weight as it is: bit for bit through B3's, and through B1's and B2's
  unless groups gained rows (within 1e-6 of max|ref| then: the fp32
  order of a group's sum moves). Every
  group size fits; each padded call is counted.
- The attention gates against JAX's eager route (the route JAX's gates
  take for these shapes): `TINY_LLAMA` `forward_logits` at S = 128 (D =
  16, which B7 does not take) and decode on int8, int4 and fp caches of a
  llama with rep 3 and 6 (which B4/B5 and B6 do not take): logits within
  1e-5 of max|logit|, greedy tokens identical, the turned-away calls
  counted (`B7.eager`, `B5.eager`, `B6.eager`), and no windowed decode.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.models import windowed as TW
from llama3_quantization_tpu_torch.ops import _build, launches
from llama3_quantization_tpu_torch.ops import decode_attention as da
from llama3_quantization_tpu_torch.ops import flash_attention as fa
from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq
from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa
from llama3_quantization_tpu_torch.ops import s4_matmul as s4
from llama3_quantization_tpu_torch.ops import matmul as mm
from llama3_quantization_tpu_torch.ops import padding as pd
from llama3_quantization_tpu_torch.quant import qtensor as tq
from llama3_quantization_tpu_torch.models import params as tparams
from llama3_quantization_tpu_torch.models.params import stack_qtensors
from test_torch_model import to_numpy_tree

torch.set_num_threads(1)


# ------------------------------------------------------------ predicates ----
B1_TABLE = [  # (m, k, n, gs, bits, packed), takes
    ((1, 256, 64, 64, 4, True), True),
    ((64, 256, 64, 64, 4, True), True),
    ((65, 256, 64, 64, 4, True), False),      # M > 64: B2's
    ((0, 256, 64, 64, 4, True), False),
    ((8, 256, 48, 64, 4, True), True),
    ((8, 256, 40, 64, 4, True), False),       # N % 16
    ((8, 256, 64, 16, 4, True), True),        # 8-row nibble fields
    ((8, 256, 64, 8, 4, True), False),        # group_size % 16
    ((8, 256, 64, 32, 2, True), True),
    ((8, 256, 64, 16, 2, True), False),       # 4-row bit fields
    ((8, 96, 64, 32, 4, True), True),         # B1 has no K % 64
    ((8, 256, 64, 64, 3, True), False),       # 3-bit planes take B2
    ((8, 256, 64, 64, 8, False), True),
    ((8, 256, 64, 24, 8, False), False),
    ((8, 256, 64, 64, 5, True), True),        # one code a byte: uint8 codes
]

B2_TABLE = [  # (k, n, gs, bits, packed), takes
    ((256, 64, 64, 4, True), True),
    ((256, 48, 64, 4, True), True),
    ((256, 40, 64, 4, True), False),          # N % 16
    ((192, 64, 64, 4, True), True),
    ((96, 64, 32, 4, True), False),           # K % 64
    ((256, 64, 16, 4, True), True),
    ((256, 64, 8, 4, True), False),           # a run of 16 rows spans groups
    ((256, 64, 32, 2, True), True),
    ((256, 64, 16, 2, True), False),
    ((256, 64, 64, 3, True), True),
    ((256, 64, 8, 3, True), True),
    ((256, 64, 8, 8, False), True),
    ((256, 64, 4, 8, False), False),
    ((256, 64, 64, 5, True), True),
]

B3_GEMV_TABLE = [  # (m, k, n, gs, layout), takes
    ((1, 256, 64, 32, "u4"), True),
    ((64, 256, 64, 32, "s4"), True),
    ((65, 256, 64, 32, "s4"), False),
    ((8, 256, 40, 32, "s8"), False),          # N % 16
    ((8, 256, 48, 32, "u2"), True),
    ((8, 256, 64, 16, "u4"), False),          # group_size % 32
    ((8, 96, 64, 96, "s8"), True),
    ((8, 96, 64, 48, "s8"), False),
]

B3_GEMM_TABLE = [  # (k, n, gs, layout), takes
    ((256, 64, 64, "u4"), True),
    ((256, 40, 64, "u4"), False),
    ((96, 64, 32, "u8"), True),
    ((96, 64, 48, "u8"), False),
    ((256, 64, 256, "s8"), True),
]

B5_TABLE = [  # (hq, g, d, t, block_t, int4), takes
    ((32, 8, 128, 512, 512, False), True),
    ((32, 8, 128, 2048, 1024, True), True),
    ((4, 2, 16, 64, 512, False), True),       # TINY_LLAMA
    ((24, 8, 128, 512, 512, False), False),   # rep 3
    ((48, 8, 128, 512, 512, True), False),    # rep 6
    ((64, 8, 128, 512, 512, False), True),    # rep 8
    ((128, 8, 128, 512, 512, False), False),  # rep 16
    ((71, 1, 64, 512, 512, False), False),    # FALCON_7B: rep 71
    ((32, 8, 24, 512, 512, False), False),    # D % 16
    ((32, 8, 272, 512, 512, False), False),   # D > 256
    ((32, 8, 256, 512, 512, False), True),
    ((32, 8, 128, 600, 512, False), False),   # T not whole blocks
    ((32, 8, 128, 34, 512, True), True),
    ((32, 8, 128, 33, 512, True), False),     # odd int4 block
]

B6_TABLE = [  # (hq, g, d, t, block_t, dtype), takes
    ((32, 8, 128, 512, 512, torch.bfloat16), True),
    ((32, 8, 128, 512, 512, torch.float32), True),
    ((32, 8, 128, 512, 512, torch.float16), False),
    ((4, 2, 16, 64, 512, torch.bfloat16), True),
    ((24, 8, 128, 512, 512, torch.bfloat16), False),  # rep 3
    ((48, 8, 128, 512, 512, torch.bfloat16), False),  # rep 6
    ((32, 8, 24, 512, 512, torch.bfloat16), True),    # D % 8
    ((32, 8, 20, 512, 512, torch.bfloat16), False),
    ((32, 8, 264, 512, 512, torch.bfloat16), False),
    ((32, 8, 128, 1536, 1024, torch.bfloat16), False),
]

B7_TABLE = [  # (h, g, d), takes
    ((32, 8, 128), True),
    ((16, 16, 64), True),
    ((4, 2, 16), False),   # TINY_LLAMA
    ((32, 8, 96), False),
    ((32, 8, 256), False),
    ((12, 8, 128), False),  # H % G
]


@pytest.mark.parametrize("args,takes", B1_TABLE)
def test_b1_takes(args, takes):
    assert fq.b1_takes(*args) is takes


@pytest.mark.parametrize("args,takes", B2_TABLE)
def test_b2_takes(args, takes):
    assert fq.b2_takes(*args) is takes


@pytest.mark.parametrize("args,takes", B3_GEMV_TABLE)
def test_b3_gemv_takes(args, takes):
    assert qa.b3_gemv_takes(*args) is takes
    if args[0] <= 64:  # above, b3_takes asks the tiled form
        assert qa.b3_takes(*args) is takes


@pytest.mark.parametrize("args,takes", B3_GEMM_TABLE)
def test_b3_gemm_takes(args, takes):
    assert qa.b3_gemm_takes(*args) is takes
    assert qa.b3_takes(80, *args) is takes


@pytest.mark.parametrize("args,takes", B5_TABLE)
def test_b5_takes(args, takes):
    assert da.b5_takes(*args) is takes


@pytest.mark.parametrize("args,takes", B6_TABLE)
def test_b6_takes(args, takes):
    assert da.b6_takes(*args) is takes


@pytest.mark.parametrize("args,takes", B7_TABLE)
def test_b7_takes(args, takes):
    assert fa.b7_takes(*args) is takes


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers' launches recorded instead of run."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def call(*args):
                calls.append(name)
                return 0
            return call

    monkeypatch.setattr(fq, "_lib", Lib)
    monkeypatch.setattr(qa, "_lib", Lib)
    monkeypatch.setattr(qa, "_require_cuda", lambda xq: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    return calls


def _qt(k, n, gs, bits=4, packed=True, seed=0):
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32))
    return tq.quantize_rtn(w, tq.QuantSpec(n_bits=bits, group_size=gs), pack=packed)


@pytest.mark.parametrize("m,k,n,gs,bits,packed", [
    (8, 256, 64, 64, 4, True), (8, 256, 40, 64, 4, True), (8, 256, 64, 8, 4, True),
    (70, 256, 64, 64, 4, True), (70, 96, 64, 32, 4, True), (70, 256, 48, 8, 4, True),
    (70, 256, 64, 64, 3, True), (70, 256, 64, 8, 8, False),
])
def test_qmm_wrappers_raise_on_their_predicate(fake_launch, m, k, n, gs, bits, packed):
    """B1 and B2 launch where their predicate holds and raise before any
    launch where it does not."""
    qt = _qt(k, n, gs, bits, packed)
    x = torch.randn(m, k)
    wrapper, takes = ((fq.qmm_gemv, fq.b1_takes(m, k, n, gs, bits, packed)) if m <= 64
                      else (fq.qmm_gemm, fq.b2_takes(k, n, gs, bits, packed)))
    if takes:
        wrapper(x, qt, torch.float32)
        assert len(fake_launch) == 1
    else:
        with pytest.raises(ValueError):
            wrapper(x, qt, torch.float32)
        assert fake_launch == []


@pytest.mark.parametrize("m,k,n,gs", [(8, 256, 64, 32), (8, 256, 40, 32), (8, 256, 64, 16),
                                      (80, 256, 64, 32), (80, 256, 40, 32)])
def test_b3_wrappers_raise_on_their_predicate(fake_launch, m, k, n, gs):
    qt = _qt(k, n, gs)
    xq, s_x = qa.quantize_activations_s8(torch.randn(m, k))
    wrapper = qa.a8_gemv if m <= 64 else qa.a8_gemm
    args = (xq, s_x, qt.data, "u4", qt.scale, qt.zero, gs, torch.float32)
    args = args + ("B3.v3",) if m <= 64 else args
    if qa.b3_takes(m, k, n, gs, "u4"):
        wrapper(*args)
        assert len(fake_launch) == 1
    else:
        with pytest.raises(ValueError):
            wrapper(*args)
        assert fake_launch == []


@pytest.mark.parametrize("hq,g,d,t,int4", [(4, 2, 16, 64, False), (6, 2, 16, 64, False),
                                           (12, 2, 16, 64, True), (4, 2, 24, 64, False)])
def test_decode_wrappers_raise_on_their_predicate(hq, g, d, t, int4):
    """B4/B5 and B6 raise on a shape outside their predicate (the CPU
    tensors of an in-range call fail later, at the device check)."""
    q = torch.randn(1, 1, hq, d)
    rows = t // 2 if int4 else t
    codes = torch.zeros((1, g, rows, d), dtype=torch.uint8 if int4 else torch.int8)
    scales = torch.ones((1, g, t, 1))
    mask = torch.zeros(1, t)
    if not da.b5_takes(hq, g, d, t, 512, int4):
        with pytest.raises(ValueError, match="b5_takes"):
            da.decode_s8(q, codes, scales, codes, scales, mask, block_t=512)
    kv = torch.zeros((1, g, t, d), dtype=torch.bfloat16)
    if not da.b6_takes(hq, g, d, t, 512, torch.bfloat16):
        with pytest.raises(ValueError, match="b6_takes"):
            da.decode_fp(q.bfloat16(), kv, kv, mask, block_t=512)


def test_b7_wrapper_raises_on_its_predicate():
    q = torch.randn(1, 8, 4, 16)
    kv = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="b7_takes"):
        fa.flash_attention_cuda(q, kv, kv)


# ---------------------------------------------------------- padded weights ----
def _padded(qt):
    """`qt` as `pad_weight` leaves it on the card."""
    if pd.kernels_take(qt):
        return qt
    return pd.PaddedWeight(pd.pad_qtensor(qt), qt.k, qt.n, qt.group_size or qt.k)


@pytest.mark.parametrize("m,k,n,gs,bits,packed,route", [
    (8, 256, 64, 64, 4, True, "B1"),
    (8, 256, 40, 64, 4, True, "B1.pad"),       # N % 16
    (8, 96, 40, 32, 2, True, "B1.pad"),
    (8, 256, 64, 8, 4, True, "B1.pad"),        # group_size % 16: groups pad to 32
    (80, 256, 64, 64, 4, True, "B2"),
    (80, 96, 64, 32, 4, True, "B2.pad"),       # K % 64
    (80, 96, 64, None, 4, True, "B2.pad"),     # one group of 96 rows: K pads to 192
    (80, 288, 40, 96, 4, True, "B2.pad"),      # K and N
    (80, 96, 40, 32, 8, False, "B2.pad"),
    (80, 120, 64, 40, 3, True, "B2.pad"),      # bit planes
    (80, 256, 48, 8, 4, True, "B2.pad"),       # a run of 16 rows spans groups
])
def test_qmm_card_route(fake_launch, m, k, n, gs, bits, packed, route):
    """The weight as it is where the kernels take it, else its padded form,
    on which the kernel of M launches; the padded matmul equals the plain
    version on the weight as it is."""
    qt = _qt(k, n, gs, bits, packed, seed=m + k + n)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((m, k)).astype(np.float32))
    w = _padded(qt)
    assert isinstance(w, pd.PaddedWeight) == route.endswith(".pad")
    inner = w.w if route.endswith(".pad") else w
    assert pd.kernels_take(inner)
    assert inner.k % 64 == 0 and inner.n % 16 == 0
    kernel = fq.qmm_gemv if m <= fq.GEMV_MAX_M else fq.qmm_gemm
    xin = w.pad_x(x) if route.endswith(".pad") else x
    kernel(xin, inner, torch.float32)
    assert len(fake_launch) == 1
    plain = fq.qmm_gemv_plain if m <= fq.GEMV_MAX_M else fq.qmm_gemm_plain
    ref = plain(x, qt, torch.float32)
    launches.reset()
    with mm.backend("pallas"):
        got = mm.qmatmul(x, w, out_dtype=torch.float32)
    assert got.shape == (m, n)
    assert launches.COUNTS["pad"] == route.endswith(".pad")
    # bit for bit unless groups gained rows, which moves the order of a
    # group's fp32 sum
    grown = route.endswith(".pad") and w.w.group_size != (gs or k)
    atol = 1e-6 * float(ref.abs().max()) if grown else 0.0
    torch.testing.assert_close(got, ref, rtol=0, atol=atol)


def test_kernel_padded_zero_codes_scale_one():
    """Each group's codes gain zero codes at its end (kept beside the
    group's own scale and zero point: the zero x columns there add 0); K
    gains whole groups and N columns with scale 1 and zero point 0, which
    dequantize to exact zeros."""
    qt = _qt(120, 40, 24)
    p = pd.pad_qtensor(qt)
    assert (p.k, p.n, p.group_size) == (192, 48, 32)
    codes, pcodes = tq._codes(qt), tq._codes(p)
    grouped = pcodes[:160].reshape(5, 32, 48)
    assert torch.equal(grouped[:, :24, :40], codes.reshape(5, 24, 40))
    assert not grouped[:, 24:].any() and not pcodes[160:].any() and not pcodes[:, 40:].any()
    wp = tq.dequantize(p, torch.float32)
    assert torch.equal(wp[:160].reshape(5, 32, 48)[:, :24, :40],
                       tq.dequantize(qt, torch.float32).reshape(5, 24, 40))
    assert not wp[160:].any() and not wp[:, 40:].any()
    assert torch.equal(p.scale[5:], torch.ones(1, 48)) and not p.zero[5:].any()
    planes = _qt(120, 64, 40, bits=3)
    pp = pd.pad_qtensor(planes)
    assert (pp.k, pp.group_size) == (192, 64)
    assert torch.equal(tq.dequantize(pp, torch.float32).reshape(3, 64, 64)[:, :40],
                       tq.dequantize(planes, torch.float32).reshape(3, 40, 64))


def test_padding_is_made_once_per_stacked_weight(monkeypatch):
    """Preparing a tree pads a layer-stacked weight once, as each layer
    alone would be padded; its layer views are views of that stack, and a
    prepared tree prepares to itself. Off the card nothing is padded."""
    stack = stack_qtensors([_qt(96, 40, 32, seed=i) for i in range(3)])
    tree = {"layers": {"o": {"w": stack}}}
    assert pd.pad_for_kernels(tree) is tree
    monkeypatch.setattr(pd, "on_card", lambda t: True)
    prepared = mm.prepare_decode_params(tree)
    whole = prepared["layers"]["o"]["w"]
    assert isinstance(whole, pd.PaddedWeight) and (whole.k, whole.n) == (96, 40)
    view = TT._layer_params(prepared["layers"], 1)["o"]["w"]
    assert view.w.data.data_ptr() == whole.w.data[1].data_ptr()
    assert torch.equal(view.w.data, pd.pad_qtensor(_qt(96, 40, 32, seed=1)).data)
    assert mm.prepare_decode_params(prepared) is prepared
    with mm.backend("s4"):
        s4_tree = mm.prepare_decode_params(prepared)
    assert isinstance(s4_tree["layers"]["o"]["w"].w, s4.S4Weight)


@pytest.mark.parametrize("m,n,gs,form", [(8, 64, 32, "v3"), (8, 40, 32, "v3"), (80, 40, 32, "v3"),
                                         (8, 40, 32, "s4"), (80, 40, 32, "a8"),
                                         (8, 64, 16, "v3"), (80, 40, 16, "s4")])
def test_b3_card_route(fake_launch, monkeypatch, m, n, gs, form):
    """B3's routes (v3, s4, a8) on the padded weight where B3 does not take
    the weight as it is (N % 16, group sizes not a multiple of 32): its
    form of M launches on it, and the result is bit for bit the plain
    version's on the weight as it is."""
    k = 256
    qt = _qt(k, n, gs, bits=8 if form == "a8" else 4, packed=form != "a8")
    if form == "a8":
        qt = dataclasses.replace(qt, data=(qt.data.to(torch.int16) - 128).to(torch.int8),
                                 zero=qt.zero - 128)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((m, k)).astype(np.float32))
    xq, s_x = qa.quantize_activations_s8(x)
    monkeypatch.setattr(pd, "on_card", lambda t: True)
    be = {"v3": "pallas", "s4": "s4", "a8": "a8"}[form]
    if form == "v3":
        monkeypatch.setenv("L3Q_QMM_V", "3")
    with mm.backend(be):
        w = mm.prepare_decode_params({"w": qt})["w"]
        launches.reset()
        got = mm.qmatmul(x, w, out_dtype=torch.float32)
    assert launches.COUNTS["pad"] == (n % 16 != 0 or gs % 32 != 0)
    assert isinstance(w, pd.PaddedWeight) == bool(launches.COUNTS["pad"])
    if form == "s4":
        ws = s4.prepare_s4(qt)
        ref = qa.a8_plain(xq, s_x, ws.data4, "s4", ws.scale, ws.zero8, gs, torch.float32)
    else:
        ref = qa.a8_plain(xq, s_x, qt.data, "u4" if form == "v3" else "s8", qt.scale, qt.zero,
                          gs, torch.float32)
    assert got.shape == (m, n)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    inner = w.w if isinstance(w, pd.PaddedWeight) else w
    data, layout, zero = ((inner.data4, "s4", inner.zero8) if form == "s4"
                          else (inner.data, "u4" if form == "v3" else "s8", inner.zero))
    xp = w.pad_x(x) if isinstance(w, pd.PaddedWeight) else x
    xpq, s_xp = qa.quantize_activations_s8(xp)
    args = (xpq, s_xp, data, layout, inner.scale, zero, inner.group_size, torch.float32)
    if m <= 64:
        qa.a8_gemv(*args, "B3.v3")
    else:
        qa.a8_gemm(*args)
    assert len(fake_launch) == 1


def test_entry_points_pad_unprepared_weights(monkeypatch):
    """`forward_logits`, `decode_step` and `decode_step_multi` on a tree
    nobody prepared pad its weights themselves (K = 96 here, which B2
    does not take): the logits of the weights as they are, the padded
    calls counted."""
    cfg = dataclasses.replace(tcfg.TINY_LLAMA, hidden_size=96, num_heads=6, num_kv_heads=2)
    fp = tparams.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                             device="cpu")
    qp = tparams.quantize_model_rtn(fp, cfg, tq.QuantSpec(n_bits=4, group_size=32), pack=True)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))

    def run():
        cache = TT.init_kv_cache(cfg, 2, 64, dtype=torch.float32, device="cpu")
        full = TT.forward_logits(qp, toks, cfg)
        pre, cache = TT.decode_step(qp, cache, toks, 0, cfg)
        step, _ = TT.decode_step_multi(qp, cache, toks[:, -1:], torch.tensor([9, 9]), cfg)
        return full, pre, step

    ref = run()
    launches.reset()
    monkeypatch.setattr(pd, "on_card", lambda t: True)
    got = run()
    assert launches.COUNTS["pad"] > 0
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * float(r.abs().max()))


# ----------------------------------------------------------- attention ----
CFG, TCFG = TINY_LLAMA, tcfg.TINY_LLAMA


@pytest.fixture(scope="module")
def tiny():
    params = init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return params, convert.params_from_numpy(to_numpy_tree(params), device="cpu")


def test_tiny_forward_at_128_takes_the_eager_route(tiny):
    """D = 16: B7 turns every layer away; the logits are JAX's eager ones."""
    jparams, tparams = tiny
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 128))
    ref = np.asarray(JT.forward_logits(jparams, jnp.asarray(toks), CFG))
    launches.reset()
    got = TT.forward_logits(tparams, torch.from_numpy(toks), TCFG).numpy()
    assert launches.COUNTS["B7.eager"] == CFG.num_layers
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _rep_cfgs(rep):
    """A llama of TINY_LLAMA's widths with `rep` query heads per K/V head."""
    kw = dict(num_heads=2 * rep, num_kv_heads=2, hidden_size=16 * 2 * rep)
    return dataclasses.replace(CFG, **kw), dataclasses.replace(TCFG, **kw)


@pytest.fixture(scope="module", params=[3, 6])
def rep_models(request):
    jcfg_, tcfg_ = _rep_cfgs(request.param)
    params = init_params(jcfg_, jax.random.PRNGKey(1), dtype=jnp.float32)
    return jcfg_, tcfg_, params, convert.params_from_numpy(to_numpy_tree(params), device="cpu")


@pytest.mark.parametrize("bits", [8, 4, False])
def test_rep_outside_the_decode_kernels_takes_the_eager_route(rep_models, bits):
    """rep 3 and 6 on the int8, int4 and fp caches: every single-token step
    is turned away from B5 / B6 to the eager path (counted), no window is
    taken, and the greedy tokens and logits are JAX's on its eager route."""
    jcfg_, tcfg_, jparams, tparams = rep_models
    prompt = np.random.default_rng(3).integers(0, jcfg_.vocab_size, (1, 9))
    jcache = JT.init_kv_cache(jcfg_, 1, 64, dtype=jnp.float32, quantized=bits)
    JT.set_decode_kernel(False)
    try:
        jl, jcache = JT.decode_step(jparams, jcache, jnp.asarray(prompt), 0, jcfg_)
        jt, _ = JT.greedy_generate(jparams, jcache, jnp.argmax(jl[:, -1], -1)[:, None], 9, 6,
                                   jcfg_)
    finally:
        JT.set_decode_kernel("auto")
    tcache = TT.init_kv_cache(tcfg_, 1, 64, dtype=torch.float32, quantized=bits, device="cpu")
    assert not TW.windowed_ok(tcfg_, tcache)
    tl, tcache = TT.decode_step(tparams, tcache, torch.from_numpy(prompt), 0, tcfg_)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jl)).max())
    launches.reset()
    tt, _ = TT.greedy_generate(tparams, tcache, tl[:, -1].argmax(-1)[:, None], 9, 6, tcfg_)
    assert tt.tolist() == np.asarray(jt).tolist()
    key = "B6.eager" if bits is False else "B5.eager"
    assert launches.COUNTS[key] == 6 * tcfg_.num_layers
