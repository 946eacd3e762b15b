"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without an NVIDIA GPU (the
kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

The plain versions themselves are held against the JAX package by the
other `tests/test_torch_*.py` files.
"""

import dataclasses

import numpy as np
import pytest
import torch

import llama3_quantization_tpu_torch as P
from llama3_quantization_tpu_torch.ops import decode_attention as da
from llama3_quantization_tpu_torch.ops import flash_attention as fa
from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq
from llama3_quantization_tpu_torch.ops import launches
from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa
from llama3_quantization_tpu_torch.ops import qmm_u8, w4_bd, w4_stream

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("bits,pack", [(4, True), (2, True), (8, False)])
@pytest.mark.parametrize("m", [1, 8, 65])
def test_qmatmul_kernels_match_plain(cuda_device, bits, pack, m):
    """B1 (M <= 64) and B2 (M > 64); fp32 output, so only the fp32
    summation order differs: atol 1e-4 * max|ref|."""
    rng = np.random.default_rng(bits + m)
    w = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32))
    qt = P.quantize_rtn(w.to(cuda_device), P.QuantSpec(n_bits=bits, group_size=64), pack=pack)
    x = torch.from_numpy(rng.standard_normal((m, 256)).astype(np.float32)).to(cuda_device)
    got = fq.fused_dequant_matmul(x, qt, out_dtype=torch.float32)
    plain = fq.qmm_gemv_plain if m <= fq.GEMV_MAX_M else fq.qmm_gemm_plain
    ref = plain(x, qt, torch.float32)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


#: M of the GEMV forms' checks (B1, B3 at M <= 64)
GEMV_MS = [1, 2, 5, 8, 16, 33, 64]


@pytest.mark.parametrize("bits,pack", [(4, True), (2, True), (8, False), (8, True)])
@pytest.mark.parametrize("gs", [32, 64, 128, None])
def test_b1_gemv_matches_plain(cuda_device, bits, pack, gs):
    """B1 (one launch, tensor-core dots) on 2-bit, 4-bit, int8 (8 bits
    unpacked) and uint8 (8 bits, one code a byte) codes at group sizes 32,
    64, 128 and K, on a ragged N (a part-filled column tile), at every M of
    the GEMV form: fp32 out within 1e-4 * max|ref| (the fp32 summation
    order), bf16 out within 1e-2."""
    k, n = 512, 4112
    rng = np.random.default_rng(bits + (gs or 0))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda_device)
    qt = P.quantize_rtn(w, P.QuantSpec(n_bits=bits, group_size=gs or k), pack=pack)
    for m in GEMV_MS:
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda_device)
        before = launches.snapshot()["B1"]
        got = fq.qmm_gemv(x, qt, torch.float32)
        assert launches.snapshot()["B1"] == before + 1
        ref = fq.qmm_gemv_plain(x, qt, torch.float32)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
        got16, ref16 = fq.qmm_gemv(x, qt, torch.bfloat16), fq.qmm_gemv_plain(x, qt, torch.bfloat16)
        torch.testing.assert_close(got16.float(), ref16.float(), rtol=0,
                                   atol=1e-2 * float(ref16.float().abs().max()))


@pytest.mark.parametrize("k,n,gs", [(4096, 1024, 128), (2048, 4096, 128), (1024, 4112, 1024)])
def test_b1_batch_invariant(cuda_device, k, n, gs):
    """B1's tiles, split and order follow (K, N, gs, f) alone: row i of an
    M = 8 and of an M = 64 call equals the M = 1 call on that row bit for
    bit (fp32 out)."""
    rng = np.random.default_rng(k + n)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda_device)
    qt = P.quantize_rtn(w, P.QuantSpec(n_bits=4, group_size=gs), pack=True)
    x = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32)).to(cuda_device)
    rows = torch.cat([fq.qmm_gemv(x[i:i + 1], qt, torch.float32) for i in range(64)])
    for m in (8, 64):
        assert torch.equal(fq.qmm_gemv(x[:m], qt, torch.float32), rows[:m])


def _b3_weight(kind, k, n, gs, rng, device):
    """(data, layout, scale, zero, group size) of one B3 weight form; gs
    None is one group of K rows (per column)."""
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(device)
    if kind == "s8_percol":
        qt = P.recode_head_s8(w)
        return qt.data, "s8", qt.scale, None, k
    if kind == "s4_head":
        s4 = P.prepare_s4(P.recode_head_s4(w))
        return s4.data4, "s4", s4.scale, s4.zero8, k
    bits = {"u4": 4, "u2": 2, "s4": 4, "s8": 8, "s8_nozp": 8, "u8": 8}[kind]
    spec = P.QuantSpec(n_bits=bits, group_size=gs, disable_zero_point=kind == "s8_nozp")
    qt = P.quantize_rtn(w, spec, pack=kind not in ("s8", "s8_nozp"))
    if kind == "s4":
        s4 = P.prepare_s4(qt)
        return s4.data4, "s4", s4.scale, s4.zero8, gs or k
    return qt.data, kind.split("_")[0], qt.scale, qt.zero, gs or k


#: every layout and zero mode: fp32 zero (u4, u2, s8, u8), int8 zero (s4,
#: s4 head), none (s8 without zero point, per-column s8)
B3_KINDS = ["u4", "u2", "s4", "s8", "s8_nozp", "u8", "s8_percol", "s4_head"]


@pytest.mark.parametrize("kind", B3_KINDS)
@pytest.mark.parametrize("m", [1, 3, 5, 8, 64, 65, 130, 200, 512])
@pytest.mark.parametrize("k,gs,n", [(256, 64, 192), (2304, 32, 192), (512, 128, 192),
                                    (256, None, 192), (512, 128, 28672), (256, None, 28672)])
def test_b3_forms_match_plain(cuda_device, kind, m, k, gs, n):
    """B3's GEMV form (M <= 64) and tiled form on every weight layout
    (unpacked uint8 8-bit codes included), zero-point kind and group size
    (32, 64, 128, K), N ragged (192) or the fused gate-up's 28672: exact
    s32 partials and the fp32 group terms folded in the plain version's
    order, so both forms' fp32 output equals the plain version bit for bit;
    bf16 output within 1e-2. 72 groups (K = 2304) fold over many stages,
    one group (gs = K) carries its s32 sums from stage to stage."""
    rng = np.random.default_rng(m)
    data, layout, scale, zero, g = _b3_weight(kind, k, n, gs, rng, cuda_device)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda_device)
    xq, s_x = qa.quantize_activations_s8(x)
    key = "B3.gemm" if m > qa.GEMV_MAX_M else "B3.s8"
    before = launches.snapshot()[key]
    got = qa.w_a8_matmul(x, data, layout, scale, zero, g, torch.float32, "B3.s8")
    assert launches.snapshot()[key] == before + 1
    ref = qa.a8_plain(xq, s_x, data, layout, scale, zero, g, torch.float32)
    assert torch.equal(got, ref), float((got - ref).abs().max())
    got16 = qa.w_a8_matmul(x.to(torch.bfloat16), data, layout, scale, zero, g, torch.bfloat16,
                           "B3.s8")
    xq16, s_x16 = qa.quantize_activations_s8(x.to(torch.bfloat16))
    ref16 = qa.a8_plain(xq16, s_x16, data, layout, scale, zero, g, torch.bfloat16)
    torch.testing.assert_close(got16.float(), ref16.float(), rtol=0,
                               atol=1e-2 * float(ref16.float().abs().max()))


@pytest.mark.parametrize("kind", B3_KINDS)
def test_b3_gemm_batch_invariant(cuda_device, kind):
    """The tiled form's tiles and stages follow the shapes, and every
    output's groups are summed in order in one block: rows 0..7 of an
    M = 128 call equal those of an M = 72 call bit for bit (fp32 and bf16
    out)."""
    rng = np.random.default_rng(11)
    k, n = 512, 28672
    w = _b3_weight(kind, k, n, 128, rng, cuda_device)
    x = torch.from_numpy(rng.standard_normal((128, k)).astype(np.float32)).to(cuda_device)
    xq, s_x = qa.quantize_activations_s8(x)
    for dt in (torch.float32, torch.bfloat16):
        full = qa.a8_gemm(xq, s_x, *w, dt)
        part = qa.a8_gemm(xq[:72].clone(), s_x[:72].clone(), *w, dt)
        assert torch.equal(full[:8], part[:8])


@pytest.mark.parametrize("m", [1, 65])
def test_v3_s4_a8_routes_count_their_forms(cuda_device, m):
    """`fused_dequant_matmul(version=3)`, `s4_matmul` and `a8_matmul` each
    launch their own B3 form (the tiled form above M = 64), on unpacked
    uint8 8-bit codes too."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32)).to(cuda_device)
    qt4 = P.quantize_rtn(w, P.QuantSpec(n_bits=4, group_size=64), pack=True)
    qt8 = P.recode_s8_percol(qt4)
    qtu8 = P.quantize_rtn(w, P.QuantSpec(n_bits=8, group_size=64), pack=True)  # uint8 codes
    x = torch.from_numpy(rng.standard_normal((m, 256)).astype(np.float32)).to(cuda_device)
    for key, call in (("B3.v3", lambda: fq.fused_dequant_matmul(x, qt4, version=3)),
                      ("B3.s4", lambda: P.s4_matmul(x, qt4)),
                      ("B3.s8", lambda: P.a8_matmul(x, qt8)),
                      ("B3.v3", lambda: fq.fused_dequant_matmul(x, qtu8, version=3)),
                      ("B3.s8", lambda: P.a8_matmul(x, qtu8))):
        key = "B3.gemm" if m > qa.GEMV_MAX_M else key
        before = launches.snapshot()[key]
        y = call()
        assert launches.snapshot()[key] == before + 1 and bool(y.isfinite().all())


@pytest.mark.parametrize("m", [8, 130])
def test_b2_three_bit_planes_match_plain(cuda_device, m):
    """B2 on 3-bit bit-plane weights (every M: JAX sends 3-bit to v1):
    fp32 output within 1e-4 * max|ref| of the plain version."""
    rng = np.random.default_rng(m)
    w = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32)).to(cuda_device)
    qt = P.quantize_rtn(w, P.QuantSpec(n_bits=3, group_size=64), pack=True)
    assert qt.packed and tuple(qt.data.shape) == (96, 128)
    x = torch.from_numpy(rng.standard_normal((m, 256)).astype(np.float32)).to(cuda_device)
    before = launches.snapshot()["B2.w3"]
    got = fq.fused_dequant_matmul(x, qt, out_dtype=torch.float32)
    assert launches.snapshot()["B2.w3"] == before + 1
    ref = fq.qmm_gemm_plain(x, qt, torch.float32)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


#: (bits, packed, group size) of the B2 layouts: 4- and 2-bit group-local
#: nibbles, int8 and uint8 codes, 3-bit bit planes
B2_LAYOUTS = [(4, True, 64), (4, True, 32), (2, True, 64), (8, False, 64), (8, True, 64),
              (3, True, 64), (3, True, 32)]


@pytest.mark.parametrize("bits,pack,gs", B2_LAYOUTS)
@pytest.mark.parametrize("m", [65, 200])
def test_b2_ragged_m_matches_plain(cuda_device, bits, pack, gs, m):
    """B2 with a partly filled 128-row tile (M = 65, 200) and a partly
    filled 128-column tile (N = 144), every layout: fp32 out within 1e-4 *
    max|ref| (fp32 order), bf16 within 1e-2."""
    rng = np.random.default_rng(bits * 100 + m + gs)
    w = torch.from_numpy(rng.standard_normal((256, 144)).astype(np.float32)).to(cuda_device)
    qt = P.quantize_rtn(w, P.QuantSpec(n_bits=bits, group_size=gs), pack=pack)
    x = torch.from_numpy(rng.standard_normal((m, 256)).astype(np.float32)).to(cuda_device)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        got, ref = fq.qmm_gemm(x, qt, dt), fq.qmm_gemm_plain(x, qt, dt)
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=tol * float(ref.float().abs().max()))


@pytest.mark.parametrize("bits,gs", [(4, 32), (4, 128), (3, 64)])
def test_b2_batch_invariant(cuda_device, bits, gs):
    """The K split follows (K, N) alone: rows 0..7 of an M = 128 call equal
    the same rows of an M = 72 call bit for bit (N = 128: a split of K)."""
    rng = np.random.default_rng(bits + gs)
    w = torch.from_numpy(rng.standard_normal((512, 128)).astype(np.float32)).to(cuda_device)
    qt = P.quantize_rtn(w, P.QuantSpec(n_bits=bits, group_size=gs), pack=True)
    assert fq.b2_ksplit(512, 128) > 1
    x = torch.from_numpy(rng.standard_normal((128, 512)).astype(np.float32)).to(cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(fq.qmm_gemm(x, qt, dt)[:8], fq.qmm_gemm(x[:72].clone(), qt, dt)[:8])


def test_b2_rejects_what_it_cannot_take(cuda_device):
    """No fallback: K % 64 != 0 or N % 16 != 0 raise."""
    spec = P.QuantSpec(n_bits=4, group_size=32)
    qt = P.quantize_rtn(torch.randn((96, 64), device=cuda_device), spec, pack=True)
    with pytest.raises(ValueError):
        fq.qmm_gemm(torch.zeros((80, 96), device=cuda_device), qt, torch.float32)
    qt = P.quantize_rtn(torch.randn((128, 40), device=cuda_device), spec, pack=True)
    with pytest.raises(ValueError):
        fq.qmm_gemm(torch.zeros((80, 128), device=cuda_device), qt, torch.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("b,t", [(8, 512), (1, 2048)])
def test_xla_route_on_card_matches_cpu(cuda_device, b, t, seed):
    """The codes-direct int8 route (stacked, with m/l) on the card against
    the same call on CPU copies: exact s32 dots, so m within 1e-6 * |m|, l
    within 1e-5 * l (fp32 order, an ulp of exp). That ulp can move a
    requantized probability code by one step: codes at most one step
    apart, at most 4 in a row, and o within 1e-5 * max|o| beyond the
    flipped codes' exact share |s32 dot of the code differences with v| *
    ps / l."""
    gen = torch.Generator(device=cuda_device).manual_seed(b + t + 1000 * seed)
    g, rep, d = 8, 4, 128
    kv = torch.randn((2, 2, b, g, t, d), generator=gen, device=cuda_device)
    kq, ks = P.kv_quantize(kv[0])
    vq, vs = P.kv_quantize(kv[1])
    q = torch.randn((b, 1, g * rep, d), generator=gen, device=cuda_device).to(torch.bfloat16)
    mask = torch.zeros((b, t), device=cuda_device)
    mask[:, t - t // 8:] = da.NEG
    mask[0, : t // 3] = -3.0
    if b > 1:
        mask[1] = da.NEG
    args = (q, kq, ks, vq, vs, mask)
    go, gm, gl = da.xla_decode_gqa_s8_stacked(*args, 1, torch.float32, return_stats=True)
    ro, rm, rl = da.xla_decode_gqa_s8_stacked(*(a.cpu() for a in args), 1, torch.float32,
                                              return_stats=True)
    sides = [da.xla_s8_probs(x[0].reshape(b, g, rep, d).float(), x[1][1],
                             x[2][1].reshape(b, g, t), x[4][1].reshape(b, g, t), x[5].float())
             for x in (args, [a.cpu() for a in args])]
    diff = sides[0][0].cpu().int() - sides[1][0].int()
    assert int(diff.abs().max()) <= 1 and int(diff.ne(0).sum(dim=-1).max()) <= 4
    _, ps, _, l = sides[1]
    dpv = da.s8_dot_long(diff.to(torch.int8), vq[1].cpu()).float()
    slack = (dpv * ps / l.clamp(min=1e-30)[..., None]).abs().reshape(ro.shape)
    excess = (go.cpu() - ro).abs() - slack
    assert float(excess.max()) <= 1e-5 * float(ro.abs().max())
    torch.testing.assert_close(gm.cpu(), rm, rtol=1e-6, atol=0)
    torch.testing.assert_close(gl.cpu(), rl, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t", [(1, 512), (1, 1024), (1, 2048), (1, 4096), (8, 512),
                                 (8, 2048)])
def test_fp_decode_split_matches_plain(cuda_device, dtype, b, t):
    """The split B6 at the paths' shapes (G = 8, rep = 4, D = 128), one to
    four T blocks, with (B = 8) an all-masked row and a row valid only in
    its first T block: within 1e-5 * max|ref| (fp32 cache) or 1e-2 (bf16);
    the split algorithm's plain twin gives the plain version's rounded p
    bit for bit on the card."""
    gen = torch.Generator(device=cuda_device).manual_seed(b * 10 + t)
    g, rep, d = 8, 4, 128
    bt = 1024 if t % 1024 == 0 else 512
    k = torch.randn((b, g, t, d), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((b, g, t, d), generator=gen, device=cuda_device).to(dtype)
    q = torch.randn((b, 1, g * rep, d), generator=gen, device=cuda_device).to(dtype)
    mask = torch.zeros((b, t), device=cuda_device)
    mask[:, t - t // 8:] = da.NEG
    if b > 1:
        mask[0] = da.NEG
        mask[1, min(bt, t - t // 8):] = da.NEG
    got = da.flash_decode_gqa(q, k, v, mask, bt)
    ref, p_ref = da.decode_fp_plain(q, k, v, mask, bt, return_p=True)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=tol * float(ref.float().abs().max()))
    _, p_twin = da.decode_fp_split_plain(q, k, v, mask, bt, return_p=True)
    assert torch.equal(p_twin, p_ref)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain(cuda_device, out_dtype):
    """B5 over two T blocks with masked slots. 2e-3 * max|out| in fp32 (a
    1-ulp exp difference can move one probability code), 1e-2 in bf16."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    L, B, G, REP, D, BT = 2, 2, 2, 4, 64, 32
    kq, ks = P.kv_quantize(torch.randn((L, B, G, 2 * BT, D), generator=gen, device=cuda_device))
    vq, vs = P.kv_quantize(torch.randn((L, B, G, 2 * BT, D), generator=gen, device=cuda_device))
    q = torch.randn((B, 1, G * REP, D), generator=gen, device=cuda_device)
    mask = torch.zeros((B, 2 * BT), device=cuda_device)
    mask[0, -11:] = da.NEG
    mask[1, :5] = da.NEG
    got = da.flash_decode_gqa_s8_stacked(q, kq, ks, vq, vs, mask, 1, out_dtype, BT)
    ref = da.decode_s8_plain(q, kq[1], ks[1], vq[1], vs[1], mask, out_dtype, BT)
    tol = 2e-3 if out_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=tol * float(ref.float().abs().max()))


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("stats", [False, True])
def test_decode_kernel_forms_match_plain(cuda_device, int4, stats):
    """B5 on the int8 and int4 caches, with and without the m/l statistics,
    fp32 out, two T blocks, one all-masked row. o within 2e-3 * max|o|, m
    within 1e-6 * |m|, l within 1e-5 * l; the all-masked row ends at
    m = -1e30, l = T."""
    gen = torch.Generator(device=cuda_device).manual_seed(int4 + 2 * stats)
    L, B, G, REP, D, BT = 2, 3, 2, 4, 64, 32
    quantize = P.kv4_quantize if int4 else P.kv_quantize
    kq, ks = quantize(torch.randn((L, B, G, 2 * BT, D), generator=gen, device=cuda_device))
    vq, vs = quantize(torch.randn((L, B, G, 2 * BT, D), generator=gen, device=cuda_device))
    q = torch.randn((B, 1, G * REP, D), generator=gen, device=cuda_device).to(torch.bfloat16)
    mask = torch.zeros((B, 2 * BT), device=cuda_device)
    mask[0, -11:] = da.NEG
    mask[2, :] = da.NEG
    key = da.launch_key(int4, stats)
    before = launches.snapshot()[key]
    got = da.flash_decode_gqa_s8_stacked(q, kq, ks, vq, vs, mask, 1, torch.float32, BT, stats)
    ref = da.decode_s8_plain(q, kq[1], ks[1], vq[1], vs[1], mask, torch.float32, BT, stats)
    assert launches.snapshot()[key] == before + 1
    if not stats:
        got, ref = (got,), (ref,)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=2e-3 * float(ref[0].abs().max()))
    if stats:
        torch.testing.assert_close(got[1], ref[1], rtol=1e-6, atol=0)
        torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=0)
        assert bool((got[1][2] == da.NEG).all()) and bool((got[2][2] == 2 * BT).all())


#: (T block, D) pairs that give every cluster the split plan can take:
#: S = 8 (64-token slices), 4, 2, 1 (a 16-token block and a 24-token one),
#: 8 again (16-token slices), and 1 on an 18-token block (its scale slices,
#: not whole 16-byte rows, are loaded without bulk copies)
S8_SPLITS = [(512, 128), (64, 64), (32, 128), (16, 64), (24, 128), (128, 64), (18, 64)]


def _s8_case(gen, b, t, d, int4, rep=4, g=2):
    quantize = P.kv4_quantize if int4 else P.kv_quantize
    kq, ks = quantize(torch.randn((b, g, t, d), generator=gen, device=gen.device))
    vq, vs = quantize(torch.randn((b, g, t, d), generator=gen, device=gen.device))
    q = torch.randn((b, 1, g * rep, d), generator=gen, device=gen.device).to(torch.bfloat16)
    return q, kq, ks, vq, vs


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("bt,d", S8_SPLITS)
def test_decode_kernel_split_plans_match_plain(cuda_device, int4, bt, d):
    """B5 with stats at every cluster size of the plan, two T blocks, B=3:
    row 0 masked in its tail, row 1 all masked, row 2 masked after its first
    T block. o within 2e-3 * max|o| of `decode_s8_plain`, m within 1e-6 *
    |m|, l within 1e-5 * l, and the split algorithm in PyTorch likewise."""
    gen = torch.Generator(device=cuda_device).manual_seed(bt + d + int4)
    t = 2 * bt
    args = (*_s8_case(gen, 3, t, d, int4), torch.zeros((3, t), device=cuda_device))
    mask = args[-1]
    mask[0, -5:] = da.NEG
    mask[1] = da.NEG
    mask[2, bt:] = da.NEG
    got = da.decode_s8(*args, torch.float32, bt, True)
    for plain in (da.decode_s8_plain, da.decode_s8_split_plain):
        ref = plain(*args, torch.float32, bt, True)
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=2e-3 * float(ref[0].abs().max()))
        torch.testing.assert_close(got[1], ref[1], rtol=1e-6, atol=0)
        torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=0)
    assert bool((got[1][1] == da.NEG).all()) and bool((got[2][1] == t).all())


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("t", [512, 2048])
def test_decode_kernel_batch_invariant(cuda_device, int4, t):
    """Row b of a B=8 call equals, bit for bit in o, m and l, a B=1 call on
    that row (G=8, rep=4, D=128, the paths' T blocks): the split plan does
    not depend on B."""
    gen = torch.Generator(device=cuda_device).manual_seed(t + int4)
    bt = 1024 if t % 1024 == 0 else 512
    q, kq, ks, vq, vs = _s8_case(gen, 8, t, 128, int4, g=8)
    mask = torch.zeros((8, t), device=cuda_device)
    mask[:, t - t // 8:] = da.NEG
    mask[0] = da.NEG
    mask[3, 100:] = da.NEG
    full = da.decode_s8(q, kq, ks, vq, vs, mask, torch.float32, bt, True)
    for b in range(8):
        one = da.decode_s8(*(x[b : b + 1].contiguous() for x in (q, kq, ks, vq, vs, mask)),
                           torch.float32, bt, True)
        for x, y in zip(full, one):
            assert torch.equal(x[b : b + 1], y)


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("stats", [False, True])
def test_decode_kernel_deterministic(cuda_device, int4, stats):
    """Two calls on the same inputs are bit-equal (no atomics)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7 + int4 + 2 * stats)
    q, kq, ks, vq, vs = _s8_case(gen, 8, 2048, 128, int4, g=8)
    mask = torch.zeros((8, 2048), device=cuda_device)
    mask[:, 1900:] = da.NEG
    a = da.decode_s8(q, kq, ks, vq, vs, mask, torch.bfloat16, 1024, stats)
    b = da.decode_s8(q, kq, ks, vq, vs, mask, torch.bfloat16, 1024, stats)
    for x, y in zip(a if stats else (a,), b if stats else (b,)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 136])
def test_fp_decode_kernel_matches_plain(cuda_device, dtype, rep, d):
    """B6 on layer 1 of a stacked fp cache, two T blocks, masked slots and
    one all-masked row (the mean of v). fp32 cache within 1e-5 * max|ref|
    (fp32 summation order only); bf16 within 1e-2 (p rounded to bf16 after
    exp may differ by one ulp). D = 136 leaves threads of the PV pass idle."""
    gen = torch.Generator(device=cuda_device).manual_seed(rep + d)
    L, B, G, BT = 2, 3, 2, 32
    k = torch.randn((L, B, G, 2 * BT, d), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((L, B, G, 2 * BT, d), generator=gen, device=cuda_device).to(dtype)
    q = torch.randn((B, 1, G * rep, d), generator=gen, device=cuda_device).to(dtype)
    mask = torch.zeros((B, 2 * BT), device=cuda_device)
    mask[0, -11:] = da.NEG
    mask[2, :] = da.NEG
    key = da.fp_launch_key(dtype)
    before = launches.snapshot()[key]
    got = da.flash_decode_gqa_stacked(q, k, v, mask, 1, BT)
    assert launches.snapshot()[key] == before + 1 and got.dtype == dtype
    ref = da.decode_fp_plain(q, k[1], v[1], mask, BT)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=tol * float(ref.float().abs().max()))
    mean_v = v[1, 2].float().mean(dim=1).repeat_interleave(rep, dim=0)
    torch.testing.assert_close(got[2, 0].float(), mean_v, rtol=0, atol=1e-2)


def test_fp_decode_kernel_rejects_what_it_cannot_take(cuda_device):
    """No fallback: q in another dtype than the cache, or D % 8 != 0, raise."""
    k = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16, device=cuda_device)
    mask = torch.zeros((1, 64), device=cuda_device)
    with pytest.raises(ValueError):
        da.flash_decode_gqa(torch.zeros((1, 1, 4, 64), device=cuda_device), k, k, mask, 32)
    k12 = torch.zeros((1, 2, 64, 12), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        da.flash_decode_gqa(torch.zeros((1, 1, 4, 12), dtype=torch.bfloat16, device=cuda_device),
                            k12, k12, mask, 32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tiny_fp_cache_on_card_matches_cpu(cuda_device, dtype):
    """TINY_LLAMA W4 g32 (fp32 activations) on an fp cache: prefill, a
    single-token step (stacked B6) and a per-row step (B6 per layer) track
    the CPU's logits within 1e-2 of their scale; the eager route under a
    KV4 hook launches no B6."""
    cfg = P.TINY_LLAMA
    params = P.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                           device="cpu")
    params = P.quantize_model_rtn(params, cfg, P.QuantSpec(n_bits=4, group_size=32), pack=True)
    toks = torch.randint(0, cfg.vocab_size, (2, 80), generator=torch.Generator().manual_seed(1))

    def run(device):
        p = _to(params, device)
        cache = P.init_kv_cache(cfg, 2, 128, dtype=dtype, device=device)
        pre, cache = P.decode_step(p, cache, toks.to(device), 0, cfg)
        step, _ = P.decode_step(p, cache, toks[:, -1:].to(device), 80, cfg)
        multi, _ = P.decode_step_multi(p, cache, toks[:, -1:].to(device),
                                       torch.tensor([81, 60], device=device), cfg)
        return pre.cpu(), step.cpu(), multi.cpu()

    cpu = run("cpu")
    launches.reset()
    gpu = run(cuda_device)
    assert launches.snapshot()[da.fp_launch_key(dtype)] == 2 * cfg.num_layers
    # 1e-2: B1/B2 round their inputs to bf16, and an input that lands one
    # fp32 ulp apart on the card rounds to the next bf16 value (the fp32
    # cache's prefill, which runs no B6, reads 2.5e-3)
    for got, ref in zip(gpu, cpu):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-2 * float(ref.abs().max()))
    rq = P.RuntimeQuantConfig(k=P.QuantSpec(n_bits=4), v=P.QuantSpec(n_bits=4))
    cache = P.init_kv_cache(cfg, 2, 128, dtype=dtype, device=cuda_device)
    p = _to(params, cuda_device)
    launches.reset()
    _, cache = P.decode_step(p, cache, toks.to(cuda_device), 0, cfg, rq)
    out, _ = P.greedy_generate(p, cache, toks[:, -1:].to(cuda_device), 80, 3, cfg, rq)
    assert out.shape == (2, 3) and launches.snapshot()[da.fp_launch_key(dtype)] == 0


def test_tiny_engine_on_card_matches_cpu(cuda_device):
    """TINY_LLAMA W4 g32 (fp32 activations) served by `run_pipelined` on the
    int8 and int4 caches: the card's streams equal the CPU's, through B1,
    B2 and B5 with stats."""
    cfg = P.TINY_LLAMA
    params = P.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                           device="cpu")
    params = P.quantize_model_rtn(params, cfg, P.QuantSpec(n_bits=4, group_size=32), pack=True)
    reqs = [([1, 2, 3, 4], 9), ([9, 8, 7], 5), ([5] * 20, 7), ([2, 4, 6], 12)]

    def run(device, bits):
        # 4 slots x bucket 32 = 128 prefill rows: B2
        eng = P.ServingEngine(_to(params, device), cfg, max_slots=4, max_len=64,
                              quantized_cache=bits, schedule="ljf", device=device)
        for p, n in reqs:
            eng.submit(p, n)
        eng.run_pipelined(4)
        return {rid: r.generated for rid, r in eng.requests.items()}

    for bits in (8, 4):
        cpu = run("cpu", bits)
        launches.reset()
        gpu = run(cuda_device, bits)
        counts = launches.snapshot()
        assert counts["B1"] > 0 and counts["B2"] > 0 and counts[da.launch_key(bits == 4, True)] > 0
        assert gpu == cpu


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_window_makes_no_device_sync(cuda_device, bits):
    """A window of the windowed decode, its merge included, enqueues its
    work without waiting for the card: PyTorch's sync debug mode raises on
    the synchronizing calls it detects (a prototype that, by its own
    warning, does not detect all of them)."""
    cfg = P.TINY_LLAMA
    params = P.init_quantized_params(cfg, P.QuantSpec(n_bits=4, group_size=32), device=cuda_device,
                                     dtype=torch.float32)
    cache = P.init_kv_cache(cfg, 2, 64, quantized=bits, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda_device)
    _, cache = P.decode_step(params, cache, toks, 0, cfg)
    pos0 = torch.tensor([8, 5], device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = P.decode_window(params, cache, toks[:, -1:], pos0, 6, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tuple(out.shape) == (2, 6)


@pytest.mark.parametrize("s", [128, 160, 200, 1000, 2048])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,rep", [(1, 2), (2, 1), (2, 4), (2, 8)])
def test_flash_kernel_matches_plain(cuda_device, s, d, b, rep):
    """B7, bf16, G = 2 groups of `rep` q heads, ragged and whole tiles of
    64 and 128 rows: every output row (one position of one head) within
    2e-2 * its own max|ref| (the kernel rounds unnormalized probabilities
    to bf16 for PV, the plain version normalized ones). Late rows average
    many keys and are small, so the limit is taken row by row."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + d + rep)
    q = torch.randn((b, s, 2 * rep, d), generator=gen, device=cuda_device).to(torch.bfloat16)
    k = torch.randn((b, s, 2, d), generator=gen, device=cuda_device).to(torch.bfloat16)
    v = torch.randn((b, s, 2, d), generator=gen, device=cuda_device).to(torch.bfloat16)
    before = launches.snapshot()["B7"]
    got = fa.flash_attention(q, k, v).float()
    assert launches.snapshot()["B7"] == before + 1
    ref = fa.attention_plain(q, k, v).float()
    row_err, row_max = (got - ref).abs().amax(dim=-1), ref.abs().amax(dim=-1)
    assert bool((row_err <= 2e-2 * row_max).all()), float((row_err / row_max).max())


@pytest.mark.parametrize("b,s,h,g,d", [(1, 128, 8, 2, 128), (2, 320, 6, 2, 64)])
def test_flash_backward_kernels_match_plain(cuda_device, b, s, h, g, d):
    """B7.stats, B7.dkv and B7.dq, bf16 (rep 4 on whole tiles; rep 3 on a
    ragged S): o row by row within 2e-2 of its max|ref|, m within 1e-6 *
    max(1, |m|), l within 1e-5 * l; dq, dk, dv (fed the kernel's own o, m,
    l) row by row within 2e-2 of the larger of its max|ref| and its largest
    single term (`backward_terms`); each launch counted once; two calls
    bit-equal."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + d)
    q, do = (torch.randn((b, s, h, d), generator=gen, device=cuda_device).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((b, s, g, d), generator=gen, device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    launches.reset()
    o, m, l = fa.flash_attention_stats_cuda(q, k, v)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, do, m, l)
    counts = launches.snapshot()
    assert (counts["B7.stats"], counts["B7.dkv"], counts["B7.dq"], counts["B7"]) == (1, 1, 1, 0)
    ro, rm, rl = fa.attention_stats_plain(q, k, v)
    row_err, row_max = (o.float() - ro.float()).abs().amax(-1), ro.float().abs().amax(-1)
    assert bool((row_err <= 2e-2 * row_max).all())
    assert bool(((m - rm).abs() <= 1e-6 * rm.abs().clamp(min=1)).all())
    assert bool(((l - rl).abs() <= 1e-5 * rl).all())
    refs = fa.flash_attention_bwd_plain(q, k, v, o, do, m, l)
    for got, ref, term in zip(grads, refs, fa.backward_terms(q, k, v, o, do, m, l)):
        row_err = (got.float() - ref.float()).abs().amax(-1)
        scale = torch.maximum(ref.float().abs().amax(-1), term)
        assert bool((row_err <= 2e-2 * scale).all()), float((row_err / scale).max())
    again = fa.flash_attention_bwd_cuda(q, k, v, o, do, m, l)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


def test_omniquant_step_through_the_kernels_matches_eager(cuda_device):
    """One OmniQuant LWC step (W4 g32, fp32 weights, S = 256, batch 2) on a
    llama of head dim 64: through B7.stats, B7.dkv and B7.dq (one launch
    each) against the same step under `set_flash(False)` (the eager
    attention under autograd): loss within 1e-3 relative, LWC gradients
    within 2e-2 in ||diff|| / ||ref|| (B7 rounds q, k, v, p and ds to
    bf16)."""
    from llama3_quantization_tpu_torch.models import transformer as TT
    from llama3_quantization_tpu_torch.quant import calibration as TC
    from llama3_quantization_tpu_torch.quant import omniquant as TO

    cfg = dataclasses.replace(P.TINY_LLAMA, hidden_size=128, num_heads=2, num_kv_heads=1)
    params = _to(P.init_params(cfg, torch.Generator().manual_seed(3), dtype=torch.float32,
                               device="cpu"), cuda_device)
    p_l = TC._layer_slice(params["layers"], 0)
    ocfg = TO.OmniConfig(wspec=P.QuantSpec(n_bits=4, group_size=32, lwc=True))
    aux = {"lwc": TO.init_layer_lwc(p_l, cfg, ocfg.wspec)}
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    h, target = (torch.randn((2, 256, 128), generator=gen, device=cuda_device) for _ in range(2))
    cos_sin = TT.rope_cos_sin(torch.arange(256, device=cuda_device)[None], 64, cfg.rope_theta,
                              torch.float32, cfg.rope_scaling_)
    mask = TT.causal_mask(256, device=cuda_device)
    step = lambda: TO.omni_loss_and_grads(aux, p_l, h, target, target, cfg, ocfg,  # noqa: E731
                                          TT.NO_QUANT, cos_sin, mask)
    launches.reset()
    loss, grads = step()
    counts = launches.snapshot()
    assert (counts["B7.stats"], counts["B7.dkv"], counts["B7.dq"]) == (1, 1, 1)
    TT.set_flash(False)
    try:
        rloss, rgrads = step()
    finally:
        TT.set_flash("auto")
    assert abs(float(loss) - float(rloss)) <= 1e-3 * abs(float(rloss))
    got = torch.cat([x.flatten() for x in TO._aux_leaves(grads)])
    ref = torch.cat([x.flatten() for x in TO._aux_leaves(rgrads)])
    assert float((got - ref).norm() / ref.norm()) <= 2e-2


def test_tiny_model_on_card_matches_cpu(cuda_device):
    """TINY_LLAMA W4 g32 (fp32 activations): the card's prefill and decode
    logits track the CPU's (plain versions) and every kernel but B7 (S < 128)
    launched."""
    cfg = P.TINY_LLAMA
    params = P.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                           device="cpu")
    params = P.quantize_model_rtn(params, cfg, P.QuantSpec(n_bits=4, group_size=32), pack=True)
    toks = torch.randint(0, cfg.vocab_size, (2, 80), generator=torch.Generator().manual_seed(1))

    def run(device):
        p = _to(params, device)
        cache = P.init_kv_cache(cfg, 2, 128, quantized=8, device=device)
        pre, cache = P.decode_step(p, cache, toks.to(device), 0, cfg)
        step, _ = P.decode_step(p, cache, toks[:, -1:].to(device), 80, cfg)
        return pre.cpu(), step.cpu()

    cpu_pre, cpu_step = run("cpu")
    launches.reset()
    gpu_pre, gpu_step = run(cuda_device)
    counts = launches.snapshot()
    assert counts["B1"] > 0 and counts["B2"] > 0 and counts["B5"] > 0
    for got, ref in ((gpu_pre, cpu_pre), (gpu_step, cpu_step)):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-3 * float(ref.abs().max()))


def _ints(rng, lo, hi, shape, device):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8)).to(device)


@pytest.mark.parametrize("form", ["w4", "tiled", 1, 2, 4, 8])
def test_b8_forms_equal_plain(cuda_device, form):
    """B8 streams every byte and sums one row per block: exactly its plain
    version (small integers in f32), on rows split over many blocks of
    threads and a ragged last one."""
    rng = np.random.default_rng(8)
    k, n, bk, bn = 3072, 1536, 512, 256
    if form == "w4":
        w = _ints(rng, -128, 128, (k // 2, n), cuda_device)
        key, got, ref = "B8.w4", lambda: w4_stream.w4_dma(w, bk), w4_stream.w4_dma_plain(w, bk)
    elif form == "tiled":
        w = _ints(rng, -128, 128, (k // bk, n // bn, bk // 2, bn), cuda_device)
        key, got, ref = "B8.tiled", lambda: w4_stream.w4_dma_tiled(w), w4_stream.w4_dma_tiled_plain(w)
    else:
        x = _ints(rng, -128, 128, (5000, 1024), cuda_device)
        key, got = "B8.depth", lambda: w4_stream.dma_depth(x, 64, form)
        ref = w4_stream.dma_depth_plain(x, 64)
    before = launches.snapshot()[key]
    out = got()
    assert launches.snapshot()[key] == before + 1
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("form", ["v4", "tiled", "dot4", "noscale", "cast8", 1, 2, 4])
@pytest.mark.parametrize("bk", [256, 2048])
def test_b9_forms_match_plain(cuda_device, form, bk):
    """B9 against its plain version: exact s32 partials and the same fp32
    epilogue order, so bit for bit (multi-stream: S = 1, 2, 4); a second
    call gives the same bits."""
    rng = np.random.default_rng(9)
    k, n, g = 4096, 384, 4096 // 128
    w = _ints(rng, -128, 128, (k // 2, n), cuda_device)
    scale = torch.from_numpy((rng.random((g, n)) + 0.5).astype(np.float32) * 0.01).to(cuda_device)
    xh, xl = _ints(rng, -8, 8, (1, k), cuda_device), _ints(rng, -8, 8, (1, k), cuda_device)
    bd2, bd1 = _ints(rng, -8, 8, (2 * g, k), cuda_device), _ints(rng, -120, 120, (g, k), cuda_device)
    if form == "v4":
        key, call = "B9.v4", lambda: w4_bd.w4_bd(xh, xl, scale, w, bk)
        ref = w4_bd.bd_plain("v4", (xh, xl), (w,), scale, bk)
    elif form == "tiled":
        bn = 128
        wt = w.reshape(k // bk, bk // 2, n // bn, bn).permute(0, 2, 1, 3).contiguous()
        key, call = "B9.tiled", lambda: w4_bd.w4_bd(xh, xl, scale, wt, bk, tiled=True)
        ref = w4_bd.bd_plain("v4", (xh, xl), (w,), scale, bk)
    elif form == "dot4":
        key, call = "B9.dot4", lambda: w4_bd.w4_dot4(bd2, scale, w, bk)
        ref = w4_bd.bd_plain("dot4", (bd2[: 2 * (bk // 128)],), (w,), scale, bk)
    elif form == "noscale":
        key, call = "B9.noscale", lambda: w4_bd.w4_noscale(bd2, w, bk)
        ref = w4_bd.bd_plain("noscale", (bd2[: 2 * (bk // 128)],), (w,), None, bk)
    elif form == "cast8":
        key, call = "B9.cast8", lambda: w4_bd.w4_cast8(bd1, scale, w, bk)
        ref = w4_bd.bd_plain("cast8", (bd1[: bk // 128],), (w,), scale, bk)
    else:
        s = form
        ws = [_ints(rng, -128, 128, (k // 2 // s, n), cuda_device) for _ in range(s)]
        bds = [_ints(rng, -8, 8, (2 * (bk // 128) // s, k // s), cuda_device) for _ in range(s)]
        key, call = "B9.multi", lambda: w4_bd.w4_multi(bds, ws, bk)
        ref = w4_bd.bd_plain("multi", bds, ws, None, bk)
    before = launches.snapshot()[key]
    got = call()
    assert launches.snapshot()[key] == before + 1
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(call(), got, rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["dot2", "cat", "bf16"])
@pytest.mark.parametrize("k,n", [(1024, 448), (384, 448), (4096, 14336)])
def test_b10_variants_match_plain(cuda_device, variant, k, n):
    """B10 on RTN W4 g128 codes, at a small shape, a ragged K (three groups,
    fewer than the ring holds) and the unpack default: dot2 and cat bit for
    bit equal to the plain version, which is B3's `a8_plain` (its integers
    and epilogue order), bf16 within 1e-2 * max|ref|; a second call gives
    the same bits."""
    rng = np.random.default_rng(10)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda_device)
    qt = P.quantize_rtn(w, P.QuantSpec(n_bits=4, group_size=128), pack=True)
    xq = _ints(rng, -127, 128, (8, k), cuda_device)
    before = launches.snapshot()[f"B10.{variant}"]
    got = qmm_u8.u8_qmm(xq, qt.data, qt.scale, qt.zero, variant)
    assert launches.snapshot()[f"B10.{variant}"] == before + 1
    ref = qmm_u8.u8_qmm_plain(xq, qt.data, qt.scale, qt.zero, variant)
    tol = 1e-2 * float(ref.abs().max()) if variant == "bf16" else 0
    torch.testing.assert_close(got, ref, rtol=0, atol=tol)
    if variant != "bf16":
        ones = torch.ones((8, 1), dtype=torch.float32, device=cuda_device)
        b3 = qa.a8_plain(xq, ones, qt.data, "u4", qt.scale, qt.zero, 128, torch.float32)
        torch.testing.assert_close(got, b3, rtol=0, atol=0)
    torch.testing.assert_close(qmm_u8.u8_qmm(xq, qt.data, qt.scale, qt.zero, variant), got,
                               rtol=0, atol=0)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, P.QuantizedTensor):
        return dataclasses.replace(
            tree, data=tree.data.to(device), scale=tree.scale.to(device),
            zero=None if tree.zero is None else tree.zero.to(device))
    return tree.to(device)


# ---------------------------------------------------------------- C2 ----
# Shapes the JAX package computes but a kernel does not take: each takes
# the route its kernel's predicate chooses (the eager attention, or the
# weight padded to the kernel's tiles) instead of raising on the card.

def _rep_cfg(rep):
    """A llama of TINY_LLAMA's widths with `rep` query heads per K/V head."""
    return dataclasses.replace(P.TINY_LLAMA, num_heads=2 * rep, num_kv_heads=2,
                               hidden_size=16 * 2 * rep)


def _rtn_params(cfg, seed=0):
    params = P.init_params(cfg, torch.Generator().manual_seed(seed), dtype=torch.float32,
                           device="cpu")
    return P.quantize_model_rtn(params, cfg, P.QuantSpec(n_bits=4, group_size=32), pack=True)


def test_c2_tiny_forward_at_128(cuda_device):
    """TINY_LLAMA (D = 16, which B7 does not take) at S = 128: the eager
    attention on every layer, logits within 1e-2 of their scale of the CPU
    run (B1/B2's bf16 inputs, as above)."""
    cfg = P.TINY_LLAMA
    params = _rtn_params(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=torch.Generator().manual_seed(1))
    ref = P.forward_logits(params, toks, cfg)
    launches.reset()
    got = P.forward_logits(_to(params, cuda_device), toks.to(cuda_device), cfg).cpu()
    counts = launches.snapshot()
    assert counts["B7"] == 0 and counts["B7.eager"] == cfg.num_layers and counts["B2"] > 0
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-2 * float(ref.abs().max()))


@pytest.mark.parametrize("rep", [3, 6])
@pytest.mark.parametrize("bits", [8, 4, False])
def test_c2_rep_outside_the_decode_kernels(cuda_device, rep, bits):
    """rep 3 and 6 (B4/B5 and B6 pad them to their rep-4 and rep-8 forms) on
    the int8, int4 and fp32 caches: every single-token step launches the
    cache's decode kernel (none turned away to the eager attention), and
    prefill and step logits track the CPU's: within 1e-2 of
    their scale on the fp32 cache (B1/B2's bf16 inputs), within B7's bound
    (2e-2 of each row's own max) on the int8 and int4 caches, where a KV
    code that rounds the other way on the card moves a row further (an int4
    code flip read 1.03e-2 of the scale at rep 3 on an H100)."""
    cfg = _rep_cfg(rep)
    params = _rtn_params(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(2))

    def run(device):
        p = _to(params, device)
        cache = P.init_kv_cache(cfg, 2, 64, dtype=torch.float32, quantized=bits, device=device)
        pre, cache = P.decode_step(p, cache, toks.to(device), 0, cfg)
        step, cache = P.decode_step(p, cache, toks[:, -1:].to(device), 40, cfg)
        multi, cache = P.decode_step_multi(p, cache, toks[:, -1:].to(device),
                                           torch.tensor([41, 30], device=device), cfg)
        out, _ = P.greedy_generate(p, cache, toks[:, -1:].to(device), 42, 4, cfg)
        return pre.cpu(), step.cpu(), multi.cpu(), out.cpu()

    cpu = run("cpu")
    launches.reset()
    gpu = run(cuda_device)
    counts = launches.snapshot()
    forms = ("B6", "B6.f32") if bits is False else ("B5", "B5.stats", "B5.int4", "B5.int4.stats")
    assert sum(counts[k] for k in forms) >= 6 * cfg.num_layers
    assert counts["B6.eager"] == counts["B5.eager"] == 0
    for got, ref in zip(gpu[:3], cpu[:3]):
        if bits is False:
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-2 * float(ref.abs().max()))
        else:
            row_err, row_max = (got - ref).abs().amax(dim=-1), ref.abs().amax(dim=-1)
            assert bool((row_err <= 2e-2 * row_max).all())
    assert gpu[3].shape == (2, 4)


@pytest.mark.parametrize("m", [1, 8, 80])
@pytest.mark.parametrize("k,n,gs", [(256, 40, 64), (96, 64, 32), (288, 40, 96), (96, 48, None),
                                    (256, 48, 8), (240, 64, 24)])
def test_c2_linear_padded_to_the_kernel_tiles(cuda_device, m, k, n, gs):
    """Linears with N % 16 != 0, K not a whole number of 64-row tiles, or a
    group size that no run of 16 rows divides: B1 (M <= 64) and B2 take
    the weight padded once (`pad_for_kernels`); fp32 output within 1e-4 *
    max|ref| of the plain version on the weight as it is."""
    rng = np.random.default_rng(k + n + m)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda_device)
    qt = P.quantize_rtn(w, P.QuantSpec(n_bits=4, group_size=gs), pack=True)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda_device)
    wp = P.pad_for_kernels({"w": qt})["w"]
    launches.reset()
    with P.backend("pallas"):
        got = P.qmatmul(x, wp, out_dtype=torch.float32)
    key = "B1" if m <= fq.GEMV_MAX_M else "B2"
    counts = launches.snapshot()
    assert counts[key] == 1 and counts["pad"] == 1
    plain = fq.qmm_gemv_plain if key == "B1" else fq.qmm_gemm_plain
    ref = plain(x, qt, torch.float32)
    assert got.shape == (m, n)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("form", ["v3", "s4", "a8"])
@pytest.mark.parametrize("m", [1, 80])
def test_c2_w_a8_padded_to_the_kernel_tiles(cuda_device, form, m):
    """B3's forms on N = 40 (and group size 16 on v3 and s4): the weight
    padded once (`prepare_decode_params`), fp32 output bit-equal to
    `a8_plain` on the weight as it is."""
    rng = np.random.default_rng(m)
    k, n, gs = 256, 40, 16 if form != "a8" else 64
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda_device)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda_device)
    xq, s_x = qa.quantize_activations_s8(x)
    qt = P.quantize_rtn(w, P.QuantSpec(n_bits=4, group_size=gs), pack=True)
    if form == "v3":
        ref = qa.a8_plain(xq, s_x, qt.data, "u4", qt.scale, qt.zero, gs, torch.float32)
    elif form == "s4":
        sw = P.prepare_s4(qt)
        ref = qa.a8_plain(xq, s_x, sw.data4, "s4", sw.scale, sw.zero8, gs, torch.float32)
    else:
        qt = P.recode_s8_percol(qt)
        ref = qa.a8_plain(xq, s_x, qt.data, "s8", qt.scale, qt.zero, qt.group_size or k,
                          torch.float32)
    with P.backend({"v3": "pallas", "s4": "s4", "a8": "a8"}[form]):
        wp = P.prepare_decode_params({"w": qt})["w"]
        launches.reset()
        if form == "v3":
            xp = wp.pad_x(x)
            got = fq.fused_dequant_matmul(xp, wp.w, out_dtype=torch.float32, version=3)[:, :n]
        else:
            got = P.qmatmul(x, wp, out_dtype=torch.float32)
    counts = launches.snapshot()
    key = {"v3": "B3.v3", "s4": "B3.s4", "a8": "B3.s8"}[form] if m <= 64 else "B3.gemm"
    assert counts[key] == 1
    assert got.shape == (m, n)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
