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


def _b3_weight(kind, k, n, gs, rng, device):
    """(data, layout, scale, zero, group size) of one B3 weight form."""
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(device)
    if kind == "s8_percol":
        qt = P.recode_head_s8(w)
        return qt.data, "s8", qt.scale, None, k
    if kind == "s4_head":
        s4 = P.prepare_s4(P.recode_head_s4(w))
        return s4.data4, "s4", s4.scale, s4.zero8, k
    bits = {"u4": 4, "u2": 2, "s4": 4, "s8": 8, "u8": 8}[kind]
    qt = P.quantize_rtn(w, P.QuantSpec(n_bits=bits, group_size=gs), pack=kind != "s8")
    if kind == "s4":
        s4 = P.prepare_s4(qt)
        return s4.data4, "s4", s4.scale, s4.zero8, gs
    return qt.data, kind, qt.scale, qt.zero, gs


@pytest.mark.parametrize("kind", ["u4", "u2", "s4", "s8", "u8", "s8_percol", "s4_head"])
@pytest.mark.parametrize("m", [1, 3, 8, 65, 130])
@pytest.mark.parametrize("k,gs", [(256, 64), (2304, 32)])
def test_b3_forms_match_plain(cuda_device, kind, m, k, gs):
    """B3's GEMV form (M <= 64) and tiled form on every weight layout
    (unpacked uint8 8-bit codes included) and zero-point kind: exact s32 partials and the same fp32 epilogue order,
    so fp32 output equals the plain version (atol 1e-5 * max|ref| allows
    the fp32 order only); bf16 output within 1e-2. 4 groups take the GEMV
    epilogue's per-output schedule, 72 its per-block one in two passes."""
    rng = np.random.default_rng(m)
    n = 192
    data, layout, scale, zero, g = _b3_weight(kind, k, n, gs, rng, cuda_device)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda_device)
    xq, s_x = qa.quantize_activations_s8(x)
    key = "B3.gemm" if m > qa.GEMV_MAX_M else "B3.s8"
    before = launches.snapshot()[key]
    got = qa.w_a8_matmul(x, data, layout, scale, zero, g, torch.float32, "B3.s8")
    assert launches.snapshot()[key] == before + 1
    ref = qa.a8_plain(xq, s_x, data, layout, scale, zero, g, torch.float32)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    got16 = qa.w_a8_matmul(x.to(torch.bfloat16), data, layout, scale, zero, g, torch.bfloat16,
                           "B3.s8")
    xq16, s_x16 = qa.quantize_activations_s8(x.to(torch.bfloat16))
    ref16 = qa.a8_plain(xq16, s_x16, data, layout, scale, zero, g, torch.bfloat16)
    torch.testing.assert_close(got16.float(), ref16.float(), rtol=0,
                               atol=1e-2 * float(ref16.float().abs().max()))


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


@pytest.mark.parametrize("s", [128, 160])
def test_flash_kernel_matches_plain(cuda_device, s):
    """B7, bf16: 2e-2 * max|ref| (the kernel rounds unnormalized
    probabilities to bf16 for PV, the plain version normalized ones)."""
    gen = torch.Generator(device=cuda_device).manual_seed(s)
    q = torch.randn((1, s, 4, 64), generator=gen, device=cuda_device).to(torch.bfloat16)
    k = torch.randn((1, s, 2, 64), generator=gen, device=cuda_device).to(torch.bfloat16)
    v = torch.randn((1, s, 2, 64), generator=gen, device=cuda_device).to(torch.bfloat16)
    got = fa.flash_attention(q, k, v)
    ref = fa.attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=2e-2 * float(ref.float().abs().max()))


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
    epilogue order, so within 1e-6 * max|ref| (multi-stream: S = 1, 2, 4)."""
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
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("variant", ["dot2", "cat", "bf16"])
def test_b10_variants_match_plain(cuda_device, variant):
    """B10 on RTN W4 g128 codes: dot2 and cat bit-identical to the plain
    version (B3's integers and epilogue order), bf16 within 1e-2 * max|ref|."""
    rng = np.random.default_rng(10)
    k, n = 1024, 448
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda_device)
    qt = P.quantize_rtn(w, P.QuantSpec(n_bits=4, group_size=128), pack=True)
    xq = _ints(rng, -127, 128, (8, k), cuda_device)
    before = launches.snapshot()[f"B10.{variant}"]
    got = qmm_u8.u8_qmm(xq, qt.data, qt.scale, qt.zero, variant)
    assert launches.snapshot()[f"B10.{variant}"] == before + 1
    ref = qmm_u8.u8_qmm_plain(xq, qt.data, qt.scale, qt.zero, variant)
    tol = 1e-2 * float(ref.abs().max()) if variant == "bf16" else 0
    torch.testing.assert_close(got, ref, rtol=0, atol=tol)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, P.QuantizedTensor):
        return dataclasses.replace(
            tree, data=tree.data.to(device), scale=tree.scale.to(device),
            zero=None if tree.zero is None else tree.zero.to(device))
    return tree.to(device)
