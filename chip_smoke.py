#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`llama3_quantization_tpu_torch`) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                 # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels-only  # build and check the kernels only
    python3 chip_smoke.py --profile       # also profile decode steps and serving windows
    python3 chip_smoke.py --prefill-bench # only time B2 and forward_logits at M up to 2048
    python3 chip_smoke.py --decode-drift  # only the full-depth B5, B6 and B3 kernel-vs-plain decodes
    python3 chip_smoke.py --microbench    # only the weight-stream probes B8-B10 and their entry points

Phases, in order; any failure exits non-zero:
  1. require CUDA and print the card's name and power limit;
  2. build every kernel from `llama3_quantization_tpu_torch/csrc/` (one nvcc
     per source, in parallel);
  3. hold each kernel form against its plain PyTorch version on the card at
     the main paths' shapes, with the tolerances stated below: B1 at M = 1
     and 8, B2 at M = 128 and 512, B2 on 3-bit planes at M = 128 and 512,
     B3 (v3 on packed W4 g128, s4, per-column s8) at M = 1, 8 and 128 on
     the W·A8 paths' o, qkv, gate-up and down and the s8 and s4 heads at
     M = 1 and 8, B5 on the int8 cache with and without m/l statistics and
     on the int4 cache with and without them (one all-masked row), B6 on
     the bf16 fp cache (stacked at B = 1, T = 512 and 2048; per layer at
     B = 8 with per-row masks and an all-masked row) and on an fp32 cache,
     B7; then the window-merge op (B5 with stats merged with the exact
     window attention) against eager attention over the dequantized main
     and window keys; B3 on unpacked uint8 8-bit codes; and the
     weight-stream probes at the microbench scripts' default shapes
     (`check_probes`): B8 (w4, tiled, depth 1/2/4/8) and B10 dot2 / cat
     exactly, B9 (v4, tiled, dot4, noscale, cast8, multi S = 1/2/4) within
     1e-6 * max|ref|, B10 bf16 within 1e-2;
  4. drive the first main path at full Llama-3-8B width and depth (W4 g128
     packed synthetic weights, bf16, 32 layers, the pallas backend):
     `forward_logits` on [1, 128] tokens, a 128-token prefill into an int8
     cache of 512 slots and `greedy_generate` for 32 steps; check finite
     logits, and decode against the teacher-forced forward (max relative
     logit error < 0.15);
  5. drive the serving path on the same model: `ServingEngine` with 8
     slots, max_len 512, `ljf`, int8 cache, `run_pipelined(16)` on 16
     requests of the serve bench's mix, which must give exactly the streams
     of the sequential `step_n(16)` loop; then the int4 cache: the engine on
     8 requests, a per-step `run()`, and `greedy_generate` of 32 steps after
     a 128-token prefill (the windowed route). Served tok/s beside the card;
     then the fp cache, the JAX package's default: `init_kv_cache(cfg, 1,
     512)` (bf16), a 128-token prefill and `greedy_generate` of 32 steps
     (B1 + the stacked B6, decode vs forward < 0.15), and the default
     `ServingEngine` on the 16 requests (B1 at M = 8 + B6 per layer,
     pipelined = sequential), neither launching a B5 form; then the JAX
     package's v3 route (`L3Q_QMM_V=3`): a 128-token prefill and 8 greedy
     steps through B3 on the packed weights;
  6. the W·A8 paths and the 3-bit form: `forward_logits` on [1, 128] of
     RTN W3 g128 weights through 3-bit B2 (4 of 32 layers), against B2's
     plain version (< W3_LIMIT); the s4 decode headline (synthetic W4 g128
     with an s4 head, fused, backend s4: 128-token prefill, 32 greedy steps,
     decode vs forward < 0.15); fused a8 serving (synthetic per-column s8
     with an s8 head, `fuse=True`, backend a8: `run_pipelined(16)` equal to
     `step_n(16)`);
  7. repeat the serving comparisons on input-dependent weights (seeded
     random-normal, RTN W4 g128 packed: the synthetic codes' logits barely
     depend on the input), requiring varied streams: the pallas int8 engine,
     then the same model recoded per column (`recode_model_s8`, head
     included) under fused a8; the fp engine (pipelined = sequential);
     `sample_generate` (temperature 0 = greedy, a seed repeats its stream at
     0.8 / top-p 0.9); `speculative_generate` with the model as its own
     draft (8 rounds of k = 4 after a 128-token prefill; every emitted
     token the forward's argmax but at near ties, at most one); a greedy
     decode under KV4 fake quant (`RuntimeQuantConfig(k=4 bits, v=4 bits)`:
     the eager route, no B6); check teacher-forced decode against the
     forward (int8 < 0.15, int4 reported, KV4-hooked < 0.15), the decode
     through the B5 and B6 kernel forms against their plain versions
     (< DRIFT_LIMIT) and the s4 decode through B3 against B3's plain
     version (< B3_DRIFT_LIMIT); these checks' launches are not counted as
     a path's;
  8. run every `llama3_quantization_tpu_torch.microbench` entry point at its
     defaults (Llama-3-8B widths; the lines they print are the card's W4
     stream ceiling and formulation costs), checking w4_v4 against its
     oracle (< 1e-5) and the unpack numerics (u8 dot2 / cat < 1e-5, bf16 <
     2e-2 of the fake-quant oracle);
  9. time each kernel form, its plain version and a library yardstick, with
     the least time the card could take for the same work (its bound).

Each path runs with the launch counts set to 0 just before it and read
just after; a kernel form that a path should run and did not, or one it
must not run and did, fails the run. The line before the last is a JSON object of the kernels; the last
line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

SEED = 0
GS = 128
LINEAR_SHAPES = {  # (K, N) of the Llama-3-8B decoder linears
    "q/o": (4096, 4096),
    "k/v": (4096, 1024),
    "gate/up": (4096, 14336),
    "down": (14336, 4096),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call: the summed duration of every kernel it
    launches (the wrapper's split-K pass included), from torch.profiler.

    Back-to-back calls cannot time a small kernel by CUDA events: the
    Python wrapper takes longer to enqueue a call than the card takes to
    run it. Where the profiler records no device time, fall back to CUDA
    events around `iters` calls (host-bound for small kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    busy_us = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    if busy_us > 0:
        return busy_us / iters / 1e3
    log("  (profiler saw no device time: timing by CUDA events)")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, ref, rel_tol: float) -> float:
    """Max abs error of `got` against `ref`; fails above rel_tol * max|ref|."""
    g, r = got.float(), ref.float()
    if not bool(g.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err = float((g - r).abs().max())
    scale = float(r.abs().max())
    log(f"  {name}: max_abs_err {err:.3e}  max_rel_err {err / max(scale, 1e-30):.3e}"
        f"  (tolerance {rel_tol:g} * max|ref| = {rel_tol * scale:.3e})")
    if not err <= rel_tol * scale:
        raise AssertionError(f"{name}: error {err} above {rel_tol} * {scale}")
    return err


def rand_weights(P, k: int, n: int, copies: int, gen):
    from llama3_quantization_tpu_torch.models.synthetic import _rand_qtensor

    stacked = _rand_qtensor(gen, k, n, P.QuantSpec(n_bits=4, group_size=GS), copies, "cuda")
    return [stacked.layer(i) for i in range(copies)]


#: (kernel id, M) of every B1/B2 instantiation the paths run: B1 at M=1
#: (batch-1 decode) and M=8 (the 8-slot engine's decode, two 4-row tiles);
#: B2 at M=128 (a 128-token prefill, the engine's bucket-16 prefill) and
#: M=512 (the engine's bucket-64 prefill: 8 slots x 64)
QMM_CASES = (("B1", 1), ("B1", 8), ("B2", 128), ("B2", 512))


def check_qmatmul(P, gen, results):
    """B1 at M=1 and 8 and B2 at M=128 and 512 on every decoder linear shape."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    for (label, (k, n)) in LINEAR_SHAPES.items():
        qt = rand_weights(P, k, n, 1, gen)[0]
        for kid, m in QMM_CASES:
            kern, plain = ((fq.qmm_gemv, fq.qmm_gemv_plain) if kid == "B1"
                           else (fq.qmm_gemm, fq.qmm_gemm_plain))
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            # fp32 output: only the fp32 summation order differs
            compare(f"{kid} {label} M={m} fp32-out", kern(x, qt, torch.float32),
                    plain(x, qt, torch.float32), 1e-4)
            # bf16 output (the main path): plus one bf16 rounding
            err = compare(f"{kid} {label} M={m} bf16-out", kern(x, qt, torch.bfloat16),
                          plain(x, qt, torch.bfloat16), 1e-2)
            results.setdefault(kid, {})[f"{label} M={m}"] = err


#: (K, N) of the linears the W·A8 paths run, q/k/v and gate/up fused as
#: `fuse_for_decode` makes them, and of the lm_head
B3_SHAPES = {"o": (4096, 4096), "qkv": (4096, 6144), "gateup": (4096, 28672),
             "down": (14336, 4096)}
HEAD_SHAPE = (4096, 128256)
#: M of B3's paths: batch-1 decode, the 8-slot serving step, a 128-token prefill
B3_MS = (1, 8, 128)


def b3_forms(P, k, n, copies, gen):
    """B3's three weight forms of a [K, N] linear as the paths hold them,
    `copies` of each: packed W4 g128 with its fp32 zero (v3), the same
    prepared for the s4 backend (signed nibbles, int8 zero8), and per-column
    s8 containers (a8). Each entry is (data, layout, scale, zero, group size)."""
    from llama3_quantization_tpu_torch.models.synthetic import _rand_qtensor

    spec = P.QuantSpec(n_bits=4, group_size=GS)
    w4 = _rand_qtensor(gen, k, n, spec, copies, "cuda")
    s4 = P.prepare_s4(w4)
    s8 = _rand_qtensor(gen, k, n, spec, copies, "cuda", percol_s8=True)
    return {
        "B3.v3": [(w.data, "u4", w.scale, w.zero, GS) for w in map(w4.layer, range(copies))],
        "B3.s4": [(w.data4, "s4", w.scale, w.zero8, GS) for w in map(s4.layer, range(copies))],
        "B3.s8": [(w.data, "s8", w.scale, None, k) for w in map(s8.layer, range(copies))],
    }


def head_forms(P, gen):
    """The s8 and s4 lm_head recodes of a random-normal [4096, 128256] head."""
    import torch

    w = torch.randn(HEAD_SHAPE, generator=gen, device="cuda") * 0.02
    s8, s4 = P.recode_head_s8(w), P.prepare_s4(P.recode_head_s4(w))
    return {"B3.s8": (s8.data, "s8", s8.scale, None, HEAD_SHAPE[0]),
            "B3.s4": (s4.data4, "s4", s4.scale, None, HEAD_SHAPE[0])}


def b3_call(key, w, xq, s_x, out_dtype):
    """B3's GEMV form (M <= 64, counted under `key`) or tiled form."""
    from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa

    if xq.shape[0] <= qa.GEMV_MAX_M:
        return qa.a8_gemv(xq, s_x, *w, out_dtype, key)
    return qa.a8_gemm(xq, s_x, *w, out_dtype)


def check_b3(P, gen, results):
    """Every B3 form against its plain version at the paths' shapes: v3, s4
    and per-column s8 at M = 1, 8 and 128 on o, qkv, gate-up and down, the
    s8 and s4 heads at M = 1 and 8, and unpacked uint8 8-bit codes on o
    (a8's "u8" layout, v3's int8 cast). Tolerances: fp32 out 1e-5 *
    max|ref| (exact s32 partials, the fp32 order only), bf16 out 1e-2."""
    import torch
    from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa

    def one(key, label, w, m, k):
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        xq, s_x = qa.quantize_activations_s8(x)
        rkey = key if m <= qa.GEMV_MAX_M else "B3.gemm"
        name = f"{rkey} {label} {w[1]} M={m}"
        compare(f"{name} fp32-out", b3_call(key, w, xq, s_x, torch.float32),
                qa.a8_plain(xq, s_x, *w, torch.float32), 1e-5)
        err = compare(f"{name} bf16-out", b3_call(key, w, xq, s_x, torch.bfloat16),
                      qa.a8_plain(xq, s_x, *w, torch.bfloat16), 1e-2)
        results.setdefault(rkey, {})[f"{label} {w[1]} M={m}"] = err

    for label, (k, n) in B3_SHAPES.items():
        for key, ws in b3_forms(P, k, n, 1, gen).items():
            for m in B3_MS:
                one(key, label, ws[0], m, k)
    for key, w in head_forms(P, gen).items():
        for m in (1, 8):
            one(key, "head", w, m, HEAD_SHAPE[0])
    # unpacked uint8 8-bit codes (`quantize_rtn(bits=8, pack=True)`): the a8
    # route's promoted dot, the v3 route's int8 cast
    k, n = B3_SHAPES["o"]
    qt = P.quantize_rtn(torch.randn((k, n), generator=gen, device="cuda"),
                        P.QuantSpec(n_bits=8, group_size=GS), pack=True)
    for m in B3_MS:
        one("B3.s8", "o", (qt.data, "u8", qt.scale, qt.zero, GS), m, k)
        one("B3.v3", "o", (qt.data.view(torch.int8), "s8", qt.scale, qt.zero, GS), m, k)


def check_b2_w3(P, gen, results):
    """B2 on 3-bit planes (RTN W3 g128 of random normals) at M = 128 and 512
    on every decoder linear shape: fp32 out 1e-4 * max|ref|, bf16 1e-2."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    for label, (k, n) in LINEAR_SHAPES.items():
        w = torch.randn((k, n), generator=gen, device="cuda")
        qt = P.quantize_rtn(w, P.QuantSpec(n_bits=3, group_size=GS), pack=True)
        for m in (128, 512):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            compare(f"B2.w3 {label} M={m} fp32-out", fq.qmm_gemm(x, qt, torch.float32),
                    fq.qmm_gemm_plain(x, qt, torch.float32), 1e-4)
            err = compare(f"B2.w3 {label} M={m} bf16-out", fq.qmm_gemm(x, qt, torch.bfloat16),
                          fq.qmm_gemm_plain(x, qt, torch.bfloat16), 1e-2)
            results.setdefault("B2.w3", {})[f"{label} M={m}"] = err


def rand_cache(P, b, g, t, d, layers, gen, int4=False):
    """Quantized K/V from random normals, [L, B, G, T, *]: int8 codes, or
    the int4 T-pair pack [L, B, G, T/2, D]."""
    import torch

    quantize = P.kv4_quantize if int4 else P.kv_quantize
    kv = torch.randn((2, layers, b, g, t, d), generator=gen, device="cuda")
    kq, ks = quantize(kv[0])
    vq, vs = quantize(kv[1])
    return kq, ks, vq, vs


def decode_mask(b, t):
    """Every slot valid except the last eighth (NEG, as the decode path gives)."""
    import torch
    from llama3_quantization_tpu_torch.ops.decode_attention import NEG

    mask = torch.zeros((b, t), dtype=torch.float32, device="cuda")
    mask[:, t - t // 8:] = NEG
    return mask


def compare_rel(name: str, got, ref, rtol: float) -> None:
    """Elementwise |got - ref| <= rtol * |ref| (the m/l statistics)."""
    bad = (got - ref).abs() > rtol * ref.abs()
    worst = float(((got - ref).abs() / ref.abs().clamp(min=1e-30)).max())
    log(f"  {name}: max elementwise rel err {worst:.3e} (tolerance {rtol:g})")
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements above rel {rtol}")


#: the B5 kernel forms: (int4 cache, m/l statistics)
FORMS = ((False, False), (False, True), (True, False), (True, True))


def check_decode_forms(P, gen, results):
    """B5 on the int8 and int4 caches, with and without m/l statistics, at
    G=8, rep=4, D=128, B in {1, 8} (8 = the serving engine's slots), T in
    {512, 2048} (T=2048 runs two T blocks). In the batch-8 cases row 0 is
    all masked: with stats, m must be -1e30 and l = T there. Tolerances: o
    2e-3 * max|o| in fp32 out (a 1-ulp exp difference can move one
    probability code by one), 1e-2 in bf16 out (the form without stats
    returns the activation dtype on the paths); m 1e-6 * |m|, l 1e-5 * l."""
    import torch
    from llama3_quantization_tpu_torch.ops import decode_attention as da

    g, rep, d = 8, 4, 128
    for int4, stats in FORMS:
        key = da.launch_key(int4, stats)
        for b in (1, 8):
            for t in (512, 2048):
                block_t = 1024 if t % 1024 == 0 else 512
                kq, ks, vq, vs = (x[0] for x in rand_cache(P, b, g, t, d, 1, gen, int4))
                q = torch.randn((b, 1, g * rep, d), generator=gen, device="cuda").to(torch.bfloat16)
                mask = decode_mask(b, t)
                if b > 1:
                    mask[0] = da.NEG
                args = (q, kq, ks, vq, vs, mask)
                got = da.decode_s8(*args, torch.float32, block_t, stats)
                ref = da.decode_s8_plain(*args, torch.float32, block_t, stats)
                label = f"{key} B={b} T={t}"
                if stats:
                    compare_rel(f"{label} m", got[1], ref[1], 1e-6)
                    compare_rel(f"{label} l", got[2], ref[2], 1e-5)
                    if b > 1 and not (bool((got[1][0] == da.NEG).all())
                                      and bool((got[2][0] == t).all())):
                        raise AssertionError(f"{label}: all-masked row has m != -1e30 or l != T")
                    got, ref = got[0], ref[0]
                err = compare(f"{label} fp32-out", got, ref, 2e-3)
                if not stats:
                    err = compare(f"{label} bf16-out", da.decode_s8(*args, torch.bfloat16, block_t),
                                  da.decode_s8_plain(*args, torch.bfloat16, block_t), 1e-2)
                results.setdefault(key, {})[f"B={b} T={t}"] = err


def check_window_merge(P, gen):
    """The windowed decode's attention at the serving shapes (B=8 slots,
    T=512, a 16-token window): B5 with stats over the main cache, under
    per-row main lengths (row 0: empty main cache), merged with the exact
    window attention, against one eager softmax over the dequantized main
    and window keys. Limit: relative error |got - ref| / |ref| < 2e-2 (the
    kernel segment's s8 quantization of q and probabilities)."""
    import torch
    from llama3_quantization_tpu_torch.models import windowed as W
    from llama3_quantization_tpu_torch.ops import decode_attention as da
    from llama3_quantization_tpu_torch.ops.kvcache import cache_read

    b, g, rep, d, t, kw = 8, 8, 4, 128, 512, 16
    main_len = torch.tensor([0, 17, 100, 255, 256, 301, 400, 496], device="cuda")
    for int4 in (False, True):
        codes = P.kv4_codes if int4 else P.kv_quantize
        kq, ks, vq, vs = (x[0] for x in rand_cache(P, b, g, t, d, 1, gen, int4))
        wk, wks = codes(torch.randn((b, g, kw, d), generator=gen, device="cuda"))
        wv, wvs = codes(torch.randn((b, g, kw, d), generator=gen, device="cuda"))
        q = torch.randn((b, 1, g * rep, d), generator=gen, device="cuda").to(torch.bfloat16)
        visible = torch.arange(t, device="cuda")[None, :] < main_len[:, None]
        mask = torch.where(visible, 0.0, da.NEG).float().contiguous()
        o1, m1, l1 = da.decode_s8(q, kq, ks, vq, vs, mask, torch.float32, 512, True)
        qg = q.reshape(b, g, rep, d).float()
        o2, m2, l2 = W._window_attn(qg, wk, wks, wv, wvs, torch.zeros((1, 1, 1, kw), device="cuda"))
        got = W._merge_attn(o1.reshape(b, g, rep, d), m1, l1, o2, m2, l2)
        k_all, v_all = cache_read((kq, ks, vq, vs), torch.float32)
        keys = torch.cat([k_all, wk.float() * wks], dim=2)
        vals = torch.cat([v_all, wv.float() * wvs], dim=2)
        allowed = torch.cat([visible, torch.ones((b, kw), dtype=torch.bool, device="cuda")], 1)
        scores = torch.einsum("bgrd,bgjd->bgrj", qg, keys) / d**0.5
        scores = scores.masked_fill(~allowed[:, None, None, :], float("-inf"))
        ref = torch.einsum("bgrj,bgjd->bgrd", torch.softmax(scores, dim=-1), vals)
        rel = float((got - ref).norm() / ref.norm())
        log(f"  window merge {'int4' if int4 else 'int8'} B={b} T={t} KW={kw}: rel err "
            f"{rel:.3e} (|got - ref| / |ref|, limit 2e-2), max abs err "
            f"{float((got - ref).abs().max()):.3e} of max|ref| {float(ref.abs().max()):.3e}")
        if not (bool(got.isfinite().all()) and rel < 2e-2):
            raise AssertionError(f"window merge: rel err {rel} not below 2e-2")


#: the microbench scripts' default (K, N, bk): the fused gate/up of
#: Llama-3-8B (w4_variants, w4_tiled, w4_multidma) and its gate (w4_v4,
#: unpack); dma_depth streams 64 MiB of width 1024 in chunks of 512 KB
MB_SHAPE = (4096, 28672, 2048)
V4_SHAPE = (4096, 14336, 2048)
DEPTH_ROWS, DEPTH_CHUNK, DEPTH_WIDTH = 64 * 1024, 512, 1024
#: the weight-stream probe forms (kernels B8-B10), in the kernels line's order
PROBE_KEYS = ("B8.w4", "B8.tiled", "B8.depth", "B9.v4", "B9.dot4", "B9.cast8", "B9.noscale",
              "B9.tiled", "B9.multi", "B10.dot2", "B10.cat", "B10.bf16")


def probe_cases(P, gen, copies):
    """Each probe form at its script's default shape, `copies` weight copies
    (cycled by the timings so each call finds its weight cold in the 50 MB
    L2): a list of dicts with the kernel call `run(i)`, its plain version
    `plain()` on copy 0, the check's tolerance (0: exact), the bytes and
    integer operations of its bound, and the library yardstick `lib(i)`
    (`torch.matmul` on the pre-dequantized bf16 weight) or None."""
    import torch
    from llama3_quantization_tpu_torch.ops import w4_bd, w4_stream

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int16).to(torch.int8)

    def scales(g, n):
        return (torch.rand((g, n), generator=gen, device="cuda") + 0.5) * 0.01

    def dequant(packed, scale):  # int4 values times their group scales, bf16
        w = w4_bd.int4_weight(packed).float().reshape(scale.shape[0], GS, -1)
        return (w * scale[:, None]).reshape(-1, scale.shape[1]).to(torch.bfloat16)

    cases = []

    def add(key, script_line, shape, run, plain, tol, nbytes, ops, lib=None):
        cases.append(dict(key=key, replaces=f"scripts/microbench_{script_line}", shape=shape,
                          run=run, plain=plain, tol=tol, nbytes=nbytes, ops=ops, lib=lib))

    k, n, bk = MB_SHAPE
    g, gt = k // GS, bk // GS
    w = [ints(-128, 128, (k // 2, n)) for _ in range(copies)]
    s = [scales(g, n) for _ in range(copies)]
    wt = [x.reshape(k // bk, bk // 2, n // 512, 512).permute(0, 2, 1, 3).contiguous() for x in w]
    xh, xl, bd2, bd1 = ints(-8, 8, (1, k)), ints(-8, 8, (1, k)), ints(-8, 8, (2 * g, k)), \
        ints(-120, 120, (g, k))
    xb = torch.randn((1, k), generator=gen, device="cuda").to(torch.bfloat16)
    wd = [dequant(w[i], s[i]) for i in range(copies)]
    lib = lambda i: torch.matmul(xb, wd[i])  # noqa: E731
    wbytes, sbytes, obytes = k * n // 2, 4 * g * n, 4 * n
    mb = f"[{k}x{n}] bk={bk}"
    add("B8.w4", "w4_variants.py:54", f"{mb} packed W4 [K/2,N], depth {w4_stream.W4_DEPTH}",
        lambda i: w4_stream.w4_dma(w[i], bk), lambda: w4_stream.w4_dma_plain(w[0], bk), 0,
        wbytes + obytes, 0)
    add("B8.tiled", "w4_tiled.py:24", f"{mb} bn=512 tiles [K/bk,N/bn,bk/2,bn]",
        lambda i: w4_stream.w4_dma_tiled(wt[i]), lambda: w4_stream.w4_dma_tiled_plain(wt[0]), 0,
        wbytes + obytes, 0)
    add("B9.tiled", "w4_tiled.py:39", f"{mb} bn=512 tiles, x[1,K] as xh, xl",
        lambda i: w4_bd.w4_bd(xh, xl, s[i], wt[i], bk, tiled=True),
        lambda: w4_bd.bd_plain("v4", (xh, xl), (w[0],), s[0], bk), 1e-6,
        wbytes + sbytes + 2 * k + obytes, 4.0 * k * n, lib)
    add("B9.dot4", "w4_variants.py:70", f"{mb} bd[{2 * gt},K] int4 rows",
        lambda i: w4_bd.w4_dot4(bd2, s[i], w[i], bk),
        lambda: w4_bd.bd_plain("dot4", (bd2[:2 * gt],), (w[0],), s[0], bk), 1e-6,
        wbytes + sbytes + 2 * gt * k + obytes, 2.0 * 2 * gt * k * n, lib)
    add("B9.noscale", "w4_variants.py:139", f"{mb} bd[{2 * gt},K] int4 rows, no scales",
        lambda i: w4_bd.w4_noscale(bd2, w[i], bk),
        lambda: w4_bd.bd_plain("noscale", (bd2[:2 * gt],), (w[0],), None, bk), 1e-6,
        wbytes + 2 * gt * k + obytes, 2.0 * 2 * gt * k * n, lib)
    add("B9.cast8", "w4_variants.py:120", f"{mb} bd[{gt},K] s8 rows",
        lambda i: w4_bd.w4_cast8(bd1, s[i], w[i], bk),
        lambda: w4_bd.bd_plain("cast8", (bd1[:gt],), (w[0],), s[0], bk), 1e-6,
        wbytes + sbytes + gt * k + obytes, 2.0 * gt * k * n, lib)
    for st in (1, 2, 4):
        ws = [[ints(-128, 128, (k // 2 // st, n)) for _ in range(st)] for _ in range(copies)]
        bds = [ints(-8, 8, (2 * gt // st, k // st)) for _ in range(st)]
        add("B9.multi", "w4_multidma.py:24", f"{mb} S={st} streams",
            lambda i, ws=ws, bds=bds: w4_bd.w4_multi(bds, ws[i], bk),
            lambda ws=ws, bds=bds: w4_bd.bd_plain("multi", bds, ws[0], None, bk), 1e-6,
            wbytes + 2 * gt * k + obytes, 2.0 * 2 * gt * k * n / st, lib)
    v4_cases(P, gen, copies, ints, scales, dequant, add)
    return cases


def v4_cases(P, gen, copies, ints, scales, dequant, add):
    """`probe_cases` at the gate's shape (w4_v4, unpack): B9.v4 and B10."""
    import torch
    from llama3_quantization_tpu_torch.ops import qmm_u8, w4_bd
    from llama3_quantization_tpu_torch.ops.qmatmul_a8 import quantize_activations_s8

    k, n, bk = V4_SHAPE
    g = k // GS
    w = [ints(-128, 128, (k // 2, n)) for _ in range(copies)]
    s = [scales(g, n) for _ in range(copies)]
    xh, xl = ints(-8, 8, (1, k)), ints(-8, 8, (1, k))
    xb = torch.randn((1, k), generator=gen, device="cuda").to(torch.bfloat16)
    wd4 = [dequant(w[i], s[i]) for i in range(copies)]
    add("B9.v4", "w4_v4.py:30", f"[{k}x{n}] bk={bk} x[1,K] as xh, xl",
        lambda i: w4_bd.w4_bd(xh, xl, s[i], w[i], bk),
        lambda: w4_bd.bd_plain("v4", (xh, xl), (w[0],), s[0], bk), 1e-6,
        k * n // 2 + 4 * g * n + 2 * k + 4 * n, 4.0 * k * n,
        lambda i: torch.matmul(xb, wd4[i]))
    qts = [P.quantize_rtn(torch.randn((k, n), generator=gen, device="cuda") * 0.02,
                          P.QuantSpec(n_bits=4, group_size=GS), pack=True) for _ in range(copies)]
    x8 = torch.randn((qmm_u8.BM, k), generator=gen, device="cuda").to(torch.bfloat16)
    xq, _ = quantize_activations_s8(x8)
    wdu = [((P.dequantize(q)).float()).to(torch.bfloat16) for q in qts]
    for v in ("dot2", "cat", "bf16"):
        add(f"B10.{v}", "unpack.py:61", f"x[8,{k}] s8, u4 g128 [{k},{n}] group-local",
            lambda i, v=v: qmm_u8.u8_qmm(xq, qts[i].data, qts[i].scale, qts[i].zero, v),
            lambda v=v: qmm_u8.u8_qmm_plain(xq, qts[0].data, qts[0].scale, qts[0].zero, v),
            1e-2 if v == "bf16" else 0, k * n // 2 + 2 * 4 * g * n + 8 * k + 4 * 8 * n,
            2.0 * 8 * k * n, lambda i: torch.matmul(x8, wdu[i]))


def check_probes(P, gen, results):
    """Every B8, B9 and B10 form against its plain version at the
    microbench scripts' default shapes: B8 and B10 dot2 / cat exactly, B9
    within 1e-6 * max|ref| (exact s32 partials, the fp32 epilogue in the
    same order), B10 bf16 within 1e-2 (the order inside a bf16 dot)."""
    import torch
    from llama3_quantization_tpu_torch.ops import w4_stream

    x = torch.randint(-128, 128, (DEPTH_ROWS, DEPTH_WIDTH), generator=gen, device="cuda",
                      dtype=torch.int16).to(torch.int8)
    ref = w4_stream.dma_depth_plain(x, DEPTH_CHUNK)
    for depth in w4_stream.DEPTHS:
        err = compare(f"B8.depth [{DEPTH_ROWS},{DEPTH_WIDTH}] depth={depth}",
                      w4_stream.dma_depth(x, DEPTH_CHUNK, depth), ref, 0)
        results.setdefault("B8.depth", {})[depth] = err
    del x
    for c in probe_cases(P, gen, 1):
        err = compare(f"{c['key']} {c['shape']}", c["run"](0), c["plain"](), c["tol"])
        results.setdefault(c["key"], {})[c["shape"]] = err
    torch.cuda.empty_cache()


#: the kernel forms each microbench entry point must launch
MB_MUST = {
    "w4_variants": ("B8.w4", "B9.dot4", "B9.v4", "B9.cast8", "B9.noscale"),
    "w4_tiled": ("B8.tiled", "B9.tiled"),
    "w4_multidma": ("B9.multi",),
    "dma_depth": ("B8.depth",),
    "w4_v4": ("B9.v4",),
    "unpack": ("B10.dot2", "B10.cat", "B10.bf16", "B1", "B3.v3", "B3.s8"),
}
#: w4_v4 against its script's oracle (max relative error), and the u8
#: variants against the fake-quant oracle (`microbench_unpack.py:156-162`)
V4_ORACLE_LIMIT = 1e-5
U8_ORACLE_LIMITS = {"dot2": 1e-5, "cat": 1e-5, "bf16": 2e-2}


def drive_microbench(P, card):
    """Every `llama3_quantization_tpu_torch.microbench` entry point at its
    defaults (the scripts' Llama-3-8B widths), each a counted path; their
    lines are the card's W4 stream ceiling and formulation costs."""
    import importlib

    from llama3_quantization_tpu_torch import microbench

    counts, out = {}, {}
    log(f"microbench entry points at their defaults  [{card}]")
    for name in microbench.MODULES:
        mod = importlib.import_module(f"llama3_quantization_tpu_torch.microbench.{name}")
        out[name], dt = run_counted(counts, f"microbench {name}", lambda: timed(lambda: mod.main([])),
                                    must=MB_MUST[name])
        log(f"  (microbench {name}: {dt:.1f} s host clock, set-up and capture included)")
    err = out["w4_v4"]["max_rel_err"]
    log(f"w4_v4 against its oracle: max rel err {err:.3e} (limit {V4_ORACLE_LIMIT:g})")
    if not err < V4_ORACLE_LIMIT:
        raise AssertionError(f"w4_v4: v4_matvec off its oracle, rel err {err}")
    for v, lim in U8_ORACLE_LIMITS.items():
        if not out["unpack"]["rel_err"][v] < lim:
            raise AssertionError(f"unpack: u8 {v} off the fake-quant oracle")
    return sum_counts(counts)


def time_probes(P, card, launches_total, errs, add):
    """Device ms of each probe form beside its plain version, bound and
    library yardstick, four weight copies cycled; B8.depth at every depth
    (the kernels line takes depth 4). Returns one row per probe key: B9.multi
    at S = 1, the others at their scripts' default shapes."""
    import torch
    from llama3_quantization_tpu_torch.ops import w4_stream

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    rows = {}
    x = torch.randint(-128, 128, (DEPTH_ROWS, DEPTH_WIDTH), generator=gen, device="cuda",
                      dtype=torch.int16).to(torch.int8)
    for depth in w4_stream.DEPTHS:
        ms = time_ms(lambda i: w4_stream.dma_depth(x, DEPTH_CHUNK, depth), 50)
        plain_ms = time_ms(lambda i: w4_stream.dma_depth_plain(x, DEPTH_CHUNK), 20)
        row = add("B8.depth", "w4_stream depth", "llama3_quantization_tpu_torch/csrc/w4_stream.cu",
                  "scripts/microbench_dma_depth.py:24",
                  f"int8 [{DEPTH_ROWS},{DEPTH_WIDTH}], {DEPTH_CHUNK} KB chunks, depth {depth}", ms,
                  plain_ms, DEPTH_ROWS * DEPTH_WIDTH + 4 * DEPTH_WIDTH, 0, INT8_OPS, None,
                  errs["B8.depth"][depth])
        if depth == w4_stream.W4_DEPTH:
            rows["B8.depth"] = row
    del x
    for c in probe_cases(P, gen, 4):
        ms = time_ms(lambda i: c["run"](i % 4), 100)
        plain_ms = time_ms(lambda i: c["plain"](), 3)
        lib_ms = None if c["lib"] is None else time_ms(lambda i: c["lib"](i % 4), 100)
        key = c["key"]
        kid, form = key.split(".")
        src = {"B8": "w4_stream", "B9": "w4_bd", "B10": "qmm_u8"}[kid]
        row = add(key, f"{src} {form}", f"llama3_quantization_tpu_torch/csrc/{src}.cu", c["replaces"],
                  c["shape"] + ("" if c["lib"] is None else " (library: torch.matmul bf16)"), ms,
                  plain_ms, c["nbytes"], c["ops"], INT8_OPS, lib_ms, errs[key][c["shape"]])
        rows.setdefault(key, row)
    torch.cuda.empty_cache()
    return [rows[k] for k in PROBE_KEYS]


#: the B5 kernel forms, none of which an fp-cache path may launch
B5_KEYS = ("B5", "B5.stats", "B5.int4", "B5.int4.stats")


def check_fp_decode(P, gen, results):
    """B6 on the bf16 cache at the paths' shapes, G=8, rep=4, D=128: the
    stacked form (layer 1 of 2) at B=1, T=512 and 2048 (two T blocks), the
    per-layer form at B=8, T=512 under per-row masks with row 0 all masked
    (its output is the mean of v); then an fp32 cache at B=2, T=512.
    Tolerances: bf16 1e-2 * max|ref| (bf16 out; p's bf16 rounding after an
    exp one ulp apart), fp32 1e-5 * max|ref| (summation order)."""
    import torch
    from llama3_quantization_tpu_torch.ops import decode_attention as da

    g, rep, d = 8, 4, 128
    for b, t, dtype, stacked in ((1, 512, torch.bfloat16, True), (1, 2048, torch.bfloat16, True),
                                 (8, 512, torch.bfloat16, False), (2, 512, torch.float32, True)):
        key = da.fp_launch_key(dtype)
        k = torch.randn((2, b, g, t, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((2, b, g, t, d), generator=gen, device="cuda").to(dtype)
        q = torch.randn((b, 1, g * rep, d), generator=gen, device="cuda").to(dtype)
        mask = decode_mask(b, t)
        if b == 8:  # per-row lengths, as the engine's slots have them
            lens = torch.tensor([0, 17, 100, 255, 256, 301, 400, 512], device="cuda")
            mask = torch.where(torch.arange(t, device="cuda")[None, :] < lens[:, None], 0.0,
                               da.NEG).float().contiguous()
            mask[0] = da.NEG
        bt = 1024 if t % 1024 == 0 else 512
        if stacked:
            got = da.flash_decode_gqa_stacked(q, k, v, mask, 1, bt)
        else:
            got = da.flash_decode_gqa(q, k[1], v[1], mask, bt)
        ref = da.decode_fp_plain(q, k[1], v[1], mask, bt)
        label = f"{key} {'stacked' if stacked else 'per-layer'} B={b} T={t}"
        err = compare(label, got, ref, 1e-5 if dtype == torch.float32 else 1e-2)
        if b == 8:
            mean_v = v[1, 0].float().mean(dim=1).repeat_interleave(rep, dim=0)
            compare(f"{label} all-masked row vs mean of v", got[0, 0], mean_v, 1e-2)
        results.setdefault(key, {})[f"B={b} T={t}"] = err


def check_flash(P, gen, results):
    """B7 at B=1, H=32, G=8, D=128 and S in {128, 2048}, bf16."""
    import torch
    from llama3_quantization_tpu_torch.ops import flash_attention as fa

    for s in (128, 2048):
        q = torch.randn((1, s, 32, 128), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((1, s, 8, 128), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((1, s, 8, 128), generator=gen, device="cuda").to(torch.bfloat16)
        # 2e-2: the kernel rounds unnormalized probabilities to bf16 for PV,
        # the plain version normalized ones; both then round the output
        err = compare(f"B7 S={s}", fa.flash_attention_cuda(q, k, v),
                      fa.attention_plain(q, k, v), 2e-2)
        results.setdefault("B7", {})[f"S={s}"] = err


def profile_decode(P, params, cache, tok, pos, cfg, card, steps=4):
    """Device time by kernel over a few decode steps, and the device's busy
    share of the wall time (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        P.greedy_generate(params, cache, tok, pos, steps, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    if busy_us <= 0:
        log("profile: the profiler saw no device time")
        return
    log(f"profile of {steps} decode steps: wall {wall_us / steps / 1e3:.3f} ms/step, device busy "
        f"{busy_us / steps / 1e3:.3f} ms/step ({100 * busy_us / wall_us:.1f}% of wall)  [{card}]")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:10]:
        log(f"  {e.device_time_total / steps:9.1f} us/step  {e.count // steps:5d} calls/step  "
            f"{e.key[:90]}")


def build_params(P):
    """Synthetic packed Llama-3-8B W4 g128 (bf16, 32 layers) on the card."""
    import torch

    t0 = time.time()
    params = P.init_quantized_params(P.LLAMA3_8B, P.QuantSpec(n_bits=4, group_size=GS), seed=SEED)
    torch.cuda.synchronize()
    log(f"params built on the card in {time.time() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    return params


def run_counted(counts, label, fn, must=(), never=()):
    """`fn()` with every launch count set to 0 just before it and read just
    after; fails if a kernel form in `must` was not launched, or one in
    `never` was."""
    from llama3_quantization_tpu_torch.ops import launches

    import torch

    launches.reset()
    out = fn()
    torch.cuda.synchronize()
    counts[label] = launches.snapshot()
    missing = [k for k in must if counts[label][k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    stray = [k for k in never if counts[label][k] != 0]
    if stray:
        raise AssertionError(f"{label}: kernels launched off this path's route: {stray}")
    return out


def timed(fn):
    """(fn(), host seconds), with the card synchronized on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def teacher_forced(P, params, cfg, prompt, cont, bits, rq=None):
    """Logits [n, V] of `decode_step` fed `cont` token by token after a
    `prompt` prefill, on a KV cache of 512 slots: int8 or int4 (`bits` 8
    or 4) or the bf16 fp cache (`bits` False), under `rq`."""
    import torch

    rq = rq or P.NO_QUANT
    cache = P.init_kv_cache(cfg, 1, 512, quantized=bits)
    _, cache = P.decode_step(params, cache, prompt, 0, cfg, rq)
    s, out = prompt.shape[1], []
    for i in range(cont.shape[1]):
        lg, _ = P.decode_step(params, cache, cont[:, i : i + 1], s + i, cfg, rq)
        out.append(lg[0, 0].float())
    return torch.stack(out)


def decode_vs_forward(P, params, cfg, prompt, cont, bits, rq=None):
    """Max relative logit error of teacher-forced decode on a `bits` KV
    cache against `forward_logits` over prompt + cont (bench.py:584-613),
    both under `rq`."""
    import torch

    full = P.forward_logits(params, torch.cat([prompt, cont], dim=1), cfg, rq or P.NO_QUANT)
    full = full[0].float()
    s = prompt.shape[1]
    dec = teacher_forced(P, params, cfg, prompt, cont[:, :-1], bits, rq)
    return float((dec - full[s : s + dec.shape[0]]).abs().max() / full.abs().max())


def drive_main_path(P, params, card, profile=False):
    """Full-width, full-depth Llama-3-8B W4 g128 main path on the card."""
    import torch

    cfg = P.LLAMA3_8B
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")
    counts = {}

    logits = run_counted(counts, "forward_logits [1,128]",
                         lambda: P.forward_logits(params, prompt, cfg), must=("B2", "B7"))
    if tuple(logits.shape) != (1, 128, cfg.vocab_size) or not bool(logits.isfinite().all()):
        raise AssertionError(f"forward_logits: bad shape {tuple(logits.shape)} or non-finite")
    log("forward_logits [1, 128]: finite, shape ok")

    cache = P.init_kv_cache(cfg, 1, 512, quantized=8)
    (pre_logits, _), t_prefill = run_counted(
        counts, "prefill 128 into int8 cache",
        lambda: timed(lambda: P.decode_step(params, cache, prompt, 0, cfg)), must=("B2",))
    if not bool(pre_logits.isfinite().all()):
        raise AssertionError("prefill logits non-finite")
    tok = pre_logits[:, -1].argmax(dim=-1)[:, None]
    # rewrites the same slots
    _, t_prefill_warm = timed(lambda: P.decode_step(params, cache, prompt, 0, cfg))

    n_steps = 32
    (gen_toks, _), t_decode = run_counted(
        counts, f"greedy_generate {n_steps} steps",
        lambda: timed(lambda: P.greedy_generate(params, cache, tok, 128, n_steps, cfg)),
        must=("B1", "B5"))
    if not bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()):
        raise AssertionError("generated tokens out of range")
    _, t_decode_warm = timed(
        lambda: P.greedy_generate(params, cache, gen_toks[:, -1:], 128 + n_steps, n_steps, cfg))

    total = sum_counts(counts)
    for what, t in (("first call", t_prefill), ("second call", t_prefill_warm)):
        log(f"prefill: {128 / t:.1f} tok/s (128 tokens in {t * 1e3:.2f} ms, {what}, "
            f"host clock)  [{card}]")
    for what, t in (("first call", t_decode), ("second call", t_decode_warm)):
        log(f"decode: {n_steps / t:.2f} tok/s ({t / n_steps * 1e3:.3f} ms/token over {n_steps} "
            f"steps, batch 1, int8 KV of 512 slots, {what}, host clock)  [{card}]")

    n_chk = 8
    rel = decode_vs_forward(P, params, cfg, prompt, torch.cat([tok, gen_toks[:, :n_chk]], 1), 8)
    log(f"decode-vs-forward: max rel logit error {rel:.3e} over {n_chk} steps (limit 0.15)")
    if not rel < 0.15:
        raise AssertionError(f"decode/forward divergence: rel err {rel:.4f}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_decode(P, params, cache, gen_toks[:, -1:], 128 + 2 * n_steps, cfg, card)
    del cache
    torch.cuda.empty_cache()
    return total


def serve_requests(n: int, vocab: int):
    """The serve bench's request mix (bench.py:293-295): rng 0, prompt
    lengths 8-63, generation budgets 48-159, token ids from the same rng."""
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = [(int(rng.integers(8, 64)), int(rng.integers(48, 160))) for _ in range(n)]
    return [(list(map(int, rng.integers(0, vocab, plen))), glen) for plen, glen in lengths]


def sequential_streams(eng, reqs, k):
    """The sequential `step_n(k)` loop (tests/test_serving.py:539-557) in the
    engine's `ljf` order: admit into free slots, run one window, repeat.
    Returns the streams, sorted."""
    pend = sorted(reqs, key=lambda r: r[1])  # pop() takes the longest
    rids = []

    def feed():
        batch = []
        while eng.free and len(batch) < len(eng.free) and pend:
            p, n = pend.pop()
            batch.append((p, n, None))
        if batch:
            rids.extend(eng.add_requests(batch))

    feed()
    while eng._slot_req:
        eng.step_n(k)
        if eng.free and pend:
            feed()
    return sorted(eng.result(rid) for rid in rids)


def pipelined_streams(eng, reqs, k):
    """`run_pipelined(k)` on `reqs`; returns the streams, sorted."""
    first = eng._next_rid
    for p, n in reqs:
        eng.submit(p, n)
    eng.run_pipelined(k)
    return sorted(eng.result(rid) for rid in list(eng.requests) if rid >= first)


def check_streams(label, streams, reqs, vocab):
    """Every request got exactly its budget of in-range tokens."""
    if sorted(map(len, streams)) != sorted(n for _, n in reqs):
        raise AssertionError(f"{label}: stream lengths differ from the budgets")
    if not all(0 <= t < vocab for s in streams for t in s):
        raise AssertionError(f"{label}: token out of range")


def drive_serving(P, params, card, profile=False):
    """The serving path on the full model: the 8-slot engine over the int8
    cache (pipelined against sequential), then over the int4 cache."""
    import torch

    cfg = P.LLAMA3_8B
    k, slots, max_len = 16, 8, 512
    counts = {}
    reqs = serve_requests(16, cfg.vocab_size)
    log(f"serving: ServingEngine(max_slots={slots}, max_len={max_len}, ljf), run_pipelined({k}); "
        f"16 requests of the serve bench's mix (the bench serves 48: cut to 16 to keep this "
        f"script inside its time limit), {sum(n for _, n in reqs)} tokens to generate")

    serve_and_compare(P, params, cfg, card, "serve int8", counts, PALLAS_MUST)
    if profile:
        profile_serving(P, params, cfg, reqs, k, card)
    torch.cuda.empty_cache()

    reqs4 = reqs[:8]
    eng4 = P.ServingEngine(params, cfg, max_slots=slots, max_len=max_len, quantized_cache=4,
                           schedule="ljf")
    pipelined_streams(eng4, [(reqs[0][0][:20], 2 * k)], k)  # warm-up, as for int8
    warm_steps = eng4.dispatches["steps"]
    pipe4, dt4 = run_counted(counts, "serve int4 run_pipelined",
                             lambda: timed(lambda: pipelined_streams(eng4, reqs4, k)),
                             must=("B1", "B2", "B5.int4.stats"))
    check_streams("int4 run_pipelined", pipe4, reqs4, cfg.vocab_size)
    produced4 = sum(map(len, pipe4))
    log(f"served (int4 KV): {produced4 / dt4:.1f} tok/s ({produced4} tokens of 8 requests in "
        f"{dt4:.2f} s, {1e3 * dt4 / (eng4.dispatches['steps'] - warm_steps):.1f} ms per 8-slot "
        f"decode step, host clock)  [{card}]")

    def per_step():
        rids = eng4.add_requests([(p, 4, None) for p, _ in reqs4[:2]])
        eng4.run()
        return [eng4.result(r) for r in rids]

    steps = run_counted(counts, "serve int4 step() x 4", per_step, must=("B1", "B5.int4"))
    if [len(s) for s in steps] != [4, 4]:
        raise AssertionError(f"per-step engine run gave {[len(s) for s in steps]} tokens")
    del eng4
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")
    cache = P.init_kv_cache(cfg, 1, max_len, quantized=4)
    lg, cache = P.decode_step(params, cache, prompt, 0, cfg)
    tok = lg[:, -1].argmax(dim=-1)[:, None]
    toks4, cache = run_counted(counts, "int4 greedy_generate 32 steps (windowed)",
                               lambda: P.greedy_generate(params, cache, tok, 128, 32, cfg),
                               must=("B1", "B5.int4.stats"))
    if tuple(toks4.shape) != (1, 32) or not bool(((toks4 >= 0) & (toks4 < cfg.vocab_size)).all()):
        raise AssertionError("int4 greedy_generate: bad tokens")
    del cache
    torch.cuda.empty_cache()
    return sum_counts(counts)


#: kernel forms the fp-cache serving runs must launch: B1 decode, B2
#: bucket prefills, B6 per layer (the windowed decode takes quantized
#: caches only)
FP_MUST = ("B1", "B2", "B6")


def drive_fp_paths(P, params, card, profile=False):
    """The fp cache, the JAX package's default, on the synthetic model:
    `init_kv_cache(cfg, 1, 512)` (bf16), a 128-token prefill and
    `greedy_generate` of 32 steps (B1 + the stacked B6, 32 launches per
    step), decode against the forward; then `ServingEngine(8, 512, ljf)`
    with its default cache, pipelined against sequential. Neither path may
    launch a B5 form."""
    import torch

    cfg, counts, n_steps = P.LLAMA3_8B, {}, 32
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")
    cache = P.init_kv_cache(cfg, 1, 512)
    if sorted(cache) != ["k", "v"] or cache["k"].dtype != torch.bfloat16:
        raise AssertionError("init_kv_cache's default is not the bf16 fp cache")
    (lg, _), t_pre = run_counted(counts, "fp prefill 128",
                                 lambda: timed(lambda: P.decode_step(params, cache, prompt, 0, cfg)),
                                 must=("B2",), never=B5_KEYS)
    tok = lg[:, -1].argmax(dim=-1)[:, None]
    label = f"fp greedy_generate {n_steps} steps"
    (toks, _), t_dec = run_counted(
        counts, label, lambda: timed(lambda: P.greedy_generate(params, cache, tok, 128, n_steps, cfg)),
        must=("B1", "B6"), never=B5_KEYS)
    if counts[label]["B6"] != n_steps * cfg.num_layers:
        raise AssertionError(f"fp decode: {counts[label]['B6']} B6 launches for {n_steps} steps")
    _, t_dec2 = timed(lambda: P.greedy_generate(params, cache, toks[:, -1:], 128 + n_steps,
                                                n_steps, cfg))
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("fp greedy_generate: tokens out of range")
    log(f"fp prefill: {128 / t_pre:.1f} tok/s (128 tokens, first call, host clock)  [{card}]")
    for what, t in (("first call", t_dec), ("second call", t_dec2)):
        log(f"fp decode: {n_steps / t:.2f} tok/s ({t / n_steps * 1e3:.3f} ms/token over {n_steps} "
            f"steps, batch 1, bf16 KV of 512 slots, {what}, host clock)  [{card}]")
    rel = decode_vs_forward(P, params, cfg, prompt, torch.cat([tok, toks[:, :8]], 1), False)
    log(f"fp decode-vs-forward: max rel logit error {rel:.3e} over 8 steps (limit 0.15)")
    if not rel < 0.15:
        raise AssertionError(f"fp decode/forward divergence: rel err {rel:.4f}")
    if profile:
        profile_decode(P, params, cache, toks[:, -1:], 128 + 2 * n_steps, cfg, card)
    del cache
    torch.cuda.empty_cache()
    serve_and_compare(P, params, cfg, card, "serve fp", counts, FP_MUST, quantized_cache=False,
                      never=B5_KEYS)
    if profile:
        profile_serving(P, params, cfg, serve_requests(16, cfg.vocab_size), 16, card,
                        bits=(False,))
    torch.cuda.empty_cache()
    return sum_counts(counts)


def build_rtn_params(P):
    """Llama-3-8B with seeded random-normal weights RTN-quantized to W4 g128
    packed, on the card. The synthetic packed codes (uniform nibbles, zero
    point 8) give every linear a mean code offset of -0.5, a rank-1 bias
    under which the logits barely depend on the input (one argmax at every
    position); these weights keep token streams input-dependent, so that
    comparing them tests something."""
    import torch

    cfg = P.LLAMA3_8B
    t0 = time.time()
    fp = P.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 4))
    params = P.quantize_model_rtn(fp, cfg, P.QuantSpec(n_bits=4, group_size=GS), pack=True)
    del fp
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"RTN W4 g128 params (random-normal weights) built on the card in "
        f"{time.time() - t0:.2f} s")
    return params


def drive_rtn_checks(P, params, card):
    """The serving path on input-dependent weights: the 16-request int8 run
    pipelined against the sequential loop (streams that vary); then, as
    checks whose launches are left out of the returned counts,
    teacher-forced decode against the forward on int8 and int4 caches and
    `decode_drift`."""
    import torch

    cfg, counts = P.LLAMA3_8B, {}
    reqs = serve_requests(16, cfg.vocab_size)
    pipe = serve_and_compare(P, params, cfg, card, "RTN serve int8", counts, PALLAS_MUST,
                             min_distinct=64)
    torch.cuda.empty_cache()
    total = sum_counts(counts)

    # checks, not paths: their launches stay out of the kernels line
    checks = {}
    prompt = torch.tensor([reqs[0][0][:48]], device="cuda")
    cont = torch.tensor([pipe[0][:9]], device="cuda")
    rel8 = run_counted(checks, "RTN int8 decode_step x 8 (check)",
                       lambda: decode_vs_forward(P, params, cfg, prompt, cont, 8),
                       must=("B1", "B5"))
    rel4 = run_counted(checks, "RTN int4 decode_step x 8 (check)",
                       lambda: decode_vs_forward(P, params, cfg, prompt, cont, 4),
                       must=("B1", "B5.int4"))
    log(f"RTN weights: decode-vs-forward max rel logit error {rel8:.3e} (int8 KV, limit 0.15), "
        f"{rel4:.3e} (int4 KV: its 7-level codes, reported)")
    if not rel8 < 0.15:
        raise AssertionError(f"RTN int8 decode/forward divergence: rel err {rel8:.4f}")
    decode_drift(P, params, cfg, card)
    return total


def drive_rtn_fp(P, params, card):
    """The fp-cache entry points on input-dependent weights: the default
    engine (pipelined against sequential, varied streams), `sample_generate`,
    `speculative_generate` and a greedy decode under KV4 fake quant."""
    import torch

    cfg, counts = P.LLAMA3_8B, {}
    serve_and_compare(P, params, cfg, card, "RTN serve fp", counts, FP_MUST, min_distinct=64,
                      quantized_cache=False, never=B5_KEYS)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")

    def prefilled(rq=None):
        cache = P.init_kv_cache(cfg, 1, 512)
        lg, _ = P.decode_step(params, cache, prompt, 0, cfg, rq or P.NO_QUANT)
        return cache, lg[:, -1].argmax(dim=-1)[:, None]

    # sampling: temperature 0 is greedy; a seed repeats its stream
    cache, first = prefilled()
    greedy, _ = P.greedy_generate(params, cache, first, 128, 16, cfg)

    def sample(temperature, seed):
        c, f = prefilled()
        g = torch.Generator(device="cuda").manual_seed(seed)
        return P.sample_generate(params, c, f, 128, 16, cfg, g, temperature=temperature,
                                 top_p=0.9)[0]

    s0 = run_counted(counts, "RTN sample_generate 16 steps, temperature 0",
                     lambda: sample(0.0, 1), must=("B1", "B6"), never=B5_KEYS)
    s1, s2 = (run_counted(counts, f"RTN sample_generate 16 steps, temperature 0.8 ({i})",
                          lambda: sample(0.8, 5), must=("B1", "B6"), never=B5_KEYS)
              for i in (1, 2))
    log(f"RTN sample_generate: temperature 0 {'==' if torch.equal(s0, greedy) else '!='} "
        f"greedy_generate; two runs of seed 5 at 0.8 / top-p 0.9 "
        f"{'identical' if torch.equal(s1, s2) else 'differ'}; {len(set(s1[0].tolist()))} distinct "
        f"tokens in 16")
    if not (torch.equal(s0, greedy) and torch.equal(s1, s2)):
        raise AssertionError("sample_generate: temperature 0 is not greedy, or a seed did not repeat")
    drive_speculative(P, params, cfg, card, counts, prompt, prefilled)

    # KV4 fake quant on the fp cache: the eager route, no decode kernel
    rq = P.RuntimeQuantConfig(k=P.QuantSpec(n_bits=4), v=P.QuantSpec(n_bits=4))
    cache, first = prefilled(rq)
    toks, _ = run_counted(counts, "RTN KV4-hooked greedy_generate 8 steps",
                          lambda: P.greedy_generate(params, cache, first, 128, 8, cfg, rq),
                          must=("B1",), never=B5_KEYS + ("B6", "B6.f32"))
    rel = decode_vs_forward(P, params, cfg, prompt, torch.cat([first, toks], 1), False, rq)
    log(f"RTN KV4-hooked decode (asymmetric per-token 4-bit K/V fake quant on the fp cache): "
        f"decode-vs-forward under the same hooks max rel logit error {rel:.3e} (limit 0.15)")
    if not rel < 0.15:
        raise AssertionError(f"KV4-hooked decode/forward divergence: rel err {rel:.4f}")
    torch.cuda.empty_cache()
    return sum_counts(counts)


def drive_speculative(P, params, cfg, card, counts, prompt, prefilled, n_rounds=8, k=4):
    """`speculative_generate` with the model as its own draft after a
    128-token prefill of both caches. Each emitted token must be the argmax
    of the teacher-forced `forward_logits`, except where the forward's top-2
    gap is below the decode-vs-forward error on the same tokens (the verify
    pass and the draft's steps sum in other orders); more than one such
    position fails."""
    import torch

    cache, first = prefilled()
    dcache, _ = prefilled()
    (toks, cnt, _, _, pos), dt = run_counted(
        counts, f"RTN speculative_generate {n_rounds} rounds k={k}",
        lambda: timed(lambda: P.speculative_generate(params, params, cache, dcache, first, 128,
                                                     n_rounds, k, cfg)),
        must=("B1", "B6"), never=B5_KEYS)
    spec = P.flatten_speculative(toks, cnt)
    log(f"RTN speculative ({n_rounds} rounds, k={k}, draft = target): {len(spec)} tokens, "
        f"{float(cnt.float().mean()):.2f} emitted and {float(cnt.float().mean()) - 1:.2f} drafts "
        f"accepted per round (counts {cnt.tolist()}), {len(spec) / dt:.2f} tok/s host clock  "
        f"[{card}]")
    if pos != 128 + len(spec):
        raise AssertionError(f"speculative: final position {pos} != {128 + len(spec)}")
    cont = torch.cat([first, torch.tensor([spec[:-1]], device="cuda")], dim=1)
    full = P.forward_logits(params, torch.cat([prompt, cont], 1), cfg)[0, 128:].float()
    dec = teacher_forced(P, params, cfg, prompt, cont, False)
    err = float((dec - full).abs().max())
    top2 = full.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    pred = full.argmax(dim=-1).tolist()
    near_ties = []
    for i, (t, p, gap) in enumerate(zip(spec, pred, gaps)):
        if t == p:
            continue
        log(f"  speculative position {i}: emitted {t}, forward argmax {p}, top-2 gap {gap:.4f}, "
            f"decode-vs-forward abs error {err:.4f}")
        if gap >= err:
            raise AssertionError(f"speculative token {i} is not the forward's argmax off a near tie")
        near_ties.append(i)
    log(f"RTN speculative: {len(spec) - len(near_ties)} of {len(spec)} tokens are the forward's "
        f"argmax, {len(near_ties)} at near ties (limit 1); decode-vs-forward abs error {err:.4f}")
    if len(near_ties) > 1:
        raise AssertionError(f"speculative: {len(near_ties)} tokens off the forward's argmax")


#: limit on the full-depth decode through the B5 kernel forms against the
#: same decode through their plain versions (max relative logit error).
#: On an H100 the sound kernel forms read 1.46e-2 (int8) and 1.51e-2
#: (int4); an int4 form that quantizes q and p*v_s against amax 127 instead
#: of 119 reads 2.78e-2, one that swaps the K nibbles 0.59.
DRIFT_LIMIT = 2e-2


def decode_drift(P, params, cfg, card):
    """Teacher-forced decode (48-token prefill, then 9 seeded tokens) at
    full width and depth through the B5 kernel forms (int8 and int4 cache)
    and B6 (bf16 fp cache) against the same decode through their plain
    versions. Per call the two agree to about an ulp (the kernels sum in a
    tree), but a bf16 attention output that rounds the other way compounds
    over 32 layers."""
    import torch

    from llama3_quantization_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    toks = torch.randint(0, cfg.vocab_size, (1, 57), generator=gen, device="cuda")
    prompt, cont = toks[:, :48], toks[:, 48:]
    for bits, kid, name, kv in ((8, "B5", "decode_s8", "int8"), (4, "B5", "decode_s8", "int4"),
                                (False, "B6", "decode_fp", "bf16 fp")):
        kern = teacher_forced(P, params, cfg, prompt, cont, bits)
        orig = getattr(da, name)
        setattr(da, name, getattr(da, f"{name}_plain"))
        try:
            plain = teacher_forced(P, params, cfg, prompt, cont, bits)
        finally:
            setattr(da, name, orig)
        rel = float((kern - plain).abs().max() / plain.abs().max())
        log(f"RTN weights, {kv} KV: decode logits through the {kid} kernel vs its plain "
            f"version: max rel err {rel:.3e} over {cont.shape[1]} steps (limit {DRIFT_LIMIT:g})"
            f"  [{card}]")
        if not (bool(kern.isfinite().all()) and rel < DRIFT_LIMIT):
            raise AssertionError(f"RTN {kv} KV: kernel and plain decode differ, rel err {rel}")


def sum_counts(counts):
    """Launches by kernel form summed over the runs in `counts`."""
    from llama3_quantization_tpu_torch.ops import launches

    for path, c in counts.items():
        log(f"launches in {path}: {json.dumps(c)}")
    return {key: sum(c[key] for c in counts.values()) for key in launches.COUNTS}


def drive_v3_path(P, params, card):
    """The JAX package's own route to its v3 kernel, `L3Q_QMM_V=3` under the
    pallas backend, on the synthetic W4 g128 model: a 128-token prefill
    (B3's tiled form on the packed weights) and 8 greedy steps (B3.v3)."""
    import os

    import torch

    cfg, counts = P.LLAMA3_8B, {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")
    cache = P.init_kv_cache(cfg, 1, 512, quantized=8)
    os.environ["L3Q_QMM_V"] = "3"
    try:
        lg, _ = run_counted(counts, "v3 prefill 128 (L3Q_QMM_V=3)",
                            lambda: P.decode_step(params, cache, prompt, 0, cfg), must=("B3.gemm",))
        tok = lg[:, -1].argmax(dim=-1)[:, None]
        (toks, _), dt = run_counted(
            counts, "v3 greedy_generate 8 steps (L3Q_QMM_V=3)",
            lambda: timed(lambda: P.greedy_generate(params, cache, tok, 128, 8, cfg)),
            must=("B3.v3", "B5"))
    finally:
        del os.environ["L3Q_QMM_V"]
    if not (bool(lg.isfinite().all()) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
        raise AssertionError("v3 path: non-finite logits or tokens out of range")
    log(f"v3 decode (L3Q_QMM_V=3): {8 / dt:.2f} tok/s (8 steps, batch 1, first call, host clock)"
        f"  [{card}]")
    del cache
    return sum_counts(counts)


#: depth of the W3 forward (of Llama-3-8B's 32 layers), cut for time
W3_LAYERS = 4


def drive_w3_forward(P, card):
    """`forward_logits` on [1, 128] through 3-bit B2 at full Llama-3-8B width,
    W3_LAYERS layers deep: seeded random-normal weights RTN W3 g128 packed
    in bit planes. Then, as a check whose launches are not counted, the same
    forward through B2's plain version."""
    import dataclasses

    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    cfg, counts = dataclasses.replace(P.LLAMA3_8B, num_layers=W3_LAYERS), {}
    fp = P.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 8))
    params = P.quantize_model_rtn(fp, cfg, P.QuantSpec(n_bits=3, group_size=GS), pack=True)
    del fp
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")
    logits = run_counted(counts, f"W3 forward_logits [1,128] ({W3_LAYERS} layers)",
                         lambda: P.forward_logits(params, prompt, cfg), must=("B2.w3", "B7"))
    if tuple(logits.shape) != (1, 128, cfg.vocab_size) or not bool(logits.isfinite().all()):
        raise AssertionError("W3 forward_logits: bad shape or non-finite")
    orig, fq.qmm_gemm = fq.qmm_gemm, fq.qmm_gemm_plain
    try:
        ref = P.forward_logits(params, prompt, cfg)
    finally:
        fq.qmm_gemm = orig
    rel = float((logits.float() - ref.float()).abs().max() / ref.float().abs().max())
    log(f"W3 g128 forward ({W3_LAYERS} layers): logits through 3-bit B2 vs its plain version: max "
        f"rel err {rel:.3e} (limit {W3_LIMIT:g})  [{card}]")
    if not rel < W3_LIMIT:
        raise AssertionError(f"W3 forward: kernel and plain differ, rel err {rel}")
    del params
    torch.cuda.empty_cache()
    return sum_counts(counts)


#: limit on the W3 forward's logits through 3-bit B2 against B2's plain
#: version (max relative error; bf16 activations between layers)
W3_LIMIT = 2e-2


def drive_s4_decode(P, card, profile=False):
    """The s4 decode headline (bench.py:532-580) at full Llama-3-8B width and
    depth: synthetic W4 g128 packed with an s4 head, `fuse_for_decode`, the
    s4 backend; a 128-token prefill into an int8 cache of 512 slots, then
    `greedy_generate` of 32 steps at batch 1; teacher-forced decode against
    `forward_logits` (max relative logit error < 0.15, bench.py:584-613)."""
    import torch

    cfg, counts = P.LLAMA3_8B, {}
    t0 = time.time()
    params = P.init_quantized_params(cfg, P.QuantSpec(n_bits=4, group_size=GS), seed=SEED,
                                     head_s4=True)
    params = P.fuse_for_decode(params, cfg)
    torch.cuda.synchronize()
    log(f"s4 params (W4 g128 packed, s4 head, fused) built in {time.time() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")
    with P.backend("s4"):
        prepared, t_prep = timed(lambda: P.prepare_decode_params(params))
        log(f"prepare_decode_params (s4): {t_prep * 1e3:.1f} ms host clock, once per "
            f"greedy_generate call  [{card}]")
        cache = P.init_kv_cache(cfg, 1, 512, quantized=8)
        (lg, _), t_pre = run_counted(
            counts, "s4 prefill 128 into int8 cache",
            lambda: timed(lambda: P.decode_step(params, cache, prompt, 0, cfg)), must=("B3.gemm",))
        tok = lg[:, -1].argmax(dim=-1)[:, None]
        (toks, _), t_dec = run_counted(
            counts, "s4 greedy_generate 32 steps",
            lambda: timed(lambda: P.greedy_generate(params, cache, tok, 128, 32, cfg)),
            must=("B3.s4", "B5"))
        _, t_dec2 = timed(lambda: P.greedy_generate(params, cache, toks[:, -1:], 160, 32, cfg))
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise AssertionError("s4 greedy_generate: tokens out of range")
        log(f"s4 prefill: {128 / t_pre:.1f} tok/s (128 tokens, first call, host clock)  [{card}]")
        for what, t in (("first call", t_dec), ("second call", t_dec2)):
            log(f"s4 decode: {32 / t:.2f} tok/s ({t / 32 * 1e3:.3f} ms/token over 32 steps, batch 1,"
                f" int8 KV of 512 slots, {what}, prepare included, host clock)  [{card}]")
        rel = decode_vs_forward(P, prepared, cfg, prompt, torch.cat([tok, toks[:, :8]], 1), 8)
        if profile:
            profile_decode(P, params, cache, toks[:, -1:], 192, cfg, card)
    log(f"s4 decode-vs-forward: max rel logit error {rel:.3e} over 8 steps (limit 0.15)")
    if not rel < 0.15:
        raise AssertionError(f"s4 decode/forward divergence: rel err {rel:.4f}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, prepared, cache
    torch.cuda.empty_cache()
    return sum_counts(counts)


def serve_and_compare(P, params, cfg, card, label, counts, must, fuse=False, min_distinct=0,
                      quantized_cache=8, never=()):
    """`ServingEngine(8 slots, max_len 512, ljf, quantized_cache, fuse)`:
    `run_pipelined(16)` on the 16 requests of the serve mix (after a warm-up
    request) against the sequential `step_n(16)` loop, both counted runs
    that must launch the kernel forms `must` and none of `never`. Returns
    the pipelined streams."""
    k, reqs = 16, serve_requests(16, cfg.vocab_size)
    eng = P.ServingEngine(params, cfg, max_slots=8, max_len=512, quantized_cache=quantized_cache,
                          schedule="ljf", fuse=fuse)
    pipelined_streams(eng, [(reqs[0][0][:20], 2 * k)], k)  # warm-up: first calls, allocations
    warm_steps = eng.dispatches["steps"]
    pipe, dt = run_counted(counts, f"{label} run_pipelined",
                           lambda: timed(lambda: pipelined_streams(eng, reqs, k)), must=must,
                           never=never)
    check_streams(f"{label} run_pipelined", pipe, reqs, cfg.vocab_size)
    produced, distinct = sum(map(len, pipe)), len({t for st in pipe for t in st})
    log(f"served ({label}): {produced / dt:.1f} tok/s ({produced} tokens of 16 requests in "
        f"{dt:.2f} s, {1e3 * dt / (eng.dispatches['steps'] - warm_steps):.1f} ms per 8-slot "
        f"decode step, run_pipelined({k}), host clock; windows by route "
        f"{json.dumps(eng.dispatches)} with the warm-up); {distinct} distinct tokens  [{card}]")
    if distinct < min_distinct:
        raise AssertionError(f"{label}: streams hold only {distinct} distinct tokens")
    seq, dt_seq = run_counted(counts, f"{label} step_n loop",
                              lambda: timed(lambda: sequential_streams(eng, reqs, k)), must=must,
                              never=never)
    log(f"{label} sequential step_n({k}) loop: {produced / dt_seq:.1f} tok/s ({dt_seq:.2f} s, "
        f"host clock)  [{card}]")
    if seq != pipe:
        diff = sum(a != b for a, b in zip(seq, pipe))
        raise AssertionError(f"{label}: run_pipelined and step_n streams differ ({diff} of 16)")
    log(f"{label}: run_pipelined streams == sequential step_n streams for all 16 requests")
    return pipe


#: kernel forms a pallas serving run must launch (B1 decode, B2 prefills,
#: B5 with stats in the windowed steps) and a fused a8 one (B3's GEMV and
#: tiled forms in their place)
PALLAS_MUST = ("B1", "B2", "B5.stats")
A8_MUST = ("B3.s8", "B3.gemm", "B5.stats")


def drive_a8_serving(P, card, profile=False):
    """Fused a8 serving (bench.py serving_bench, :259-392): synthetic
    per-column s8 weights with an s8 head under the a8 backend."""
    import torch

    cfg, counts = P.LLAMA3_8B, {}
    t0 = time.time()
    params = P.init_quantized_params(cfg, P.QuantSpec(n_bits=4, group_size=GS), seed=SEED,
                                     pack=False, percol_s8=True, head_s8=True)
    torch.cuda.synchronize()
    log(f"a8 params (per-column s8, s8 head) built in {time.time() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    with P.backend("a8"):
        serve_and_compare(P, params, cfg, card, "a8 fused serve", counts, A8_MUST, fuse=True)
        if profile:
            profile_serving(P, params, cfg, serve_requests(16, cfg.vocab_size), 16, card,
                            bits=(8,), fuse=True)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params
    torch.cuda.empty_cache()
    return sum_counts(counts)


def drive_rtn_a8(P, params, card):
    """Fused a8 serving on input-dependent weights: the RTN W4 g128 model
    recoded per column with `recode_model_s8(include_head=True)`; then, as a
    check, the s4 decode drift through B3 (`decode_drift_b3`)."""
    import torch

    cfg, counts = P.LLAMA3_8B, {}
    rec, t_rec = timed(lambda: P.recode_model_s8(params, cfg, include_head=True))
    log(f"recode_model_s8 of the RTN model (head included): {t_rec:.2f} s host clock  [{card}]")
    with P.backend("a8"):
        serve_and_compare(P, rec, cfg, card, "RTN a8 fused serve", counts, A8_MUST, fuse=True,
                          min_distinct=64)
    del rec
    torch.cuda.empty_cache()
    total = sum_counts(counts)
    decode_drift_b3(P, params, cfg, card)
    return total


#: limit on the full-depth s4 decode through B3 against the same decode
#: through B3's plain version (max relative logit error)
B3_DRIFT_LIMIT = 1e-6


def decode_drift_b3(P, params, cfg, card):
    """Teacher-forced decode under the s4 backend (48-token prefill, then 9
    seeded tokens) at full width and depth through B3 against the same
    decode through B3's plain version. Both compute the same s32 integers
    and the same fp32 epilogue in the same order."""
    import torch
    from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    toks = torch.randint(0, cfg.vocab_size, (1, 57), generator=gen, device="cuda")
    prompt, cont = toks[:, :48], toks[:, 48:]
    with P.backend("s4"):
        prepared = P.prepare_decode_params(params)
        kern = teacher_forced(P, prepared, cfg, prompt, cont, 8)
        orig = qa.a8_gemv, qa.a8_gemm
        qa.a8_gemv = lambda xq, s_x, *w: qa.a8_plain(xq, s_x, *w[:-1])  # drop the launch key
        qa.a8_gemm = qa.a8_plain
        try:
            plain = teacher_forced(P, prepared, cfg, prompt, cont, 8)
        finally:
            qa.a8_gemv, qa.a8_gemm = orig
    rel = float((kern - plain).abs().max() / plain.abs().max())
    log(f"RTN weights, s4 backend, int8 KV: decode logits through B3 vs its plain version: max "
        f"rel err {rel:.3e} over {cont.shape[1]} steps (limit {B3_DRIFT_LIMIT:g})  [{card}]")
    if not (bool(kern.isfinite().all()) and rel < B3_DRIFT_LIMIT):
        raise AssertionError(f"RTN s4: B3 and its plain version differ, rel err {rel}")


def profile_serving(P, params, cfg, reqs, k, card, bits=(8, 4), fuse=False):
    """Device time by kernel over one full serving window (8 active slots,
    `step_n(k)`) on each cache of `bits` (8, 4, False: fp), the device's busy
    share of it, and the host time per step without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for nbits in bits:
        eng = P.ServingEngine(params, cfg, max_slots=8, max_len=512, quantized_cache=nbits,
                              fuse=fuse)
        eng.add_requests([(p, 10 * k, None) for p, _ in reqs[:8]])
        eng.step_n(k)  # warm
        _, plain_s = timed(lambda: eng.step_n(k))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall_s = timed(lambda: eng.step_n(k))
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.device_time_total for e in kernels)
        if busy_us <= 0:
            log("profile: the profiler saw no device time")
            return
        log(f"profile of one serving window ({k} steps x 8 slots, "
            f"{f'int{nbits}' if nbits else 'bf16 fp'} KV"
            f"{', fused, backend ' + P.get_backend() if fuse else ''}): "
            f"{1e3 * plain_s / k:.3f} ms/step unprofiled; profiled wall {1e3 * wall_s / k:.3f} "
            f"ms/step, device busy {busy_us / k / 1e3:.3f} ms/step "
            f"({100 * busy_us / (wall_s * 1e6):.1f}% of profiled wall, "
            f"{100 * busy_us / (plain_s * 1e6):.1f}% of unprofiled)  [{card}]")
        for e in sorted(kernels, key=lambda e: -e.device_time_total)[:12]:
            log(f"  {e.device_time_total / k:9.1f} us/step  {e.count // k:5d} calls/step  "
                f"{e.key[:90]}")
        del eng
        torch.cuda.empty_cache()


def prefill_bench(P, card):
    """B2's device time at M = 128, 512 and 2048 on every decoder linear
    shape, and `forward_logits` on [1, 512] and [1, 2048] tokens of the
    synthetic Llama-3-8B W4 g128. Only the checkout's own package is
    imported, so running this script from two checkouts in one call
    compares their B2 K-split policies on one card."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for label, (k, n) in LINEAR_SHAPES.items():
        qts = rand_weights(P, k, n, 4, gen)
        for m in (128, 512, 2048):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            ms = time_ms(lambda i: fq.qmm_gemm(x, qts[i % 4], torch.bfloat16), 50)
            log(f"prefill bench: B2 {label} M={m}: {ms:.4f} ms device time  [{card}]")
        del qts
    params, cfg = build_params(P), P.LLAMA3_8B
    for s in (512, 2048):
        toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device="cuda")
        ms = time_ms(lambda i: P.forward_logits(params, toks, cfg), 5, warmup=2)
        _, dt = timed(lambda: P.forward_logits(params, toks, cfg))
        log(f"prefill bench: forward_logits [1, {s}]: {ms:.3f} ms device time "
            f"({s / ms * 1e3:.0f} tok/s), {dt * 1e3:.3f} ms host clock  [{card}]")


def time_kernels(P, card, launches_total, errs, probes_only=False):
    """Per-kernel ms beside plain ms, bound and library yardstick (only the
    weight-stream probes' with `probes_only`)."""
    import torch
    import torch.nn.functional as F
    from llama3_quantization_tpu_torch.ops import decode_attention as da
    from llama3_quantization_tpu_torch.ops import flash_attention as fa
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def add(kid, name, source, replaces, shape, ms, plain_ms, nbytes, ops, peak, lib_ms, err):
        b_ms, by = bound_ms(nbytes, ops, peak)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": shape, "launches": launches_total[kid], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms,
        }
        log(f"{kid} {name} {shape}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({by}), library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}  [{card}]")
        return row

    if probes_only:
        return time_probes(P, card, launches_total, errs, add)
    # B1/B2: four weight copies per shape cycle through so each call finds
    # its weights cold in the 50 MB L2, as a decode step does
    qmm_rows = {}
    for label, (k, n) in LINEAR_SHAPES.items():
        qts = rand_weights(P, k, n, 4, gen)
        wd = [fq.dequant_bf16(qt) for qt in qts]
        g = k // GS
        for kid, m, kern, plain, name in (
            ("B1", 1, fq.qmm_gemv, fq.qmm_gemv_plain, "qmm_gemv"),
            ("B1", 8, fq.qmm_gemv, fq.qmm_gemv_plain, "qmm_gemv M=8"),
            ("B2", 128, fq.qmm_gemm, fq.qmm_gemm_plain, "qmm_gemm"),
        ):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            ms = time_ms(lambda i: kern(x, qts[i % 4], torch.bfloat16), 100)
            plain_ms = time_ms(lambda i: plain(x, qts[i % 4], torch.bfloat16), 10)
            lib_ms = time_ms(lambda i: torch.matmul(x, wd[i % 4]), 100)
            nbytes = k * n // 2 + 2 * g * n * 4 + m * k * 2 + m * n * 2
            row = add(kid, name, "llama3_quantization_tpu_torch/csrc/qmatmul.cu",
                      "llama3_quantization_tpu/ops/pallas_qmatmul.py:192" if kid == "B1"
                      else "llama3_quantization_tpu/ops/pallas_qmatmul.py:54",
                      f"{label} x[{m},{k}] W4g128[{k},{n}]", ms, plain_ms, nbytes,
                      2.0 * m * k * n, BF16_FLOPS, lib_ms, errs[kid][f"{label} M={m}"])
            qmm_rows.setdefault(name, []).append(row)
        del qts, wd

    # every B5 form at its path's batch (B5: batch-1 decode; the others:
    # the 8-slot engine), T = 512 and 2048; enough layers of cache (32 MB
    # and up) cycle through that each call reads its layer cold
    g, rep, d = 8, 4, 128
    form_rows = {}
    for int4, stats in FORMS:
        key = da.launch_key(int4, stats)
        b, layers = (1, 32) if key == "B5" else (8, 8)
        out_dtype = torch.float32 if stats else torch.bfloat16  # as the paths ask
        for t in (512, 2048):
            block_t = 1024 if t % 1024 == 0 else 512
            kq, ks, vq, vs = rand_cache(P, b, g, t, d, layers, gen, int4)
            q = torch.randn((b, 1, g * rep, d), generator=gen, device="cuda").to(torch.bfloat16)
            mask = decode_mask(b, t)

            def call(fn, i):
                li = i % layers
                return fn(q, kq[li], ks[li], vq[li], vs[li], mask, out_dtype, block_t, stats)

            ms = time_ms(lambda i: call(da.decode_s8, i), 200)
            plain_ms = time_ms(lambda i: call(da.decode_s8_plain, i), 10)
            code_bytes = d // 2 if int4 else d
            nbytes = (2 * b * g * t * (code_bytes + 4) + b * g * rep * d * 2 + b * t * 4
                      + b * g * rep * d * (4 if stats else 2) + (2 * b * g * rep * 4 if stats else 0))
            form_rows.setdefault(key, []).append(add(
                key, "decode_s8" + ("_int4" if int4 else "") + ("_stats" if stats else ""),
                "llama3_quantization_tpu_torch/csrc/decode_attention.cu",
                "llama3_quantization_tpu/ops/decode_attention.py:274",
                f"B={b} G={g} rep={rep} D={d} T={t} {'int4' if int4 else 'int8'}"
                f"{' stats' if stats else ''}", ms, plain_ms, nbytes,
                4.0 * b * g * rep * t * d, INT8_OPS, None, errs[key][f"B={b} T={t}"]))
            del kq, ks, vq, vs

    # B6 at the fp paths' shapes: stacked at B=1 (decode), T=512 and 2048,
    # per layer at B=8 (the engine), T=512; 32 / 8 layers of cache (64 MB
    # and up) cycle through so that each call reads its layer cold
    b6_rows = []
    for b, t, layers, stacked in ((1, 512, 32, True), (1, 2048, 32, True), (8, 512, 8, False)):
        bt = 1024 if t % 1024 == 0 else 512
        k = torch.randn((layers, b, g, t, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((layers, b, g, t, d), generator=gen, device="cuda").to(torch.bfloat16)
        q = torch.randn((b, 1, g * rep, d), generator=gen, device="cuda").to(torch.bfloat16)
        mask = decode_mask(b, t)
        qh, amask = q.reshape(b, g * rep, 1, d), mask[:, None, None, :]
        ms = time_ms(lambda i: da.decode_fp(q, k[i % layers], v[i % layers], mask, bt), 200)
        plain_ms = time_ms(lambda i: da.decode_fp_plain(q, k[i % layers], v[i % layers], mask, bt),
                           10)
        lib_ms = time_ms(lambda i: F.scaled_dot_product_attention(
            qh, k[i % layers], v[i % layers], attn_mask=amask, enable_gqa=True), 200)
        nbytes = 2 * b * g * t * d * 2 + 2 * b * g * rep * d * 2 + b * t * 4
        b6_rows.append(add(
            "B6", "decode_fp" + ("" if stacked else " per-layer"),
            "llama3_quantization_tpu_torch/csrc/decode_fp.cu",
            "llama3_quantization_tpu/ops/decode_attention.py:" + ("379" if stacked else "37"),
            f"B={b} G={g} rep={rep} D={d} T={t} bf16 {'stacked' if stacked else 'per-layer'} "
            f"(library: SDPA, enable_gqa, float mask)", ms, plain_ms, nbytes,
            4.0 * b * g * rep * t * d, BF16_FLOPS, lib_ms, errs["B6"][f"B={b} T={t}"]))
        del k, v

    b7_rows = []
    for s in (128, 2048):
        q = torch.randn((1, s, 32, 128), generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn((1, s, 8, 128), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((1, s, 8, 128), generator=gen, device="cuda").to(torch.bfloat16)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms(lambda i: fa.flash_attention_cuda(q, k, v), 50)
        plain_ms = time_ms(lambda i: fa.attention_plain(q, k, v), 5)
        lib_ms = time_ms(lambda i: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True), 50)
        nbytes = 2 * s * 128 * (32 + 2 * 8 + 32)
        ops = 4.0 * 32 * 128 * s * (s + 1) / 2
        b7_rows.append(add("B7", "flash_attn_fwd", "llama3_quantization_tpu_torch/csrc/flash_attention.cu",
                           "llama3_quantization_tpu/models/transformer.py:168",
                           f"B=1 S={s} H=32 G=8 D=128 bf16 causal", ms, plain_ms, nbytes, ops,
                           BF16_FLOPS, lib_ms, errs["B7"][f"S={s}"]))
    b3_rows = time_b3(P, gen, add, errs)
    w3_rows = time_b2_w3(P, gen, add, errs)
    # one row per kernel form in the summary line (B1 at both of its path
    # instantiations, M=1 and M=8; B6 stacked at B=1 and per layer at B=8),
    # at the main path's heaviest shape (B1/B2: gate/up; B3: fused gate-up)
    # or its own length (B5 forms and B6: T=512, B7: S=128); the lines above
    # hold the other shapes. The B1 rows share B1's one count, the B6 rows
    # B6's.
    probe_rows = time_probes(P, card, launches_total, errs, add)
    return ([rows_[2] for rows_ in qmm_rows.values()] + [rows_[0] for rows_ in form_rows.values()]
            + [b6_rows[0], b6_rows[2], b7_rows[0]] + b3_rows + w3_rows + probe_rows)


def b3_dequant_bf16(w, k):
    """A B3 weight form dequantized to bf16 [K, N] (the library yardstick's
    pre-dequantized weight)."""
    import torch
    from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa

    data, layout, scale, zero, gs = w
    g = k // gs
    c = qa.codes_of(data, layout, k, gs).float().reshape(g, gs, -1)
    if zero is not None:
        c = c - zero.float()[:, None, :]
    return (c * scale[:, None, :]).reshape(k, -1).to(torch.bfloat16)


def b3_bytes(w, m, k):
    """Bytes B3 must move: codes, scale and zero, s8 activations and their
    scales, bf16 output."""
    data, _, scale, zero, _ = w
    zb = 0 if zero is None else zero.numel() * zero.element_size()
    return data.numel() + 4 * scale.numel() + zb + m * k + 4 * m + 2 * m * data.shape[-1]


#: (form, M) of the B3 timings: the decode forms at batch 1 and the serving
#: step's 8 slots, the tiled form at a 128-token prefill
B3_TIMED = (("B3.v3", 1), ("B3.v3", 8), ("B3.s4", 1), ("B3.s4", 8), ("B3.s8", 1), ("B3.s8", 8),
            ("B3.s4", 128), ("B3.s8", 128))
#: the form and M of each B3 row in the kernels line (shape: fused gate-up)
B3_ROWS = {("B3.v3", 1): "B3.v3", ("B3.s4", 1): "B3.s4", ("B3.s8", 8): "B3.s8",
           ("B3.s4", 128): "B3.gemm"}


def time_b3(P, gen, add, errs):
    """B3's forms on every W·A8 linear shape and the heads: device ms beside
    the plain version, the bound (bytes, or 2MKN int8 operations) and the
    library yardstick: `torch._int_mm` on the s8 codes where it runs (M > 16),
    else `torch.matmul` against a pre-dequantized bf16 weight. Four weight
    copies cycle through the 50 MB L2."""
    import torch
    from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa

    rows = []
    src = "llama3_quantization_tpu_torch/csrc/qmatmul_a8.cu"
    tpu = "llama3_quantization_tpu/ops/pallas_qmatmul.py:268"
    for label, (k, n) in list(B3_SHAPES.items()) + [("head", HEAD_SHAPE)]:
        forms = (head_forms(P, gen) if label == "head" else b3_forms(P, k, n, 4, gen))
        forms = {key: (ws if isinstance(ws, list) else [ws]) for key, ws in forms.items()}
        wd = {key: [b3_dequant_bf16(w, k) for w in ws] for key, ws in forms.items()}
        for key, m in B3_TIMED:
            if key not in forms or (label == "head" and m > 8):
                continue
            ws, nw = forms[key], len(forms[key])
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            xq, s_x = qa.quantize_activations_s8(x)
            ms = time_ms(lambda i: b3_call(key, ws[i % nw], xq, s_x, torch.bfloat16), 100)
            plain_ms = time_ms(lambda i: qa.a8_plain(xq, s_x, *ws[i % nw], torch.bfloat16), 5)
            lib_ms, lib = None, "torch.matmul bf16"
            if ws[0][1] == "s8" and m > 16:
                try:  # the s32 dot alone, where cuBLASLt's shape rules allow
                    lib_ms = time_ms(lambda i: torch._int_mm(xq, ws[i % nw][0]), 100)
                    lib = "torch._int_mm"
                except RuntimeError as e:
                    log(f"  torch._int_mm does not take x[{m},{k}] @ [{k},{n}]: {e}")
            if lib_ms is None:
                lib_ms = time_ms(lambda i: torch.matmul(x, wd[key][i % nw]), 100)
            rkey = key if m <= qa.GEMV_MAX_M else "B3.gemm"
            layout = ws[0][1]
            row = add(rkey, f"a8_{'gemv' if m <= qa.GEMV_MAX_M else 'gemm'} {layout}", src, tpu,
                      f"{label} x[{m},{k}] {layout}[{k},{n}] (library: {lib})", ms, plain_ms,
                      b3_bytes(ws[0], m, k), 2.0 * m * k * n, INT8_OPS, lib_ms,
                      errs[rkey][f"{label} {layout} M={m}"])
            if label == "gateup" and (key, m) in B3_ROWS:
                rows.append(row)
        del forms, wd
    return rows


def time_b2_w3(P, gen, add, errs):
    """3-bit B2 at M = 128 on every decoder linear shape (RTN W3 g128, four
    copies); the kernels line takes gate/up."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    rows = []
    for label, (k, n) in LINEAR_SHAPES.items():
        qts = [P.quantize_rtn(torch.randn((k, n), generator=gen, device="cuda"),
                              P.QuantSpec(n_bits=3, group_size=GS), pack=True) for _ in range(4)]
        wd = [fq.dequant_bf16(qt) for qt in qts]
        m = 128
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        ms = time_ms(lambda i: fq.qmm_gemm(x, qts[i % 4], torch.bfloat16), 50)
        plain_ms = time_ms(lambda i: fq.qmm_gemm_plain(x, qts[i % 4], torch.bfloat16), 5)
        lib_ms = time_ms(lambda i: torch.matmul(x, wd[i % 4]), 50)
        nbytes = 3 * k * n // 8 + 2 * (k // GS) * n * 4 + m * k * 2 + m * n * 2
        row = add("B2.w3", "qmm_gemm w3", "llama3_quantization_tpu_torch/csrc/qmatmul.cu",
                  "llama3_quantization_tpu/ops/pallas_qmatmul.py:54",
                  f"{label} x[{m},{k}] W3g128[{k},{n}] bit planes", ms, plain_ms, nbytes,
                  2.0 * m * k * n, BF16_FLOPS, lib_ms, errs["B2.w3"][f"{label} M={m}"])
        if label == "gate/up":
            rows.append(row)
        del qts, wd
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after building and checking the kernels")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few decode steps (device time by kernel)")
    ap.add_argument("--prefill-bench", action="store_true",
                    help="only time B2 at M = 128, 512, 2048 and forward_logits at S = 512, "
                         "2048 (run it from two checkouts in one call to compare them)")
    ap.add_argument("--decode-drift", action="store_true",
                    help="only run the full-depth decode through the B5 kernel forms, B6 and "
                         "through B3 (s4 backend) against their plain versions")
    ap.add_argument("--microbench", action="store_true",
                    help="only check, drive and time the weight-stream probes B8-B10 through "
                         "the microbench entry points")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import llama3_quantization_tpu_torch as P
        from llama3_quantization_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.time()
    reports = _build.build_all()
    log(f"kernels built in {time.time() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    if args.prefill_bench:
        prefill_bench(P, card)
        return 0
    if args.decode_drift:
        params = build_rtn_params(P)
        decode_drift(P, params, P.LLAMA3_8B, card)
        decode_drift_b3(P, params, P.LLAMA3_8B, card)
        return 0

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    log("kernel checks against the plain versions on the card:")
    if args.microbench:
        check_probes(P, gen, errs)
        total = drive_microbench(P, card)
        rows = time_kernels(P, card, total, errs, probes_only=True)
        print(json.dumps({"kernels": rows}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
        }}), flush=True)
        return 0
    check_qmatmul(P, gen, errs)
    check_b2_w3(P, gen, errs)
    check_b3(P, gen, errs)
    check_decode_forms(P, gen, errs)
    check_fp_decode(P, gen, errs)
    check_flash(P, gen, errs)
    check_window_merge(P, gen)
    check_probes(P, gen, errs)
    torch.cuda.synchronize()
    if args.kernels_only:
        log("kernel checks passed")
        return 0

    params = build_params(P)
    paths = [drive_main_path(P, params, card, profile=args.profile),
             drive_serving(P, params, card, profile=args.profile),
             drive_fp_paths(P, params, card, profile=args.profile),
             drive_v3_path(P, params, card)]
    del params
    torch.cuda.empty_cache()
    paths.append(drive_w3_forward(P, card))
    paths.append(drive_s4_decode(P, card, profile=args.profile))
    paths.append(drive_a8_serving(P, card, profile=args.profile))
    params = build_rtn_params(P)
    paths.append(drive_rtn_checks(P, params, card))
    paths.append(drive_rtn_fp(P, params, card))
    paths.append(drive_rtn_a8(P, params, card))
    del params
    torch.cuda.empty_cache()
    paths.append(drive_microbench(P, card))
    total = {key: sum(p[key] for p in paths) for key in paths[0]}
    log(f"launches over all paths: {json.dumps(total)}")
    rows = time_kernels(P, card, total, errs)
    print(json.dumps({"kernels": rows}), flush=True)
    # the run drives one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
