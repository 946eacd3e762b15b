#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`llama3_quantization_tpu_torch`) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                 # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels-only  # build and check the kernels only
    python3 chip_smoke.py --profile       # also profile decode steps and a serving window
    python3 chip_smoke.py --prefill-bench # only time B2 and forward_logits at M up to 2048
    python3 chip_smoke.py --decode-drift  # only the full-depth B5 kernel-vs-plain decode

Phases, in order; any failure exits non-zero:
  1. require CUDA and print the card's name and power limit;
  2. build every kernel from `llama3_quantization_tpu_torch/csrc/` (one nvcc
     per source, in parallel);
  3. hold each kernel form against its plain PyTorch version on the card at
     the main paths' shapes, with the tolerances stated below: B1 at M = 1
     and 8, B2 at M = 128 and 512, B5 on
     the int8 cache with and without m/l statistics and on the int4 cache
     with and without them (one all-masked row), B7; then the window-merge
     op (B5 with stats merged with the exact window attention) against
     eager attention over the dequantized main and window keys;
  4. drive the first main path at full Llama-3-8B width and depth (W4 g128
     packed synthetic weights, bf16, 32 layers): `forward_logits` on
     [1, 128] tokens, a 128-token prefill into an int8 cache of 512 slots
     and `greedy_generate` for 32 steps; check finite logits, and decode
     against the teacher-forced forward (max relative logit error < 0.15);
  5. drive the serving path on the same model: `ServingEngine` with 8
     slots, max_len 512, `ljf`, int8 cache, `run_pipelined(16)` on 16
     requests of the serve bench's mix, which must give exactly the streams
     of the sequential `step_n(16)` loop; then the int4 cache: the engine on
     8 requests, a per-step `run()`, and `greedy_generate` of 32 steps after
     a 128-token prefill (the windowed route). Served tok/s beside the card;
  6. repeat the serving comparison on input-dependent weights (seeded
     random-normal, RTN W4 g128 packed: the synthetic codes' logits barely
     depend on the input), requiring varied streams, and check teacher-forced
     decode against the forward (int8 < 0.15, int4 reported) and the
     decode through the B5 kernel forms against their plain versions
     (< DRIFT_LIMIT); these checks' launches are not counted as a path's;
  7. time each kernel form, its plain version and a library yardstick, with
     the least time the card could take for the same work (its bound).

Each path runs with the launch counts set to 0 just before it and read
just after; a kernel form that a path should run and did not fails the
run. The line before the last is a JSON object of the kernels; the last
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


def run_counted(counts, label, fn, must=()):
    """`fn()` with every launch count set to 0 just before it and read just
    after; fails if a kernel form in `must` was not launched."""
    from llama3_quantization_tpu_torch.ops import launches

    import torch

    launches.reset()
    out = fn()
    torch.cuda.synchronize()
    counts[label] = launches.snapshot()
    missing = [k for k in must if counts[label][k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    return out


def timed(fn):
    """(fn(), host seconds), with the card synchronized on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def teacher_forced(P, params, cfg, prompt, cont, bits):
    """Logits [n, V] of `decode_step` fed `cont` token by token after a
    `prompt` prefill, on a `bits` KV cache of 512 slots."""
    import torch

    cache = P.init_kv_cache(cfg, 1, 512, quantized=bits)
    _, cache = P.decode_step(params, cache, prompt, 0, cfg)
    s, out = prompt.shape[1], []
    for i in range(cont.shape[1]):
        lg, _ = P.decode_step(params, cache, cont[:, i : i + 1], s + i, cfg)
        out.append(lg[0, 0].float())
    return torch.stack(out)


def decode_vs_forward(P, params, cfg, prompt, cont, bits):
    """Max relative logit error of teacher-forced decode on a `bits` KV
    cache against `forward_logits` over prompt + cont (bench.py:584-613)."""
    import torch

    full = P.forward_logits(params, torch.cat([prompt, cont], dim=1), cfg)[0].float()
    s = prompt.shape[1]
    dec = teacher_forced(P, params, cfg, prompt, cont[:, :-1], bits)
    return float((dec - full[s : s + dec.shape[0]]).abs().max() / full.abs().max())


def drive_main_path(P, params, card, profile=False):
    """Full-width, full-depth Llama-3-8B W4 g128 main path on the card."""
    import torch
    from llama3_quantization_tpu_torch.ops import launches

    cfg = P.LLAMA3_8B
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")
    counts = {}

    logits = run_counted(counts, "forward_logits [1,128]",
                         lambda: P.forward_logits(params, prompt, cfg), must=("B2", "B7"))
    if tuple(logits.shape) != (1, 128, cfg.vocab_size) or not bool(logits.isfinite().all()):
        raise AssertionError(f"forward_logits: bad shape {tuple(logits.shape)} or non-finite")
    log("forward_logits [1, 128]: finite, shape ok")

    cache = P.init_kv_cache(cfg, 1, 512)
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

    total = {k: sum(c[k] for c in counts.values()) for k in launches.COUNTS}
    for path, c in counts.items():
        log(f"launches in {path}: {json.dumps(c)}")
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

    eng = P.ServingEngine(params, cfg, max_slots=slots, max_len=max_len, quantized_cache=8,
                          schedule="ljf")
    pipelined_streams(eng, [(reqs[0][0][:20], 2 * k)], k)  # warm-up: first calls, allocations
    warm_steps = eng.dispatches["steps"]
    pipe, dt = run_counted(counts, "serve int8 run_pipelined",
                           lambda: timed(lambda: pipelined_streams(eng, reqs, k)),
                           must=("B1", "B2", "B5.stats"))
    check_streams("int8 run_pipelined", pipe, reqs, cfg.vocab_size)
    produced = sum(map(len, pipe))
    log(f"served (int8 KV): {produced / dt:.1f} tok/s ({produced} tokens of 16 requests in "
        f"{dt:.2f} s, {1e3 * dt / (eng.dispatches['steps'] - warm_steps):.1f} ms per 8-slot "
        f"decode step, run_pipelined({k}), host clock; windows by route "
        f"{json.dumps(eng.dispatches)} with the warm-up)  [{card}]")
    seq, dt_seq = run_counted(counts, "serve int8 step_n loop",
                              lambda: timed(lambda: sequential_streams(eng, reqs, k)),
                              must=("B1", "B2", "B5.stats"))
    log(f"sequential step_n({k}) loop: {produced / dt_seq:.1f} tok/s ({dt_seq:.2f} s, host clock)"
        f"  [{card}]")
    if seq != pipe:
        diff = sum(a != b for a, b in zip(seq, pipe))
        raise AssertionError(f"run_pipelined and step_n streams differ ({diff} of 16 differ in "
                             f"sorted order)")
    log("run_pipelined streams == sequential step_n streams for all 16 requests")
    if profile:
        profile_serving(P, params, cfg, reqs, k, card)
    del eng
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
    for path, c in counts.items():
        log(f"launches in {path}: {json.dumps(c)}")
    del cache
    torch.cuda.empty_cache()
    return {key: sum(c[key] for c in counts.values()) for key in next(iter(counts.values()))}


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

    cfg, k, counts = P.LLAMA3_8B, 16, {}
    reqs = serve_requests(16, cfg.vocab_size)
    eng = P.ServingEngine(params, cfg, max_slots=8, max_len=512, quantized_cache=8,
                          schedule="ljf")
    pipe, dt = run_counted(counts, "RTN serve int8 run_pipelined",
                           lambda: timed(lambda: pipelined_streams(eng, reqs, k)),
                           must=("B1", "B2", "B5.stats"))
    check_streams("RTN int8 run_pipelined", pipe, reqs, cfg.vocab_size)
    distinct = len({t for s in pipe for t in s})
    log(f"RTN weights: served {sum(map(len, pipe)) / dt:.1f} tok/s (first run, host clock); "
        f"{distinct} distinct tokens in the 16 streams  [{card}]")
    if distinct < 64:
        raise AssertionError(f"RTN streams hold only {distinct} distinct tokens")
    seq = run_counted(counts, "RTN serve int8 step_n loop",
                      lambda: sequential_streams(eng, reqs, k), must=("B1", "B2", "B5.stats"))
    if seq != pipe:
        diff = sum(a != b for a, b in zip(seq, pipe))
        raise AssertionError(f"RTN: run_pipelined and step_n streams differ ({diff} of 16 "
                             f"differ in sorted order)")
    log("RTN weights: run_pipelined streams == sequential step_n streams for all 16 requests")
    del eng
    torch.cuda.empty_cache()
    for path, c in counts.items():
        log(f"launches in {path}: {json.dumps(c)}")
    total = {key: sum(c[key] for c in counts.values()) for key in next(iter(counts.values()))}

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


#: limit on the full-depth decode through the B5 kernel forms against the
#: same decode through their plain versions (max relative logit error).
#: On an H100 the sound kernel forms read 1.46e-2 (int8) and 1.51e-2
#: (int4); an int4 form that quantizes q and p*v_s against amax 127 instead
#: of 119 reads 2.78e-2, one that swaps the K nibbles 0.59.
DRIFT_LIMIT = 2e-2


def decode_drift(P, params, cfg, card):
    """Teacher-forced decode (48-token prefill, then 9 seeded tokens) at
    full width and depth through the B5 kernel forms against the same
    decode through their plain versions, on the int8 and the int4 cache.
    Per call the two agree to about an ulp (the kernel sums l in a tree),
    but a bf16 attention output that rounds the other way compounds over 32
    layers."""
    import torch

    from llama3_quantization_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    toks = torch.randint(0, cfg.vocab_size, (1, 57), generator=gen, device="cuda")
    prompt, cont = toks[:, :48], toks[:, 48:]
    for bits in (8, 4):
        kern = teacher_forced(P, params, cfg, prompt, cont, bits)
        orig = da.decode_s8
        da.decode_s8 = da.decode_s8_plain
        try:
            plain = teacher_forced(P, params, cfg, prompt, cont, bits)
        finally:
            da.decode_s8 = orig
        rel = float((kern - plain).abs().max() / plain.abs().max())
        log(f"RTN weights, int{bits} KV: decode logits through the B5 kernel vs its plain "
            f"version: max rel err {rel:.3e} over {cont.shape[1]} steps (limit {DRIFT_LIMIT:g})"
            f"  [{card}]")
        if not (bool(kern.isfinite().all()) and rel < DRIFT_LIMIT):
            raise AssertionError(f"RTN int{bits}: kernel and plain decode differ, rel err {rel}")


def profile_serving(P, params, cfg, reqs, k, card):
    """Device time by kernel over one full serving window (8 active slots,
    `step_n(k)`) on the int8 and the int4 cache, the device's busy share of
    it, and the host time per step without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for bits in (8, 4):
        eng = P.ServingEngine(params, cfg, max_slots=8, max_len=512, quantized_cache=bits)
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
        log(f"profile of one serving window ({k} steps x 8 slots, int{bits} KV): "
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


def time_kernels(P, card, launches_total, errs):
    """Per-kernel ms beside plain ms, bound and library yardstick."""
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
    # one row per kernel form in the summary line (B1 at both of its path
    # instantiations, M=1 and M=8), at the main path's heaviest shape
    # (B1/B2: gate/up) or its own length (B5 forms: T=512, B7: S=128); the
    # lines above hold the other shapes. The B1 rows share B1's one count.
    return ([rows_[2] for rows_ in qmm_rows.values()] + [rows_[0] for rows_ in form_rows.values()]
            + [b7_rows[0]])


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
                    help="only run the full-depth decode through the B5 kernel forms "
                         "against their plain versions")
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
        decode_drift(P, build_rtn_params(P), P.LLAMA3_8B, card)
        return 0

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    log("kernel checks against the plain versions on the card:")
    check_qmatmul(P, gen, errs)
    check_decode_forms(P, gen, errs)
    check_flash(P, gen, errs)
    check_window_merge(P, gen)
    torch.cuda.synchronize()
    if args.kernels_only:
        log("kernel checks passed")
        return 0

    params = build_params(P)
    total = drive_main_path(P, params, card, profile=args.profile)
    serving = drive_serving(P, params, card, profile=args.profile)
    del params
    torch.cuda.empty_cache()
    params = build_rtn_params(P)
    rtn = drive_rtn_checks(P, params, card)
    del params
    torch.cuda.empty_cache()
    total = {key: total[key] + serving[key] + rtn[key] for key in total}
    log(f"launches over both paths: {json.dumps(total)}")
    rows = time_kernels(P, card, total, errs)
    print(json.dumps({"kernels": rows}), flush=True)
    # the run drives one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
