#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`llama3_quantization_tpu_torch`) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                 # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels-only  # build and check the kernels only

Phases, in order; any failure exits non-zero:
  1. require CUDA and print the card's name and power limit;
  2. build every kernel from `llama3_quantization_tpu_torch/csrc/` (one nvcc
     per source, in parallel);
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, with the tolerances stated below;
  4. drive the main path at full Llama-3-8B width and depth (W4 g128
     packed synthetic weights, bf16, 32 layers): `forward_logits` on
     [1, 128] tokens, a 128-token prefill into an int8 cache of 512 slots
     and `greedy_generate` for 32 steps, with the launch counts of every
     kernel read around it; check finite logits, and decode against the
     teacher-forced forward (max relative logit error < 0.15);
  5. time each kernel, its plain version and a library yardstick, with the
     least time the card could take for the same work (its bound).

The line before the last is a JSON object of the kernels; the last line
is `{"ok": true, "device": {...}}`.
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


def check_qmatmul(P, gen, results):
    """B1 at M=1 and B2 at M=128 on every decoder linear shape."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    for (label, (k, n)) in LINEAR_SHAPES.items():
        qt = rand_weights(P, k, n, 1, gen)[0]
        for kid, m, kern, plain in (
            ("B1", 1, fq.qmm_gemv, fq.qmm_gemv_plain),
            ("B2", 128, fq.qmm_gemm, fq.qmm_gemm_plain),
        ):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            # fp32 output: only the fp32 summation order differs
            compare(f"{kid} {label} M={m} fp32-out", kern(x, qt, torch.float32),
                    plain(x, qt, torch.float32), 1e-4)
            # bf16 output (the main path): plus one bf16 rounding
            err = compare(f"{kid} {label} M={m} bf16-out", kern(x, qt, torch.bfloat16),
                          plain(x, qt, torch.bfloat16), 1e-2)
            results.setdefault(kid, {})[label] = err


def rand_cache(P, b, g, t, d, layers, gen):
    """Quantized K/V from random normals, [L, B, G, T, *]."""
    import torch

    kv = torch.randn((2, layers, b, g, t, d), generator=gen, device="cuda")
    kq, ks = P.kv_quantize(kv[0])
    vq, vs = P.kv_quantize(kv[1])
    return kq, ks, vq, vs


def decode_mask(b, t):
    """Every slot valid except the last eighth (NEG, as the decode path gives)."""
    import torch
    from llama3_quantization_tpu_torch.ops.decode_attention import NEG

    mask = torch.zeros((b, t), dtype=torch.float32, device="cuda")
    mask[:, t - t // 8:] = NEG
    return mask


def check_decode(P, gen, results):
    """B5 at B=1, G=8, rep=4, D=128 and T in {512, 2048} (>1 T block)."""
    import torch
    from llama3_quantization_tpu_torch.ops import decode_attention as da

    b, g, rep, d = 1, 8, 4, 128
    for t in (512, 2048):
        block_t = 1024 if t % 1024 == 0 else 512
        kq, ks, vq, vs = (x[0] for x in rand_cache(P, b, g, t, d, 1, gen))
        q = torch.randn((b, 1, g * rep, d), generator=gen, device="cuda").to(torch.bfloat16)
        mask = decode_mask(b, t)
        args = (q, kq, ks, vq, vs, mask)
        # 2e-3: a 1-ulp exp difference can move one probability code by one
        compare(f"B5 T={t} fp32-out", da.decode_s8(*args, torch.float32, block_t),
                da.decode_s8_plain(*args, torch.float32, block_t), 2e-3)
        err = compare(f"B5 T={t} bf16-out", da.decode_s8(*args, torch.bfloat16, block_t),
                      da.decode_s8_plain(*args, torch.bfloat16, block_t), 1e-2)
        results.setdefault("B5", {})[f"T={t}"] = err


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


def drive_main_path(P, card, profile=False):
    """Full-width, full-depth Llama-3-8B W4 g128 main path on the card."""
    import torch
    from llama3_quantization_tpu_torch.ops import launches

    cfg = P.LLAMA3_8B
    t0 = time.time()
    params = P.init_quantized_params(cfg, P.QuantSpec(n_bits=4, group_size=GS), seed=SEED)
    torch.cuda.synchronize()
    log(f"params built on the card in {time.time() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")
    counts = {}

    launches.reset()
    logits = P.forward_logits(params, prompt, cfg)
    torch.cuda.synchronize()
    counts["forward_logits [1,128]"] = launches.snapshot()
    if tuple(logits.shape) != (1, 128, cfg.vocab_size) or not bool(logits.isfinite().all()):
        raise AssertionError(f"forward_logits: bad shape {tuple(logits.shape)} or non-finite")
    log("forward_logits [1, 128]: finite, shape ok")

    cache = P.init_kv_cache(cfg, 1, 512)
    launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre_logits, cache = P.decode_step(params, cache, prompt, 0, cfg)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    counts["prefill 128 into int8 cache"] = launches.snapshot()
    if not bool(pre_logits.isfinite().all()):
        raise AssertionError("prefill logits non-finite")
    tok = pre_logits[:, -1].argmax(dim=-1)[:, None]
    t0 = time.perf_counter()
    P.decode_step(params, cache, prompt, 0, cfg)  # rewrites the same slots
    torch.cuda.synchronize()
    t_prefill_warm = time.perf_counter() - t0

    n_steps = 32
    launches.reset()
    t0 = time.perf_counter()
    gen_toks, cache = P.greedy_generate(params, cache, tok, 128, n_steps, cfg)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    counts[f"greedy_generate {n_steps} steps"] = launches.snapshot()
    if not bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()):
        raise AssertionError("generated tokens out of range")
    t0 = time.perf_counter()
    P.greedy_generate(params, cache, gen_toks[:, -1:], 128 + n_steps, n_steps, cfg)
    torch.cuda.synchronize()
    t_decode_warm = time.perf_counter() - t0

    total = {k: sum(c[k] for c in counts.values()) for k in launches.COUNTS}
    for path, c in counts.items():
        log(f"launches in {path}: {json.dumps(c)}")
    missing = [k for k, v in total.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    for what, t in (("first call", t_prefill), ("second call", t_prefill_warm)):
        log(f"prefill: {128 / t:.1f} tok/s (128 tokens in {t * 1e3:.2f} ms, {what}, "
            f"host clock)  [{card}]")
    for what, t in (("first call", t_decode), ("second call", t_decode_warm)):
        log(f"decode: {n_steps / t:.2f} tok/s ({t / n_steps * 1e3:.3f} ms/token over {n_steps} "
            f"steps, batch 1, int8 KV of 512 slots, {what}, host clock)  [{card}]")

    # teacher-forced decode vs the full forward (bench.py:584-613)
    n_chk = 8
    seq = torch.cat([prompt, tok, gen_toks[:, : n_chk - 1]], dim=1)  # [1, 136]
    full = P.forward_logits(params, seq, cfg).float()
    chk_cache = P.init_kv_cache(cfg, 1, 512)
    _, chk_cache = P.decode_step(params, chk_cache, prompt, 0, cfg)
    worst = 0.0
    for i in range(n_chk):
        lg, chk_cache = P.decode_step(params, chk_cache, seq[:, 128 + i : 129 + i], 128 + i, cfg)
        worst = max(worst, float((lg[:, 0].float() - full[:, 128 + i]).abs().max()))
    rel = worst / float(full.abs().max())
    log(f"decode-vs-forward: max rel logit error {rel:.4f} over {n_chk} steps (limit 0.15)")
    if not rel < 0.15:
        raise AssertionError(f"decode/forward divergence: rel err {rel:.4f}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_decode(P, params, cache, gen_toks[:, -1:], 128 + 2 * n_steps, cfg, card)
    del params, cache, chk_cache
    torch.cuda.empty_cache()
    return total


def time_kernels(P, card, launches_total, errs):
    """Per-kernel ms beside plain ms, bound and library yardstick."""
    import torch
    import torch.nn.functional as F
    from llama3_quantization_tpu_torch.ops import decode_attention as da
    from llama3_quantization_tpu_torch.ops import flash_attention as fa
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = []

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
                      2.0 * m * k * n, BF16_FLOPS, lib_ms, errs[kid][label])
            qmm_rows.setdefault(kid, []).append(row)
        del qts, wd

    # B5 at the main path's cache (T=512) and a 2048-slot cache; 32 layers
    # of cache cycle through so each call reads its layer cold
    b, g, rep, d, layers = 1, 8, 4, 128, 32
    b5_rows = []
    for t in (512, 2048):
        block_t = 1024 if t % 1024 == 0 else 512
        kq, ks, vq, vs = rand_cache(P, b, g, t, d, layers, gen)
        q = torch.randn((b, 1, g * rep, d), generator=gen, device="cuda").to(torch.bfloat16)
        mask = decode_mask(b, t)

        def call(fn, i):
            li = i % layers
            return fn(q, kq[li], ks[li], vq[li], vs[li], mask, torch.bfloat16, block_t)

        ms = time_ms(lambda i: call(da.decode_s8, i), 200)
        plain_ms = time_ms(lambda i: call(da.decode_s8_plain, i), 10)
        nbytes = 2 * b * g * t * (d + 4) + 2 * b * g * rep * d * 2 + b * t * 4
        b5_rows.append(add("B5", "decode_s8", "llama3_quantization_tpu_torch/csrc/decode_attention.cu",
                           "llama3_quantization_tpu/ops/decode_attention.py:274",
                           f"B={b} G={g} rep={rep} D={d} T={t} int8", ms, plain_ms, nbytes,
                           4.0 * b * g * rep * t * d, INT8_OPS, None, errs["B5"][f"T={t}"]))
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
    # one row per kernel in the summary line, at the main path's heaviest
    # shape (B1/B2: gate/up) or its own length (B5: T=512, B7: S=128); the
    # lines above hold the other shapes
    return [qmm_rows["B1"][2], qmm_rows["B2"][2], b5_rows[0], b7_rows[0]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after building and checking the kernels")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few decode steps (device time by kernel)")
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

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    log("kernel checks against the plain versions on the card:")
    check_qmatmul(P, gen, errs)
    check_decode(P, gen, errs)
    check_flash(P, gen, errs)
    torch.cuda.synchronize()
    if args.kernels_only:
        log("kernel checks passed")
        return 0

    total = drive_main_path(P, card, profile=args.profile)
    rows = time_kernels(P, card, total, errs)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
