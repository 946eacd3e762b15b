#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`llama3_quantization_tpu_torch`) on one
NVIDIA GPU (written for an H100).

    python3 chip_smoke.py                 # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels-only  # build and check the kernels only
    python3 chip_smoke.py --profile       # also profile decode steps and serving windows
    python3 chip_smoke.py --prefill-bench # --kernel-bench, B2 at M = 128-2048, forward_logits (pallas, s4, a8)
    python3 chip_smoke.py --kernel-bench  # only time the B5 forms, B2 W4/W3 gate/up (L2-warm and cold),
                                          # B6, B3.gemm, B7, B7.stats/dkv/dq at OmniQuant's shape
                                          # beside SDPA, and the GEMVs (B1, B3.v3, B3.s4, B3.s8)
    python3 chip_smoke.py --kernel-bench b7grad  # only B7.stats, B7.dkv and B7.dq (groups: b5 b2
                                                 # b6 b3 b7 b7grad gemv)
    python3 chip_smoke.py --serve-profile # only one 8-slot serving window by kernel (pallas int8/fp, a8)
    python3 chip_smoke.py --decode-drift  # only the full-depth B5, B6 and B3 kernel-vs-plain decodes
    python3 chip_smoke.py --microbench    # only the weight-stream probes B8-B10 and their entry points
    python3 chip_smoke.py --cli           # only the kernel checks, phase 10 (the CLI slice) and the
                                          # golden rows
    python3 chip_smoke.py --harness       # only the kernel checks and phase 11 (the rest of the
                                          # harness, IR and STS at full width)
    python3 chip_smoke.py --harness --harness-seed 1  # the same on other weights and documents
    python3 chip_smoke.py --archs         # only the kernel checks and phase 12 (OPT-125M,
                                          # Falcon-7B and Mixtral-8x7B at full width and depth)
    python3 chip_smoke.py --moe           # only phase 12's Mixtral-8x7B, then its MoE dispatches
                                          # (dense, routed) timed by the rows of a call
    python3 chip_smoke.py --seq2seq       # only the kernel checks and phase 13 (the T5 trunk
                                          # at T0-3B width and depth, its GPTQ, LM, CLI, profile)
    python3 chip_smoke.py --parallel      # only the kernel checks and phase 14 (parallelism on
                                          # a world of one NCCL rank at Llama-3-8B width)
    python3 chip_smoke.py --multi-rank    # only the parallel paths across all the machine's
                                          # cards, one NCCL rank a card (2 or more cards)

Phases, in order; any failure exits non-zero:
  1. require CUDA and print the card's name and power limit;
  2. build every kernel from `llama3_quantization_tpu_torch/csrc/` (one nvcc
     per source, in parallel);
  3. hold each kernel form against its plain PyTorch version on the card at
     the main paths' shapes, with the tolerances stated below: B1 at M = 1,
     2, 5, 8, 16, 33 and 64 on the four decoder linears and on 2-bit, 4-bit,
     int8 and uint8 codes at group sizes 32, 64, 128 and K on a ragged N,
     B1 at M = 1 and 8 and B2 at M = 128 and 2048 on HQQ W4 weights (the
     continuous float zeros of `hqq_solve`, g64 and g128, the four linears),
     B1's batch invariance (rows of M = 8 and 64 bit-equal to the M = 1
     calls), B2 at M = 65, 128, 200 and 512, B2 on 3-bit planes at the same
     M, B2's batch invariance (rows 0..7 of M = 128 and M = 72 bit-equal),
     B3 (v3 on packed W4 g128, s4, per-column s8) at B1's M and 128 on the
     W·A8 paths' o, qkv, gate-up and down and the s8 and s4 heads at B1's
     M, B3's tiled form also at the ragged M = 65 and 200, at M = 512 and on
     a ragged N (fp32 output bit-equal to the plain version in both forms),
     B5 on the int8 cache with and without m/l statistics and
     on the int4 cache with and without them (one all-masked row), B5's
     batch invariance (rows of B = 8 bit-equal to B = 1 calls, int8 and
     int4, T = 512 and 2048) and determinism (two calls bit-equal), its
     split algorithm in PyTorch against its plain version (m, codes and PV
     sums bit-equal, o and l within 1e-6), B6 on
     the bf16 fp cache (stacked at B = 1, per layer at B = 8 with per-row
     masks, an all-masked row and a row masked after its first T block, T =
     512 to 4096) and on an fp32 cache, B7 at S = 128, 2048 and the ragged
     200 (Llama-3-8B heads) and at B = 2, S = 1000, D = 64, each output row
     within 2e-2 of its own max|ref|; then the window-merge op (B5
     with stats merged with the exact window attention) against eager
     attention over the dequantized main and window keys; the codes-direct
     int8 route on the card against the same call on the CPU (its
     requantized probability codes at most one step apart, at most 4 flips
     a row, o within 1e-5 * max|o| beyond the flips' exact share); B3 on
     unpacked uint8 8-bit codes; and the
     weight-stream probes at the microbench scripts' default shapes
     (`check_probes`): B8 (w4, tiled, depth 1/2/4/8), B9 (v4, tiled, dot4,
     noscale, cast8, multi S = 1/2/4) and B10 dot2 / cat bit for bit, B10
     bf16 within 1e-2, every B9 and B10 form bit-equal between two calls,
     and B10 dot2 / cat bit-equal to B3's `a8_plain` at the unpack default
     [4096, 14336] and on a ragged K = 384; phase 12's shapes
     (`check_arch_kernels`): B1 at M = 1 and 8 and B2 at M = 128 on
     OPT-125M's W4 g128 and Falcon-7B's W4 g64 linears, the B5 forms and
     B6 at rep 1, D = 64, T = 512, B7 at 71 query heads over one K/V head
     and at 12 over 12, D = 64, S = 128 and 2048; and phase 13's
     (`check_t5_kernels`): B1 at M = 1, 4 and 8 and B2 at M = 128 and 2048
     on T0-3B's [2048, 2048], [2048, 5120] and [5120, 2048] W4 g128;
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
     the eager route, no B6); the JAX package's decode routes: the int8
     engine under `set_decode_kernel(False)` (eager, no window) and under
     `set_decode_attn("xla")` (codes-direct windows), launching no B5 form,
     pipelined = sequential; check teacher-forced decode against the
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
     the least time the card could take for the same work (its bound);
 10. the CLI slice (`drive_cli`, run before the RTN paths of 7): `cli.main`
     in this process with `--net llama3-8b --quant_method hqq --wbits 4
     --group_size 128 --eval_ppl` over 2 windows of 2048 (fp32 weights,
     full depth, pallas: B2 and B7), the PPL against B1's and B2's plain
     versions (|d ln PPL| <= 1e-2) and the xla route (reported); a
     checkpoint at 8B width and 2 layers through `--save_dir`, reloaded bit
     for bit; HQQ at full depth on the default engine (fp cache, B1 at M =
     8 and B6, pipelined = sequential) and 32 greedy steps on the int8 cache
     (B5, decode vs forward < 0.15); IR-QLoRA at 8B width and 2 layers
     (tau_n = 100): `icq_search` on the card against the CPU, PPL over 2
     windows (B7), 8 greedy steps on the fp cache (B6). The golden rows
     (phase 7's) include `hqq` and `irqlora`;
 11. the rest of the harness (`drive_harness`, run after the eval phase, on
     its RTN W4 g128 model at full width and depth, `ByteTokenizer`):
     `simple_evaluate(TorchLM(batch_size=4), ...)` on seeded documents in
     each task's raw schema (hellaswag, winogrande, an MMLU subject,
     lambada_openai, wikitext's rolling windows of 2048, gsm8k's
     `greedy_until` of at most 32 tokens) with an n-gram pickle the port's
     janitor wrote from half the hellaswag docs, on the kernel route and on
     B1's and B2's plain versions with the eager attention: per-token
     log-likelihoods within 1e-2 (fp32 activations; with bf16 ones within
     HARNESS_LL_BF16_TOL, which a faulty route's reading must exceed in the
     same run), ln word_perplexity within 1e-2, gsm8k's tokens equal to
     `greedy_generate` from the same bucketed prefill, `acc_decontaminate`
     exactly the clean half's accuracy; `UPRReranker` on 2 queries x 8
     passages within 1e-2 a query token of the plain versions (fp32
     activations, B7 at buckets of 256 and up); `STSEncoder` on 16 pairs,
     each embedding's cosine to the plain versions' >= 0.999; `HFCausalLM`
     over `forward_logits` within 1e-4 a token of `TorchLM` on the 27 study
     requests; `cli.main --tasks hellaswag,winogrande,hendrycksTest-*` at 2
     layers offline (every name passes the checks and is skipped with
     JAX's message). Which janitor path ran (native or Python) is printed;
 12. the other architectures (`drive_archs`, run after phase 11), each at
     full width and depth and freed before the next: OPT-125M W4 g128
     (forwards at [1, 128] and [1, 2048] against the plain versions with the
     eager attention, int8 and fp greedy decodes, `decode_window`, the int8
     engine, windowed), Falcon-7B W4 g64 (the same forwards; decodes on B1
     with the eager attention, the only routes allowed `B5.eager` and
     `B6.eager`; the default fp engine), Mixtral-8x7B W4 g128 built layer
     by layer (the dense [1, 128] forward against the plain versions with
     a witness and a faulty control in the same run, the experts' picks
     that differ counted; capacity 8.0 against dense, capacity 1.25 with
     its drops counted; the routed [1, 2048] forward, experts on B2 at ~512
     rows, against the plain versions and bit for bit against the dense
     dispatch; 32 greedy int8 steps; the int8 engine, never windowed). Each
     model's launches of B1, B2, B5, B6 and B7, its routes and its seconds
     are printed.
 13. the T5 trunk (`drive_seq2seq`, run after phase 12) at T0-3B's published
     width and depth (24 + 24 layers, RTN W4 g128 packed, bf16):
     `forward_logits_seq2seq` on [4, 512] -> [4, 128] (B2 only, 432
     launches) against the plain versions with a witness and a faulty
     control in the same run; `greedy_generate_seq2seq_cached` 32 steps at
     B = 4 (216 B1 launches a step), each step against the teacher-forced
     `decode_logits` (< 0.15) and the stream against the re-forward (equal
     but at near ties); 4 cached steps under `utils.profile_trace`, read by
     `tools/profile_report` (B1 864 times); `Seq2SeqTorchLM` log-likelihoods
     (fp32 activations, <= 1e-2 a token against the plain versions) and
     `greedy_until` against the cached greedy; GPTQ at T0-3B width, 2 + 2
     layers, below RTN on held-out inputs; `cli.main` on an HF directory of
     that model (`t5-seq2seq`, `gptq W4 g128 applied (seq2seq)`). The golden
     rows (phase 7's) include `seq2seq_fp`, `seq2seq_rtn`, `seq2seq_gptq`.
 14. parallelism (`drive_parallel`, run after phase 13) on a world of one
     NCCL rank (one card holds one NCCL rank: multi-rank collectives are
     proven over gloo on the CPU) at Llama-3-8B width, 8 layers, RTN W4
     g128: NCCL carries a CUDA all-reduce and a gloo group refuses it; the
     (dp 1, tp 1) sharded forward bit-equal to `forward_logits`; the
     sharded int8 and fp engines under a decode mesh (16 requests,
     `run_pipelined(16)`) equal to the one-replica engine; tp-overlap,
     pipeline (pp 1, 2 microbatches) and sp forwards within ARCH_ROW_TOL a
     row and the sp PPL within EVAL_LN_PPL_TOL; sharded GPTQ of a down
     projection bit-equal to `gptq_quantize_weight`; the LWC train step (2
     layers, [2, 2048], B7.stats/dkv/dq) against `set_flash(False)`; a
     4-layer sharded checkpoint bit for bit; `measure_scaling`; the CLI's
     `--tp 1 --dp 1` and `--sp 1`. Its kernel checks (phase 3,
     `check_parallel_kernels`): B1 at M = 1 and 8 and B2 at M = 128 on the
     column and row shards of every linear at tp = 2, 4, 8, B5's forms and
     B6 at G = 4, 2, 1, B7 at H = 32 / tp over G = 8 / tp, S = 2048.

Each path runs with the launch counts set to 0 just before it and read
just after; a kernel form that a path should run and did not, or one it
must not run and did, fails the run. The line before the last is a JSON
object of the kernels; the last line is `{"ok": true, "device": {...}}`.

With `L3Q_ABLATE=<mask>` in the environment the kernels are built with
phases removed (`csrc/common.cuh`) and give wrong results: only for timing
those phases' share with `--kernel-bench`, e.g.

    L3Q_ABLATE=9 python3 chip_smoke.py --kernel-bench  # B3 without unpack, B7 without V loads
    L3Q_ABLATE=256 python3 chip_smoke.py --kernel-bench  # the GEMVs' copies alone
    L3Q_ABLATE=512 python3 chip_smoke.py --kernel-bench  # B5's copies alone
    L3Q_ABLATE=2048 python3 chip_smoke.py --kernel-bench b7grad  # B7.dkv's and B7.dq's copies alone
    L3Q_ABLATE=1024 python3 chip_smoke.py --microbench   # B9's and B10's copies alone

Under `L3Q_ABLATE`, `--microbench` skips the probes' checks and oracles
(their results are wrong) and only times them.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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


def compare(name: str, got, ref, rel_tol: float, slack=None) -> float:
    """Max abs error of `got` against `ref`; fails above rel_tol * max|ref|
    (beyond an elementwise allowance `slack`, where given)."""
    g, r = got.float(), ref.float()
    if not bool(g.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    err = float((g - r).abs().max())
    scale = float(r.abs().max())
    over = err if slack is None else float(((g - r).abs() - slack).max())
    log(f"  {name}: max_abs_err {err:.3e}  max_rel_err {err / max(scale, 1e-30):.3e}"
        + ("" if slack is None else f"  beyond the allowance {over:.3e}")
        + f"  (tolerance {rel_tol:g} * max|ref| = {rel_tol * scale:.3e})")
    if not over <= rel_tol * scale:
        raise AssertionError(f"{name}: error {over} above {rel_tol} * {scale}")
    return err


def rand_weights(P, k: int, n: int, copies: int, gen):
    from llama3_quantization_tpu_torch.models.synthetic import _rand_qtensor

    stacked = _rand_qtensor(gen, k, n, P.QuantSpec(n_bits=4, group_size=GS), copies, "cuda")
    return [stacked.layer(i) for i in range(copies)]


#: M of B1's and B3's GEMV-form checks: batch-1 decode, 2 rows, the
#: speculative verify (5), the 8-slot engine, and 16, 33 and 64 rows (a
#: part-filled and a full tile of the GEMV forms' largest, M <= 64)
GEMV_MS = (1, 2, 5, 8, 16, 33, 64)
#: (kernel id, M) of the B1/B2 checks on every decoder linear shape: B1 at
#: GEMV_MS; B2 at M=128 (a 128-token prefill, the engine's bucket-16
#: prefill) and M=512 (the engine's bucket-64 prefill: 8 slots x 64), and at
#: the ragged M=65 and 200 (a partly filled 128-row tile)
QMM_CASES = tuple(("B1", m) for m in GEMV_MS) + (("B2", 65), ("B2", 128), ("B2", 200),
                                                 ("B2", 512))
B2_M = (65, 128, 200, 512)


def check_qmatmul(P, gen, results):
    """B1 at GEMV_MS and B2 at M=65, 128, 200 and 512 on every decoder
    linear shape (W4 g128)."""
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


#: B1's code layouts beyond W4: (label, bits, pack); 8 bits unpacked are
#: int8 codes, packed (one code a byte) uint8
B1_LAYOUTS = (("w2", 2, True), ("w4", 4, True), ("int8", 8, False), ("uint8", 8, True))


def check_b1_forms(P, gen):
    """B1 on 2-bit, 4-bit, int8 and uint8 codes at group sizes 32, 64, 128
    and K, on a ragged N = 4112 (a part-filled column tile), at GEMV_MS:
    fp32 out within 1e-4 * max|ref|, bf16 within 1e-2."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    k, n = 4096, 4112
    for label, bits, pack in B1_LAYOUTS:
        w = torch.randn((k, n), generator=gen, device="cuda")
        for gs in (32, 64, 128, k):
            qt = P.quantize_rtn(w, P.QuantSpec(n_bits=bits, group_size=gs), pack=pack)
            worst = [0.0, 0.0]
            for m in GEMV_MS:
                x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                for i, (dt, tol) in enumerate(((torch.float32, 1e-4), (torch.bfloat16, 1e-2))):
                    got, ref = fq.qmm_gemv(x, qt, dt).float(), fq.qmm_gemv_plain(x, qt, dt).float()
                    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
                    if not bool(got.isfinite().all()) or err > tol * scale:
                        raise AssertionError(f"B1 {label} g{gs} N={n} M={m} {dt}: error {err} "
                                             f"above {tol} * {scale}")
                    worst[i] = max(worst[i], err / scale)
            log(f"  B1 {label} ({qt.data.dtype}) g{gs} N={n} M={GEMV_MS}: max_rel_err fp32 "
                f"{worst[0]:.3e}, bf16 {worst[1]:.3e}  (tolerances 1e-4, 1e-2)")


def check_b1_batch_invariance(P, gen):
    """B1's tiles, split and order follow (K, N, gs, f) alone: row i of an
    M = 8 and of an M = 64 call equals the M = 1 call on that row bit for
    bit (fp32 out), on every decoder linear shape."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    for label, (k, n) in LINEAR_SHAPES.items():
        qt = rand_weights(P, k, n, 1, gen)[0]
        x = torch.randn((64, k), generator=gen, device="cuda").to(torch.bfloat16)
        rows = torch.cat([fq.qmm_gemv(x[i:i + 1].clone(), qt, torch.float32) for i in range(64)])
        for m in (8, 64):
            if not torch.equal(fq.qmm_gemv(x[:m].clone(), qt, torch.float32), rows[:m]):
                raise AssertionError(f"B1 {label}: rows of M={m} differ from the M=1 calls")
        log(f"  B1 {label}: rows of M=8 and M=64 == the M=1 calls, bit for bit (plan "
            f"{tuple(fq.gemv_plan(k, n, GS, 2))}, from (K, N, gs, f) alone)")


def check_b2_batch_invariance(P, gen):
    """B2's K split follows (K, N) alone: rows 0..7 of an M = 128 call equal
    the same rows of an M = 72 call bit for bit (fp32 and bf16 out), on every
    decoder linear shape, 4-bit and 3-bit."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    for label, (k, n) in LINEAR_SHAPES.items():
        w = torch.randn((k, n), generator=gen, device="cuda")
        for bits in (4, 3):
            qt = P.quantize_rtn(w, P.QuantSpec(n_bits=bits, group_size=GS), pack=True)
            x = torch.randn((128, k), generator=gen, device="cuda").to(torch.bfloat16)
            for dt in (torch.float32, torch.bfloat16):
                full, part = fq.qmm_gemm(x, qt, dt), fq.qmm_gemm(x[:72].clone(), qt, dt)
                if not torch.equal(full[:8], part[:8]):
                    raise AssertionError(f"B2 W{bits} {label}: rows 0..7 of M=128 and M=72 "
                                         f"differ ({dt})")
        log(f"  B2 {label} W4 and W3: rows 0..7 of M=128 == rows 0..7 of M=72, bit for bit "
            f"(K split {fq.b2_ksplit(k, n)}, from (K, N) alone)")


#: (K, N) of the linears the W·A8 paths run, q/k/v and gate/up fused as
#: `fuse_for_decode` makes them, and of the lm_head
B3_SHAPES = {"o": (4096, 4096), "qkv": (4096, 6144), "gateup": (4096, 28672),
             "down": (14336, 4096)}
HEAD_SHAPE = (4096, 128256)
#: M of B3's checks: the GEMV form's (batch-1 decode, the 8-slot serving
#: step, ...) and a 128-token prefill
B3_MS = GEMV_MS + (128,)


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
    and per-column s8 at B3_MS on o, qkv, gate-up and down, the s8 and s4
    heads at GEMV_MS, and unpacked uint8 8-bit codes on o (a8's "u8"
    layout, v3's int8 cast); the tiled form also at the ragged M = 65 and
    200, M = 512 and a ragged N = 4112 (a partly filled tile). Both forms
    sum every output's groups in the plain version's order from exact s32
    partials, so their fp32 output must equal it bit for bit; bf16 out
    within 1e-2."""
    import torch
    from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa

    def one(key, label, w, m, k):
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        xq, s_x = qa.quantize_activations_s8(x)
        rkey = key if m <= qa.GEMV_MAX_M else "B3.gemm"
        name = f"{rkey} {label} {w[1]} M={m}"
        got, ref = b3_call(key, w, xq, s_x, torch.float32), qa.a8_plain(xq, s_x, *w, torch.float32)
        compare(f"{name} fp32-out", got, ref, 0.0)
        if not torch.equal(got, ref):
            raise AssertionError(f"{name}: fp32 output differs from the plain version")
        err = compare(f"{name} bf16-out", b3_call(key, w, xq, s_x, torch.bfloat16),
                      qa.a8_plain(xq, s_x, *w, torch.bfloat16), 1e-2)
        results.setdefault(rkey, {})[f"{label} {w[1]} M={m}"] = err

    for label, (k, n) in B3_SHAPES.items():
        for key, ws in b3_forms(P, k, n, 1, gen).items():
            for m in B3_MS:
                one(key, label, ws[0], m, k)
    for key, ws in b3_forms(P, 4096, 4112, 1, gen).items():
        for m in (65, 200, 512):
            one(key, "ragged", ws[0], m, 4096)
    for key, w in head_forms(P, gen).items():
        for m in GEMV_MS:
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
    """B2 on 3-bit planes (RTN W3 g128 of random normals) at M = 65, 128,
    200 and 512 on every decoder linear shape: fp32 out 1e-4 * max|ref|,
    bf16 1e-2."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    for label, (k, n) in LINEAR_SHAPES.items():
        w = torch.randn((k, n), generator=gen, device="cuda")
        qt = P.quantize_rtn(w, P.QuantSpec(n_bits=3, group_size=GS), pack=True)
        for m in B2_M:
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


def compare_rows(name: str, got, ref, rtol: float) -> None:
    """Each last-axis row of `got` within rtol * its own max|ref| (B7's
    criterion, `check_flash`)."""
    g, r = got.float(), ref.float()
    if not bool(g.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    row_err, row_max = (g - r).abs().amax(dim=-1), r.abs().amax(dim=-1)
    worst = float((row_err / row_max.clamp(min=1e-30)).max())
    log(f"  {name}: max over rows of max|err| / max|ref| {worst:.3e} (tolerance {rtol:g} per row)")
    if not bool((row_err <= rtol * row_max).all()):
        raise AssertionError(f"{name}: a row's error is above {rtol} * its max|ref|")


#: the B5 kernel forms: (int4 cache, m/l statistics)
FORMS = ((False, False), (False, True), (True, False), (True, True))


def check_decode_forms(P, gen, results, g=8, rep=4, d=128, ts=(512, 2048), tag=""):
    """B5 on the int8 and int4 caches, with and without m/l statistics, at
    G=8, rep=4, D=128 (or the `g`, `rep`, `d` given, their results keyed
    under `tag`), B in {1, 8} (8 = the serving engine's slots), T in
    {512, 2048} (T=2048 runs two T blocks; or `ts`). In the batch-8 cases row 0 is
    all masked: with stats, m must be -1e30 and l = T there. Tolerances: o
    2e-3 * max|o| in fp32 out (a 1-ulp exp difference can move one
    probability code by one), 1e-2 in bf16 out (the form without stats
    returns the activation dtype on the paths); m 1e-6 * |m|, l 1e-5 * l."""
    import torch
    from llama3_quantization_tpu_torch.ops import decode_attention as da

    for int4, stats in FORMS:
        key = da.launch_key(int4, stats)
        for b in (1, 8):
            for t in ts:
                block_t = 1024 if t % 1024 == 0 else 512
                kq, ks, vq, vs = (x[0] for x in rand_cache(P, b, g, t, d, 1, gen, int4))
                q = torch.randn((b, 1, g * rep, d), generator=gen, device="cuda").to(torch.bfloat16)
                mask = decode_mask(b, t)
                if b > 1:
                    mask[0] = da.NEG
                args = (q, kq, ks, vq, vs, mask)
                got = da.decode_s8(*args, torch.float32, block_t, stats)
                ref = da.decode_s8_plain(*args, torch.float32, block_t, stats)
                label = f"{key} {tag}B={b} T={t}"
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
                results.setdefault(key, {})[f"{tag}B={b} T={t}"] = err


def check_b5_split(P, gen):
    """B5's split across a thread-block cluster: row b of a B=8 call equals,
    bit for bit in o, m and l, a B=1 call on that row (int8 and int4, T =
    512 and 2048, every row's own mask, one all masked); two calls on the
    same inputs are bit-equal in every form; and the split algorithm in
    PyTorch (`decode_s8_split_plain`) against `decode_s8_plain` on the card:
    m, every probability code and every s32 PV sum bit-equal, o and l
    within 1e-6 of max|o| and of l."""
    import torch
    from llama3_quantization_tpu_torch.ops import decode_attention as da

    g, rep, d = 8, 4, 128
    for int4 in (False, True):
        for t in (512, 2048):
            block_t = 1024 if t % 1024 == 0 else 512
            kq, ks, vq, vs = (x[0] for x in rand_cache(P, 8, g, t, d, 1, gen, int4))
            q = torch.randn((8, 1, g * rep, d), generator=gen, device="cuda").to(torch.bfloat16)
            lens = torch.tensor([0, 1, 17, 100, t // 2, t - 100, t - 1, t], device="cuda")
            mask = torch.where(torch.arange(t, device="cuda")[None, :] < lens[:, None], 0.0,
                               da.NEG).float().contiguous()
            label = f"B5 {'int4' if int4 else 'int8'} T={t} ({da.s8_split_plan(t, block_t, d, int4)})"
            args = (q, kq, ks, vq, vs, mask)
            full = da.decode_s8(*args, torch.float32, block_t, True)
            for b in range(8):
                one = da.decode_s8(*(x[b : b + 1].contiguous() for x in args), torch.float32,
                                   block_t, True)
                if not all(torch.equal(x[b : b + 1], y) for x, y in zip(full, one)):
                    raise AssertionError(f"{label}: row {b} of B=8 differs from its B=1 call")
            for stats in (False, True):
                for out_dtype in (torch.float32, torch.bfloat16):
                    a = da.decode_s8(*args, out_dtype, block_t, stats)
                    b2 = da.decode_s8(*args, out_dtype, block_t, stats)
                    if not all(torch.equal(x, y) for x, y in zip(a if stats else (a,),
                                                                  b2 if stats else (b2,))):
                        raise AssertionError(f"{label}: two calls differ (stats={stats})")
            ref = da.decode_s8_plain(*args, torch.float32, block_t, True, True)
            spl = da.decode_s8_split_plain(*args, torch.float32, block_t, True, True)
            if not (torch.equal(spl[1], ref[1]) and torch.equal(spl[3], ref[3])
                    and torch.equal(spl[4], ref[4])):
                raise AssertionError(f"{label}: split plain m, codes or PV sums differ")
            compare(f"{label} split plain o", spl[0], ref[0], 1e-6)
            compare_rel(f"{label} split plain l", spl[2], ref[2], 1e-6)
            log(f"  {label}: B=8 rows bit-equal to B=1 calls, two calls bit-equal, split plain "
                "m / codes / PV sums bit-equal to plain")


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
        lambda: w4_bd.bd_plain("v4", (xh, xl), (w[0],), s[0], bk), 0,
        wbytes + sbytes + 2 * k + obytes, 4.0 * k * n, lib)
    add("B9.dot4", "w4_variants.py:70", f"{mb} bd[{2 * gt},K] int4 rows",
        lambda i: w4_bd.w4_dot4(bd2, s[i], w[i], bk),
        lambda: w4_bd.bd_plain("dot4", (bd2[:2 * gt],), (w[0],), s[0], bk), 0,
        wbytes + sbytes + 2 * gt * k + obytes, 2.0 * 2 * gt * k * n, lib)
    add("B9.noscale", "w4_variants.py:139", f"{mb} bd[{2 * gt},K] int4 rows, no scales",
        lambda i: w4_bd.w4_noscale(bd2, w[i], bk),
        lambda: w4_bd.bd_plain("noscale", (bd2[:2 * gt],), (w[0],), None, bk), 0,
        wbytes + 2 * gt * k + obytes, 2.0 * 2 * gt * k * n, lib)
    add("B9.cast8", "w4_variants.py:120", f"{mb} bd[{gt},K] s8 rows",
        lambda i: w4_bd.w4_cast8(bd1, s[i], w[i], bk),
        lambda: w4_bd.bd_plain("cast8", (bd1[:gt],), (w[0],), s[0], bk), 0,
        wbytes + sbytes + gt * k + obytes, 2.0 * gt * k * n, lib)
    for st in (1, 2, 4):
        ws = [[ints(-128, 128, (k // 2 // st, n)) for _ in range(st)] for _ in range(copies)]
        bds = [ints(-8, 8, (2 * gt // st, k // st)) for _ in range(st)]
        add("B9.multi", "w4_multidma.py:24", f"{mb} S={st} streams",
            lambda i, ws=ws, bds=bds: w4_bd.w4_multi(bds, ws[i], bk),
            lambda ws=ws, bds=bds: w4_bd.bd_plain("multi", bds, ws[0], None, bk), 0,
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
        lambda: w4_bd.bd_plain("v4", (xh, xl), (w[0],), s[0], bk), 0,
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
    microbench scripts' default shapes: B8, B9 (exact s32 partials, the
    fp32 epilogue in the plain version's order) and B10 dot2 / cat bit for
    bit, B10 bf16 within 1e-2 (the order inside a bf16 dot); each B9 and B10
    form's second call bit-equal to its first; B10 dot2 / cat bit-equal to
    B3's `a8_plain` (s_x = 1) at the unpack default and on a ragged K. Under
    L3Q_ABLATE (wrong results by design) nothing is compared."""
    import torch
    from llama3_quantization_tpu_torch.ops import qmm_u8, w4_stream
    from llama3_quantization_tpu_torch.ops.qmatmul_a8 import a8_plain

    if os.environ.get("L3Q_ABLATE"):
        log("  probes not checked: L3Q_ABLATE builds give wrong results")
        for c in probe_cases(P, gen, 1):
            results.setdefault(c["key"], {})[c["shape"]] = None
        results["B8.depth"] = {depth: None for depth in w4_stream.DEPTHS}
        return
    x = torch.randint(-128, 128, (DEPTH_ROWS, DEPTH_WIDTH), generator=gen, device="cuda",
                      dtype=torch.int16).to(torch.int8)
    ref = w4_stream.dma_depth_plain(x, DEPTH_CHUNK)
    for depth in w4_stream.DEPTHS:
        err = compare(f"B8.depth [{DEPTH_ROWS},{DEPTH_WIDTH}] depth={depth}",
                      w4_stream.dma_depth(x, DEPTH_CHUNK, depth), ref, 0)
        results.setdefault("B8.depth", {})[depth] = err
    del x
    for c in probe_cases(P, gen, 1):
        got = c["run"](0)
        err = compare(f"{c['key']} {c['shape']}", got, c["plain"](), c["tol"])
        results.setdefault(c["key"], {})[c["shape"]] = err
        if c["key"].startswith(("B9", "B10")) and not torch.equal(c["run"](0), got):
            raise AssertionError(f"{c['key']} {c['shape']}: two calls differ")
    ones = torch.ones((qmm_u8.BM, 1), dtype=torch.float32, device="cuda")
    for k, n in ((V4_SHAPE[0], V4_SHAPE[1]), (384, V4_SHAPE[1])):
        qt = P.quantize_rtn(torch.randn((k, n), generator=gen, device="cuda") * 0.02,
                            P.QuantSpec(n_bits=4, group_size=GS), pack=True)
        xq = torch.randint(-127, 128, (qmm_u8.BM, k), generator=gen, device="cuda",
                           dtype=torch.int16).to(torch.int8)
        ref = a8_plain(xq, ones, qt.data, "u4", qt.scale, qt.zero, GS, torch.float32)
        for v in ("dot2", "cat"):
            compare(f"B10.{v} x[8,{k}] u4 g128 [{k},{n}] against a8_plain",
                    qmm_u8.u8_qmm(xq, qt.data, qt.scale, qt.zero, v), ref, 0)
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
    if os.environ.get("L3Q_ABLATE"):
        log("  oracles not held: L3Q_ABLATE builds give wrong results")
        return sum_counts(counts)
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


def fp_masks(b, t, bt):
    """[B, T] masks of the B6 checks: the decode path's (last eighth masked);
    at B = 8 the engine's per-row lengths, with row 0 all masked (the mean
    of v) and row 1 valid only in its first T block (masked in the later
    ones, where the running max of the first block carries over)."""
    import torch
    from llama3_quantization_tpu_torch.ops import decode_attention as da

    if b != 8:
        return decode_mask(b, t)
    lens = torch.tensor([0, min(bt, t - t // 8), t // 5, t // 2 - 1, t // 2, 3 * t // 5,
                         4 * t // 5, t], device="cuda")
    return torch.where(torch.arange(t, device="cuda")[None, :] < lens[:, None], 0.0,
                       da.NEG).float().contiguous()


#: (B, T, cache dtype, stacked) of the B6 checks: batch-1 decode (stacked)
#: and the 8-slot engine (per layer) at T = 512 to 4096 (one to four T
#: blocks), and the fp32 cache
FP_CASES = tuple((b, t, "bf16", b == 1) for t in (512, 1024, 2048, 4096) for b in (1, 8)) + (
    (2, 512, "f32", True), (8, 2048, "f32", False))


def check_fp_decode(P, gen, results, g=8, rep=4, d=128, cases=None, tag=""):
    """B6 (split along T) against its plain version at FP_CASES, G=8,
    rep=4, D=128 (or the `g`, `rep`, `d` and `cases` given, their results
    keyed under `tag`) (stacked: layer 1 of 2); the all-masked row's output is
    the mean of v. Tolerances: bf16 1e-2 * max|ref| (bf16 out; p's bf16
    rounding after an exp one ulp apart), fp32 1e-5 * max|ref| (summation
    order). Also the split algorithm's plain twin on the card: its rounded
    p equal the plain version's bit for bit."""
    import torch
    from llama3_quantization_tpu_torch.ops import decode_attention as da

    for b, t, dname, stacked in cases or FP_CASES:
        dtype = torch.bfloat16 if dname == "bf16" else torch.float32
        key = da.fp_launch_key(dtype)
        k = torch.randn((2, b, g, t, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((2, b, g, t, d), generator=gen, device="cuda").to(dtype)
        q = torch.randn((b, 1, g * rep, d), generator=gen, device="cuda").to(dtype)
        bt = 1024 if t % 1024 == 0 else 512
        mask = fp_masks(b, t, bt)
        if stacked:
            got = da.flash_decode_gqa_stacked(q, k, v, mask, 1, bt)
        else:
            got = da.flash_decode_gqa(q, k[1], v[1], mask, bt)
        ref, p_ref = da.decode_fp_plain(q, k[1], v[1], mask, bt, return_p=True)
        c = da.fp_split_chunk(b * g, t, bt)
        label = (f"{key} {tag}{'stacked' if stacked else 'per-layer'} B={b} T={t} "
                 f"({b * g * t // c} blocks of {c} tokens)")
        err = compare(label, got, ref, 1e-5 if dtype == torch.float32 else 1e-2)
        if b == 8:
            mean_v = v[1, 0].float().mean(dim=1).repeat_interleave(rep, dim=0)
            compare(f"{label} all-masked row vs mean of v", got[0, 0], mean_v, 1e-2)
        _, p_twin = da.decode_fp_split_plain(q, k[1], v[1], mask, bt, return_p=True)
        if not torch.equal(p_twin, p_ref):
            raise AssertionError(f"{label}: the split twin's p differ from the plain version's")
        results.setdefault(key, {})[f"{tag}B={b} T={t}"] = err


#: one-step flips of the requantized probability codes admitted per row
#: between the card and the CPU (an ulp of exp moves p * vs across a
#: rounding midpoint)
XLA_MAX_FLIPS = 4


def xla_flip_slack(q, kq, ks, vq, vs, mask):
    """The codes-direct route's probability codes on the card and on CPU
    copies of its inputs (one layer: kq/vq [B, G, T, D]). Fails if a code
    differs by more than one step or a row holds more than XLA_MAX_FLIPS
    flips. Returns (flips, slack): the flipped codes' count and their exact
    share of o, |s32 dot of the code differences with vq| * ps / l, per
    output element [B, 1, Hq, D]."""
    import torch
    from llama3_quantization_tpu_torch.ops import decode_attention as da

    b, _, hq, d = q.shape
    g, t = kq.shape[1], kq.shape[2]
    sides = []
    for x in ((q, kq, ks, vs, mask), tuple(a.cpu() for a in (q, kq, ks, vs, mask))):
        qg = x[0].reshape(b, g, hq // g, d).float()
        sides.append(da.xla_s8_probs(qg, x[1], x[2].reshape(b, g, t), x[3].reshape(b, g, t),
                                     x[4].float()))
    (pc_g, _, _, _), (pc_r, ps, _, l) = sides
    diff = pc_g.cpu().int() - pc_r.int()
    per_row = diff.ne(0).sum(dim=-1)
    if int(diff.abs().max()) > 1 or int(per_row.max()) > XLA_MAX_FLIPS:
        raise AssertionError(f"probability codes differ by up to {int(diff.abs().max())} steps, "
                             f"{int(per_row.max())} codes in one row")
    dpv = da.s8_dot_long(diff.to(torch.int8), vq.cpu()).float()
    slack = (dpv * ps / l.clamp(min=1e-30)[..., None]).abs()
    return int(per_row.sum()), slack.reshape(b, 1, hq, d)


def check_xla_route(P, gen):
    """The codes-direct int8 route (`xla_decode_gqa_s8`, per layer and
    stacked with m/l) on the card against the same call on CPU copies of
    its inputs, at B=8 T=512 and B=1 T=2048 (the PV dot then sums two
    exact s32 chunks), G=8, rep=4, D=128, one all-masked row at B=8. Both
    devices run the same tensor ops and the s32 dots are exact, so m and l
    differ only by fp32 order and an ulp of exp (1e-6 * |m|, 1e-5 * l). That
    ulp can move a requantized probability code by one step: codes may
    differ by one step, at most XLA_MAX_FLIPS in a row, and o by 1e-5 *
    max|o| beyond the flipped codes' exact share."""
    import torch
    from llama3_quantization_tpu_torch.ops import decode_attention as da

    g, rep, d = 8, 4, 128
    for b, t in ((8, 512), (1, 2048)):
        kq, ks, vq, vs = rand_cache(P, b, g, t, d, 2, gen)
        q = torch.randn((b, 1, g * rep, d), generator=gen, device="cuda").to(torch.bfloat16)
        mask = decode_mask(b, t)
        if b > 1:
            mask[0] = da.NEG
        args = (q, kq, ks, vq, vs, mask)
        cpu = [a.cpu() for a in args]
        flips, slack = xla_flip_slack(q, kq[1], ks[1], vq[1], vs[1], mask)
        log(f"  xla_decode_gqa_s8 B={b} T={t}: {flips} probability codes one step apart, "
            f"their share of o up to {float(slack.max()):.3e}")
        got = da.xla_decode_gqa_s8(q, kq[1], ks[1], vq[1], vs[1], mask, torch.float32)
        ref = da.xla_decode_gqa_s8(cpu[0], *(a[1] for a in cpu[1:5]), cpu[5], torch.float32)
        compare(f"xla_decode_gqa_s8 B={b} T={t} card vs CPU", got.cpu(), ref, 1e-5, slack)
        go, gm, gl = da.xla_decode_gqa_s8_stacked(*args, 1, torch.float32, return_stats=True)
        ro, rm, rl = da.xla_decode_gqa_s8_stacked(*cpu, 1, torch.float32, return_stats=True)
        label = f"xla_decode_gqa_s8_stacked stats B={b} T={t} card vs CPU"
        compare(f"{label} o", go.cpu(), ro, 1e-5, slack)
        compare_rel(f"{label} m", gm.cpu(), rm, 1e-6)
        compare_rel(f"{label} l", gl.cpu(), rl, 1e-5)


#: (B, S, H, G, D) of the B7 checks: the main path's Llama-3-8B heads at
#: S = 128 and 2048, a ragged S (a partly filled q tile and key tile),
#: D = 64 with B = 2, and phase 12's heads at S = 128 and 2048: Falcon-7B's
#: 71 query heads over one K/V head and OPT-125M's 12 over 12, D = 64
FLASH_CASES = ((1, 128, 32, 8, 128), (1, 2048, 32, 8, 128), (1, 200, 32, 8, 128),
               (2, 1000, 16, 4, 64), (1, 128, 71, 1, 64), (1, 2048, 71, 1, 64),
               (1, 128, 12, 12, 64), (1, 2048, 12, 12, 64))


def check_flash(P, gen, results, cases=None):
    """B7 at FLASH_CASES, bf16, against its plain version, row by row: every
    output row (one query position of one head) within 2e-2 * its own
    max|ref|. The kernel rounds unnormalized probabilities to bf16 for PV,
    the plain version normalized ones; both then round the output. A row
    late in a long sequence averages many keys and is small, so a limit
    taken from the whole tensor's max|ref| would not see its errors."""
    from llama3_quantization_tpu_torch.ops import flash_attention as fa

    for b, s, h, g, d in cases or FLASH_CASES:
        q, k, v = b7_inputs(gen, s, b, h, g, d)
        label = f"S={s}" if (b, h, g, d) == (1, 32, 8, 128) else f"B={b} S={s} H={h} G={g} D={d}"
        got, ref = fa.flash_attention_cuda(q, k, v).float(), fa.attention_plain(q, k, v).float()
        err = compare(f"B7 {label}", got, ref, 2e-2)
        row_err, row_max = (got - ref).abs().amax(dim=-1), ref.abs().amax(dim=-1)
        worst = float((row_err / row_max.clamp(min=1e-30)).max())
        last = float((row_err / row_max.clamp(min=1e-30))[:, -64:].max())
        log(f"  B7 {label} by row: max over rows of max|err| / max|ref| {worst:.3e}, "
            f"over the last 64 positions {last:.3e}, smallest row max|ref| "
            f"{float(row_max.min()):.3e} (tolerance 2e-2 per row)")
        if not bool((row_err <= 2e-2 * row_max).all()):
            raise AssertionError(f"B7 {label}: a row's error is above 2e-2 * its max|ref|")
        results.setdefault("B7", {})[label] = err


#: (B, S, H, G, D) of the B7.stats, B7.dkv and B7.dq checks: OmniQuant's
#: block training at Llama-3-8B width (batch 2, S = 2048), one q tile of
#: rows at S = 128, D = 64, rep 3 (24 query heads over 8), and the ragged
#: S = 200 (neither B7.dkv's 128-key nor the 64-row tiles divide it)
OMNI_ATTN = (2, 2048, 32, 8, 128)
FLASH_BWD_CASES = ((1, 128, 32, 8, 128), OMNI_ATTN, (1, 512, 32, 8, 64), (1, 256, 24, 8, 128),
                   (1, 200, 32, 8, 128))


def rows_within(name, got, ref, tol, floor=None):
    """Every row (last axis) of `got` within `tol` * its own max|ref|, or
    within `tol` * `floor` (per row) where that is larger."""
    import torch

    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite output")
    row_err, row_max = (got - ref).abs().amax(dim=-1), ref.abs().amax(dim=-1)
    scale = row_max if floor is None else torch.maximum(row_max, floor)
    ratio = row_err / scale.clamp(min=1e-30)
    at = tuple(int(i) for i in torch.unravel_index(ratio.argmax(), ratio.shape))
    log(f"  {name}: max_abs_err {float(row_err.max()):.3e}, max over rows of max|err| / "
        f"{'max|ref|' if floor is None else 'max(max|ref|, floor)'} {float(ratio.max()):.3e} "
        f"(tolerance {tol:g} per row; worst row {at}: max|err| {float(row_err[at]):.3e}, "
        f"max|ref| {float(row_max[at]):.3e}"
        + ("" if floor is None else f", floor {float(floor[at]):.3e}") + ")")
    if not bool((row_err <= tol * scale).all()):
        raise AssertionError(f"{name}: a row's error is above {tol} * its max|ref|")
    return float(row_err.max())


def check_flash_bwd(P, gen, results):
    """B7.stats, B7.dkv and B7.dq at FLASH_BWD_CASES, bf16, against their
    plain versions on the same inputs: o row by row within 2e-2 of each
    row's max|ref| (B7's bound); m within 1e-6 * max(1, |m|) and l within
    1e-5 * l; dq, dk and dv (the backward fed the kernel's own o, m and l)
    row by row within 2e-2 of each row's max|ref|; two calls bit-equal.

    A gradient row is a sum of terms (dq_i of ds_ij k_j, dk_j of ds_ij
    q_i, dv_j of p_ij do_i) whose coefficients both versions round to bf16
    at the same point, from fp32 values that their other sum orders leave a
    few ulps apart (ds = (dp - di) * p * scale, dp and di summed in other
    orders): where one lands on the other side of a bf16 rounding tie, the
    row moves by up to 2^-8 of that term. A row whose terms cancel (a dq
    row's ds sum to 0, and row 0's dp - di is rounding noise: its exact dq
    is 0) can be far smaller than its terms, so each row is held to 2e-2 of
    its own max|ref| or of its largest term before cancellation
    (`backward_terms`), whichever is larger."""
    import torch
    from llama3_quantization_tpu_torch.ops import flash_attention as fa

    for b, s, h, g, d in FLASH_BWD_CASES:
        q, k, v = b7_inputs(gen, s, b, h, g, d)
        do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        label = f"B={b} S={s} H={h} G={g} D={d}"
        o, m, l = fa.flash_attention_stats_cuda(q, k, v)
        ro, rm, rl = fa.attention_stats_plain(q, k, v)
        err_o = rows_within(f"B7.stats o {label}", o, ro, 2e-2)
        dm = (m - rm).abs()
        dl = (l - rl).abs()
        log(f"  B7.stats m {label}: max|err| {float(dm.max()):.3e}, max|err| / max(1, |m|) "
            f"{float((dm / rm.abs().clamp(min=1)).max()):.3e} (tolerance 1e-6); l: max|err| / l "
            f"{float((dl / rl).max()):.3e} (tolerance 1e-5)")
        if not bool((dm <= 1e-6 * rm.abs().clamp(min=1)).all() and (dl <= 1e-5 * rl).all()):
            raise AssertionError(f"B7.stats {label}: m or l outside its bound")
        o2, m2, l2 = fa.flash_attention_stats_cuda(q, k, v)
        if not (torch.equal(o, o2) and torch.equal(m, m2) and torch.equal(l, l2)):
            raise AssertionError(f"B7.stats {label}: two calls differ")
        grads = fa.flash_attention_bwd_cuda(q, k, v, o, do, m, l)
        refs = fa.flash_attention_bwd_plain(q, k, v, o, do, m, l)
        floors = fa.backward_terms(q, k, v, o, do, m, l)
        for name, got, ref, floor in zip(("dq", "dk", "dv"), grads, refs, floors):
            err = rows_within(f"B7.{'dq' if name == 'dq' else 'dkv'} {name} {label}", got, ref,
                              2e-2, floor)
            results.setdefault("B7.dq" if name == "dq" else "B7.dkv", {})[f"{label} {name}"] = err
        again = fa.flash_attention_bwd_cuda(q, k, v, o, do, m, l)
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            raise AssertionError(f"B7.dkv/B7.dq {label}: two calls differ")
        results.setdefault("B7.stats", {})[label] = err_o
        del q, k, v, do, o, m, l, ro, rm, rl, grads, refs, again
        torch.cuda.empty_cache()


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


def run_counted(counts, label, fn, must=(), never=(), routes_ok=False, allow=()):
    """`fn()` with every launch count set to 0 just before it and read just
    after; fails if a kernel form in `must` was not launched, or one in
    `never` was, or (unless `routes_ok`) a call took a route that a
    kernel's shape predicate chose instead of the kernel, or ran on a
    padded weight (`launches.ROUTES`: `.eager`, `pad`), other than the
    routes named in `allow`."""
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
    routed = {k: counts[label][k] for k in launches.ROUTES if counts[label][k] and k not in allow}
    if routed and not routes_ok:
        raise AssertionError(f"{label}: calls turned away from their kernels: {routed}")
    return out


class plain_versions:
    """B1 and B2 stood in by their plain versions (or by the `forms` given,
    a (gemv, gemm) pair) and, unless `flash`, B7 off (the eager attention):
    the reference route of the eval checks."""

    def __init__(self, P, flash=False, forms=None):
        from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

        self.P, self.fq, self.flash = P, fq, flash
        self.forms = forms or (fq.qmm_gemv_plain, fq.qmm_gemm_plain)

    def __enter__(self):
        self.orig = self.fq.qmm_gemv, self.fq.qmm_gemm
        self.fq.qmm_gemv, self.fq.qmm_gemm = self.forms
        self.P.set_flash("auto" if self.flash else False)

    def __exit__(self, *exc):
        self.fq.qmm_gemv, self.fq.qmm_gemm = self.orig
        self.P.set_flash("auto")


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


def build_rtn_params(P, seed=0):
    """Llama-3-8B with seeded random-normal weights (SEED + 4 + `seed`)
    RTN-quantized to W4 g128 packed, on the card. The synthetic packed codes (uniform nibbles, zero
    point 8) give every linear a mean code offset of -0.5, a rank-1 bias
    under which the logits barely depend on the input (one argmax at every
    position); these weights keep token streams input-dependent, so that
    comparing them tests something."""
    import torch

    cfg = P.LLAMA3_8B
    t0 = time.time()
    fp = P.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 4 + seed))
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


def drive_routes(P, params, card):
    """The JAX package's decode routes on input-dependent weights: the
    16-request int8 serving run under `set_decode_kernel(False)` (every
    step eager over the read-back cache: no B5 form, no window), then under
    `set_decode_attn("xla")` (the codes-direct route in the windows: no B5
    form), each pipelined against sequential. The switches are reset in a
    `finally`."""
    cfg, counts = P.LLAMA3_8B, {}
    try:
        P.set_decode_kernel(False)
        serve_and_compare(P, params, cfg, card, "RTN serve int8 decode_kernel(False)", counts,
                          ("B1", "B2"), min_distinct=64, never=B5_KEYS + ("B6",),
                          windowed=False)
    finally:
        P.set_decode_kernel("auto")
    try:
        P.set_decode_attn("xla")
        serve_and_compare(P, params, cfg, card, "RTN serve int8 decode_attn(xla)", counts,
                          ("B1", "B2"), min_distinct=64, never=B5_KEYS + ("B6",), windowed=True)
    finally:
        P.set_decode_attn("auto")
    return sum_counts(counts)


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
                      quantized_cache=8, never=(), windowed=None, allow=()):
    """`ServingEngine(8 slots, max_len 512, ljf, quantized_cache, fuse)`:
    `run_pipelined(16)` on the 16 requests of the serve mix (after a warm-up
    request) against the sequential `step_n(16)` loop, both counted runs
    that must launch the kernel forms `must` and none of `never`; with
    `windowed` True (False), the engine must (must not) have dispatched a
    window; `allow` names the routes (`launches.ROUTES`) its calls may take.
    Returns the pipelined streams."""
    k, reqs = 16, serve_requests(16, cfg.vocab_size)
    eng = P.ServingEngine(params, cfg, max_slots=8, max_len=512, quantized_cache=quantized_cache,
                          schedule="ljf", fuse=fuse)
    pipelined_streams(eng, [(reqs[0][0][:20], 2 * k)], k)  # warm-up: first calls, allocations
    warm_steps = eng.dispatches["steps"]
    pipe, dt = run_counted(counts, f"{label} run_pipelined",
                           lambda: timed(lambda: pipelined_streams(eng, reqs, k)), must=must,
                           never=never, allow=allow)
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
                              never=never, allow=allow)
    log(f"{label} sequential step_n({k}) loop: {produced / dt_seq:.1f} tok/s ({dt_seq:.2f} s, "
        f"host clock)  [{card}]")
    if seq != pipe:
        diff = sum(a != b for a, b in zip(seq, pipe))
        raise AssertionError(f"{label}: run_pipelined and step_n streams differ ({diff} of 16)")
    if windowed is not None and (eng.dispatches["windowed"] > 0) != windowed:
        raise AssertionError(f"{label}: windows dispatched {eng.dispatches}, expected "
                             f"{'some' if windowed else 'none'}")
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


def check_c2(P):
    """Shapes the JAX package computes that a kernel does not take, on the
    card against the same calls on the CPU, each through the route its
    kernel's predicate chooses (the counts name it): TINY_LLAMA
    `forward_logits` at S = 128 (D = 16: eager, not B7; fp32 weights, 1e-4
    of max|logit|); decode on a llama of TINY_LLAMA's widths with rep 6 on
    the int8, int4 and fp32 caches (B5 and B6 with rep padded to 8, none
    turned away to the eager attention; RTN W4 g32
    weights: B7's bound, 2e-2 of each row's max|logit|: B1/B2's bf16
    inputs, and a KV code that rounds the other way on the card); linears with N %
    16 != 0, with K not a whole number of 64-row tiles and with a group size
    of 8 through B1 and B2 on the weight padded once by `pad_for_kernels`
    (fp32 out, 1e-4 * max|ref| of the plain version on the weight as it
    is), and B3.v3 on the same padded weights (bit-equal to `a8_plain` on
    the weight as it is)."""
    import dataclasses

    import numpy as np
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq
    from llama3_quantization_tpu_torch.ops import launches
    from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa
    from llama3_quantization_tpu_torch.tools.reproduce_study import load_tiny_params

    log("C2 shapes (turned away from their kernels by shape), card against CPU:")
    cfg = P.TINY_LLAMA
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=torch.Generator().manual_seed(5))
    ref = P.forward_logits(load_tiny_params("cpu"), toks, cfg)
    launches.reset()
    got = P.forward_logits(load_tiny_params("cuda"), toks.cuda(), cfg)
    c = launches.snapshot()
    if c["B7"] or c["B7.eager"] != cfg.num_layers:
        raise AssertionError(f"TINY_LLAMA S=128: B7 {c['B7']}, B7.eager {c['B7.eager']}")
    compare("TINY_LLAMA forward_logits [2, 128] (D=16, eager: B7.eager "
            f"{c['B7.eager']})", got.cpu(), ref, 1e-4)

    rcfg = dataclasses.replace(cfg, num_heads=12, num_kv_heads=2, hidden_size=192)
    fp = P.init_params(rcfg, torch.Generator().manual_seed(6), dtype=torch.float32, device="cpu")
    rtn = P.quantize_model_rtn(fp, rcfg, P.QuantSpec(n_bits=4, group_size=32), pack=True)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(7))
    for bits in (8, 4, False):
        outs = {}
        for dev in ("cpu", "cuda"):
            p = rtn if dev == "cpu" else to_device(rtn, dev)
            cache = P.init_kv_cache(rcfg, 2, 64, dtype=torch.float32, quantized=bits, device=dev)
            _, cache = P.decode_step(p, cache, prompt.to(dev), 0, rcfg)
            launches.reset()
            step, cache = P.decode_step(p, cache, prompt[:, -1:].to(dev), 40, rcfg)
            out, _ = P.greedy_generate(p, cache, prompt[:, -1:].to(dev), 41, 4, rcfg)
            outs[dev] = (step.float().cpu(), out.cpu(), launches.snapshot())
        c = outs["cuda"][2]
        forms = {k: c[k] for k in c if k.startswith(("B5", "B6")) and not k.endswith(".eager")
                 and c[k]}
        if sum(forms.values()) < 5 * rcfg.num_layers or c["B5.eager"] or c["B6.eager"]:
            raise AssertionError(f"rep 6 {bits}: kernels {forms}, B5.eager {c['B5.eager']}, "
                                 f"B6.eager {c['B6.eager']}")
        compare_rows(f"rep-6 decode step, {'fp32' if bits is False else f'int{bits}'} cache "
                     f"(rep padded to 8: {forms}, greedy {outs['cuda'][1].tolist()})",
                     outs["cuda"][0], outs["cpu"][0], 2e-2)

    gen = np.random.default_rng(8)
    for m, k, n, gs in ((1, 256, 40, 64), (80, 256, 40, 64), (1, 96, 64, 32), (80, 96, 64, 32),
                        (80, 288, 40, 96), (1, 256, 48, 8), (80, 256, 48, 8)):
        w = torch.from_numpy(gen.standard_normal((k, n)).astype(np.float32)).cuda()
        qt = P.quantize_rtn(w, P.QuantSpec(n_bits=4, group_size=gs), pack=True)
        wp = P.pad_for_kernels({"w": qt})["w"]
        x = torch.from_numpy(gen.standard_normal((m, k)).astype(np.float32)).cuda()
        launches.reset()
        with P.backend("pallas"):
            got = P.qmatmul(x, wp, out_dtype=torch.float32)
        c = launches.snapshot()
        if c["pad"] != 1 or c["B1"] + c["B2"] != 1:
            raise AssertionError(f"linear M={m} K={k} N={n} gs={gs}: {c}")
        plain = fq.qmm_gemv_plain if m <= fq.GEMV_MAX_M else fq.qmm_gemm_plain
        compare(f"linear M={m} K={k} N={n} gs={gs} (padded to K={wp.w.k} N={wp.w.n} "
                f"gs={wp.w.group_size}): B1 {c['B1']}, B2 {c['B2']}, pad {c['pad']}",
                got, plain(x, qt, torch.float32), 1e-4)
        launches.reset()
        got = fq.fused_dequant_matmul(wp.pad_x(x), wp.w, out_dtype=torch.float32,
                                      version=3)[:, :n]
        xq, s_x = qa.quantize_activations_s8(x)
        ref = qa.a8_plain(xq, s_x, qt.data, "u4", qt.scale, qt.zero, gs, torch.float32)
        c = launches.snapshot()
        compare(f"  v3 (B3.v3 {c['B3.v3']}, B3.gemm {c['B3.gemm']})", got, ref, 0.0)


#: the OmniQuant phase's bounds: first step's loss (relative) and LWC
#: gradients (||diff|| / ||ref||) through B7.stats/B7.dkv/B7.dq against the
#: eager attention under autograd
OMNI_LOSS_TOL = 1e-3
OMNI_GRAD_TOL = 2e-2


def quantize_cfg(P):
    """Llama-3-8B widths, depth cut to 2 layers (for time)."""
    import dataclasses

    return dataclasses.replace(P.LLAMA3_8B, num_layers=2)


def drive_quantize(P, card):
    """The calibration quantizers at Llama-3-8B width (2 layers: the depth
    cut), bf16 random-normal parameters from a seed, 4 calibration windows of
    2048 tokens:

    1. GPTQ W4 g128 (`gptq_quantize_model`, packed): the capture's and the
       propagation's attention through B7; per layer, each linear's output
       SNR on the inputs its solve saw no worse than RTN's (`snr_error`,
       lower is better); seconds per layer.
    2. OmniQuant W4 g128 LWC, 2 epochs, batch 2: the first training step's
       loss within OMNI_LOSS_TOL and its LWC gradients within OMNI_GRAD_TOL
       of the same step under `set_flash(False)`; `omniquant_model` launching
       B7.stats, B7.dkv and B7.dq once per layer and step; each layer's last
       epoch loss at or below its first; the model's output MSE against the
       fp model (final hidden states on the calibration windows, the "xla"
       backend) below RTN's, the model-level criterion of JAX's
       `tests/test_algorithms.py:188-201`.
    3. `forward_logits` [1, 2048] of both quantized models under "pallas":
       finite, no call turned away from its kernel (`launches.ROUTES`)."""
    import numpy as np
    import torch
    from llama3_quantization_tpu_torch.models import transformer as TT
    from llama3_quantization_tpu_torch.quant import calibration as TC
    from llama3_quantization_tpu_torch.quant import gptq as TG
    from llama3_quantization_tpu_torch.quant import omniquant as TO

    cfg = quantize_cfg(P)
    spec = P.QuantSpec(n_bits=4, group_size=GS)
    params = P.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 7),
                           dtype=torch.bfloat16, device="cuda")
    calib = np.random.default_rng(SEED + 7).integers(0, cfg.vocab_size, (4, 2048))
    counts = {}
    log(f"quantize phase: Llama-3-8B widths, {cfg.num_layers} layers (depth cut), bf16, "
        f"calibration 4 x 2048 tokens  [{card}]")

    stamps = [time.perf_counter()]

    def tick(l, n, errs):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        log(f"  GPTQ layer {l}/{n}: {stamps[-1] - stamps[-2]:.2f} s  [{card}]")

    gq = run_counted(counts, "GPTQ W4 g128 (capture and propagation through B7)",
                     lambda: TC.gptq_quantize_model(params, cfg, calib, spec, pack=True,
                                                    progress=tick),
                     must=("B7",))
    # each linear on the inputs its solve saw (the GPTQ stream), against RTN
    with torch.no_grad():
        tokens = TC.calib_tensor(params, calib)
        h, cos_sin, mask = TC.embed_calibration(params, cfg, tokens)
        for l in range(cfg.num_layers):
            p_fp, p_q = TC._layer_slice(params["layers"], l), TC._layer_slice(gq["layers"], l)
            with P.backend("xla"):
                caps = TC.layer_linear_inputs(p_fp, h, cfg, P.NO_QUANT, cos_sin, mask)
                for name in TC.linear_names(cfg):
                    x = caps[name].reshape(-1, caps[name].shape[-1])
                    ref = x.float() @ p_fp[name]["w"].float()
                    snr_g = TG.snr_error(P.qmatmul(x, p_q[name]["w"]), ref)
                    snr_r = TG.snr_error(P.qmatmul(x, P.quantize_rtn(p_fp[name]["w"], spec)), ref)
                    log(f"  layer {l} {name}: output SNR (noise/signal) GPTQ {snr_g:.4e}, "
                        f"RTN {snr_r:.4e}")
                    if not snr_g <= snr_r:
                        raise AssertionError(f"GPTQ layer {l} {name}: SNR {snr_g} worse than "
                                             f"RTN's {snr_r}")
                del caps
                h = TC.run_layer_xla(p_q, h, cfg, P.NO_QUANT, cos_sin, mask)
        del h

    # OmniQuant: the first step, kernels against the eager attention
    ocfg = TO.OmniConfig(wspec=spec, epochs=2, batch_size=2, pack=True)  # sets wspec.lwc
    with torch.no_grad():
        h, cos_sin, mask = TC.embed_calibration(params, cfg, TC.calib_tensor(params, calib[:2]))
        p0 = TC._layer_slice(params["layers"], 0)
        target = TT.decoder_layer(p0, h, cfg, P.NO_QUANT, cos_sin, mask)
    aux = {"lwc": TO.init_layer_lwc(p0, cfg, ocfg.wspec)}
    launches_before = dict(P.launches.COUNTS)
    (loss, grads), dt = timed(lambda: TO.omni_loss_and_grads(
        aux, p0, h, target, target, cfg, ocfg, P.NO_QUANT, cos_sin, mask))
    step_counts = {k: P.launches.COUNTS[k] - launches_before[k]
                   for k in ("B7.stats", "B7.dkv", "B7.dq", "B7.eager")}
    if step_counts != {"B7.stats": 1, "B7.dkv": 1, "B7.dq": 1, "B7.eager": 0}:
        raise AssertionError(f"OmniQuant step launches: {step_counts}")
    TT.set_flash(False)
    try:
        (rloss, rgrads), rdt = timed(lambda: TO.omni_loss_and_grads(
            aux, p0, h, target, target, cfg, ocfg, P.NO_QUANT, cos_sin, mask))
    finally:
        TT.set_flash("auto")
    got = torch.cat([x.flatten() for x in TO._aux_leaves(grads)])
    ref = torch.cat([x.flatten() for x in TO._aux_leaves(rgrads)])
    lrel = abs(float(loss) - float(rloss)) / abs(float(rloss))
    grel = float((got - ref).norm() / ref.norm())
    log(f"  OmniQuant first step (layer 0, batch 2 x 2048): loss {float(loss):.6e} through "
        f"B7.stats/B7.dkv/B7.dq ({dt:.3f} s) vs {float(rloss):.6e} eager ({rdt:.3f} s): "
        f"relative {lrel:.3e} (tolerance {OMNI_LOSS_TOL:g}); LWC grads ||diff||/||ref|| "
        f"{grel:.3e} (tolerance {OMNI_GRAD_TOL:g})  [{card}]")
    if not (lrel <= OMNI_LOSS_TOL and grel <= OMNI_GRAD_TOL):
        raise AssertionError("OmniQuant step through the kernels is off the eager step")
    del h, target, grads, rgrads, got, ref
    torch.cuda.empty_cache()

    epochs = []
    oq, odt = timed(lambda: run_counted(
        counts, "OmniQuant W4 g128 LWC (2 epochs, batch 2: B7.stats, B7.dkv, B7.dq)",
        lambda: TO.omniquant_model(params, cfg, calib, ocfg, epoch_log=epochs),
        must=("B7.stats", "B7.dkv", "B7.dq")))
    steps = cfg.num_layers * ocfg.epochs * (len(calib) // ocfg.batch_size)
    c = counts["OmniQuant W4 g128 LWC (2 epochs, batch 2: B7.stats, B7.dkv, B7.dq)"]
    log(f"  OmniQuant: {odt:.2f} s for {cfg.num_layers} layers ({odt / cfg.num_layers:.2f} s a "
        f"layer), {steps} training steps; epoch losses {epochs}; launches B7.stats "
        f"{c['B7.stats']}, B7.dkv {c['B7.dkv']}, B7.dq {c['B7.dq']}  [{card}]")
    if not c["B7.stats"] == c["B7.dkv"] == c["B7.dq"] == steps:
        raise AssertionError(f"OmniQuant: {steps} steps, launches {c}")
    for l in range(cfg.num_layers):
        losses = [loss_ for layer, _, loss_ in epochs if layer == l]
        first, last = losses[0], losses[-1]
        if not last <= first:
            raise AssertionError(f"OmniQuant layer {l}: last epoch's loss {last} above {first}")
    rtn = P.quantize_model_rtn(params, cfg, spec, pack=True)
    with torch.no_grad(), P.backend("xla"):
        toks = TC.calib_tensor(params, calib)
        ref = P.forward_hidden(params, toks, cfg).float()
        mse = {name: float(((P.forward_hidden(tree, toks, cfg).float() - ref) ** 2).mean())
               for name, tree in (("omniquant", oq), ("rtn", rtn))}
        log(f"  final hidden state MSE against the fp model on the calibration windows: "
            f"OmniQuant {mse['omniquant']:.6e}, RTN {mse['rtn']:.6e}  [{card}]")
        if not mse["omniquant"] < mse["rtn"]:
            raise AssertionError(f"OmniQuant: the model's output MSE not below RTN's {mse}")
        del ref
    del rtn

    toks = torch.from_numpy(calib[:1]).cuda()
    for name, tree in (("GPTQ", gq), ("OmniQuant", oq)):
        logits = run_counted(counts, f"forward_logits [1, 2048] {name} W4 g128 (pallas)",
                             lambda: P.forward_logits(tree, toks, cfg), must=("B2", "B7"))
        if not bool(logits.isfinite().all()):
            raise AssertionError(f"{name} forward_logits: non-finite logits")
        log(f"  {name} forward_logits [1, 2048]: finite, max|logit| "
            f"{float(logits.float().abs().max()):.4f}")
    del params, gq, oq
    torch.cuda.empty_cache()
    return sum_counts(counts)


def check_qmatmul_hqq(P, gen, results):
    """B1 at M = 1 and 8 and B2 at M = 128 and 2048 on HQQ W4 weights: the
    continuous float zeros of `hqq_solve` on seeded random-normal weights, at
    group sizes 64 and 128, on every decoder linear shape; B2 rounds each
    zero to bf16 as JAX's kernel does (`pallas_qmatmul.py:98`), its plain
    version too."""
    import math

    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq
    from llama3_quantization_tpu_torch.quant.hqq import hqq_quantize_weight

    for label, (k, n) in LINEAR_SHAPES.items():
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        for gs in (64, 128):
            qt = hqq_quantize_weight(w, P.QuantSpec(n_bits=4, group_size=gs), pack=True)
            frac = float((qt.zero - qt.zero.round()).abs().mean())
            if not frac > 0.01:
                raise AssertionError(f"HQQ g{gs} {label}: zeros not continuous ({frac})")
            for kid, m in HQQ_QMM_CASES:
                kern, plain = ((fq.qmm_gemv, fq.qmm_gemv_plain) if kid == "B1"
                               else (fq.qmm_gemm, fq.qmm_gemm_plain))
                x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                compare(f"{kid} HQQ g{gs} {label} M={m} fp32-out", kern(x, qt, torch.float32),
                        plain(x, qt, torch.float32), 1e-4)
                err = compare(f"{kid} HQQ g{gs} {label} M={m} bf16-out",
                              kern(x, qt, torch.bfloat16), plain(x, qt, torch.bfloat16), 1e-2)
                results.setdefault(kid, {})[f"HQQ g{gs} {label} M={m}"] = err
        del w


#: (kernel id, M) of the HQQ-weight checks: decode and the 8-slot engine
#: (B1), a 128-token prefill and a PPL window of 2048 (B2)
HQQ_QMM_CASES = (("B1", 1), ("B1", 8), ("B2", 128), ("B2", 2048))
#: the CLI's `--seed` default: `--net` parameters come from this seed
CLI_SEED = 2


def cli_run(P, counts, label, argv, must=()):
    """`cli.main(argv)` in this process, counted; returns (the results JSON
    it printed last, the quantized tree and the seconds `api.quantize`
    took)."""
    import contextlib
    import io

    import torch
    from llama3_quantization_tpu_torch import api, cli

    seen = {}
    orig = api.quantize

    def spy(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen["params"] = orig(*a, **k)
        torch.cuda.synchronize()
        seen["secs"] = time.perf_counter() - t0
        return seen["params"]

    out = io.StringIO()
    api.quantize = spy
    try:
        with contextlib.redirect_stdout(out):
            run_counted(counts, label, lambda: cli.main(argv), must=must)
    finally:
        api.quantize = orig
    lines = out.getvalue().strip().splitlines()
    log(f"  cli.main {' '.join(argv)}: printed {lines[-1]}")
    return json.loads(lines[-1]), seen.get("params"), seen.get("secs")


def icq_card_vs_cpu(w, tau_n=10):
    """`icq_search` on the card against the same call on the CPU: the
    chosen factor equal on >= 99% of blocks and, where it is equal, the
    codes, absmax and tau codes equal; returns (equal share, blocks)."""
    import torch
    from llama3_quantization_tpu_torch.quant import irqlora as TI

    def run(x):
        wb = x.float().reshape(-1, 256, 64)
        tau0 = TI._median(wb)
        absmax0 = (wb - tau0).abs().amax(dim=2, keepdim=True)
        factors = torch.from_numpy(TI.icq_factors(0.1, tau_n)).to(x.device)
        best = TI.icq_best(wb, tau0, absmax0, factors)
        return best.cpu(), TI.icq_search(x, tau_range=0.1, tau_n=tau_n)

    best_g, qg = run(w)
    best_c, qc = run(w.cpu())
    same = best_g == best_c
    share = float(same.float().mean())
    codes = (qg.codes.cpu() == qc.codes).all(-1).reshape(same.shape)
    absmax = (qg.absmax.cpu() == qc.absmax).reshape(same.shape)
    tau = (qg.tau_codes.cpu() == qc.tau_codes).reshape(same.shape)
    if not (share >= 0.99 and bool((codes & absmax & tau)[same].all())):
        raise AssertionError(f"icq_search card vs CPU: factor equal on {share:.4f} of blocks; "
                             f"outputs equal where it is: {bool((codes & absmax & tau)[same].all())}")
    return share, same.numel()


def drive_cli(P, card):
    """Phase 10, the CLI slice:

    1. `cli.main` in this process at full Llama-3-8B width and depth: `--net
       llama3-8b` (fp32, seed 2), HQQ W4 g128 packed, `--eval_ppl` over 2
       windows of 2048 (`--limit 2`, JAX's `default_rng(0)` ids) on the
       port's default backend (pallas: B2 and B7); the results line parses,
       the PPL is finite, and no call leaves its kernel. The same windows
       through B1's and B2's plain versions with the eager attention: |d ln
       PPL| <= EVAL_LN_PPL_TOL; through the xla route: reported.
    2. A checkpoint at 8B width, depth cut to 2 layers: `cli.main ... --save_dir`
       (HQQ W4 g128 packed), `load_checkpoint` into the same model rebuilt
       here: every leaf and `forward_logits` [1, 128] bit-equal. The
       directory is removed afterwards.
    3. HQQ W4 g128 at full depth (bf16, the random-normal weights
       `build_rtn_params` starts from) on the decode paths: the default
       engine (fp cache) pipelined = sequential on B1 at M = 8 and B6; a
       128-token prefill and 32 greedy steps on the int8 cache (B5), decode
       against the teacher-forced forward < 0.15.
    4. IR-QLoRA at 8B width, 2 layers, the reference's tau_n = 100: ICQ
       seconds a layer; `icq_search` on the card against the CPU on layer
       0's k projection at tau_n = 10 (`icq_card_vs_cpu`); `compute_ppl`
       over 2 windows of 2048 (B7) and 8 greedy steps on the fp cache (B6),
       decode against forward < 0.15."""
    import dataclasses
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch
    from llama3_quantization_tpu_torch import api
    from llama3_quantization_tpu_torch.eval import compute_ppl
    from llama3_quantization_tpu_torch.models import configs as TCFG
    from llama3_quantization_tpu_torch.models.hf_loader import load_checkpoint
    from llama3_quantization_tpu_torch.utils.pytree_io import tree_leaves

    counts, checks = {}, {}
    cfg = P.LLAMA3_8B
    spec = P.QuantSpec(n_bits=4, group_size=GS)
    t_phase = time.time()
    tmp = tempfile.mkdtemp(prefix="l3q_cli_")
    try:
        # 1. the CLI's PPL run at full width and depth
        argv = ["--net", "llama3-8b", "--quant_method", "hqq", "--wbits", "4", "--group_size",
                str(GS), "--eval_ppl", "--ppl_datasets", "wikitext2", "--seqlen", "2048",
                "--limit", "2", "--output_json", os.path.join(tmp, "results.json")]
        res, hq, secs = cli_run(P, counts, "cli.main --net llama3-8b hqq W4 g128 --eval_ppl "
                                "(2 windows of 2048, pallas)", argv, must=("B2", "B7"))
        ppl = res["wikitext2"]
        if not (math.isfinite(ppl) and json.loads(open(argv[-1]).read()) == res):
            raise AssertionError(f"cli.main: PPL {ppl}, or --output_json differs from stdout")
        log(f"  HQQ W4 g128, {cfg.num_layers} layers (fp32 weights): {secs:.2f} s, "
            f"{secs / cfg.num_layers:.3f} s a layer  [{card}]")
        stream = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 2048 * 4))
        with plain_versions(P):
            ppl_plain = run_counted(checks, "HQQ PPL, B1/B2 plain, eager attention (check)",
                                    lambda: compute_ppl(hq, cfg, stream, seqlen=2048, limit=2),
                                    never=("B1", "B2", "B7"))
        P.set_flash(False)
        try:
            with P.backend("xla"):
                ppl_xla = run_counted(checks, "HQQ PPL, xla route (check)",
                                      lambda: compute_ppl(hq, cfg, stream, seqlen=2048, limit=2),
                                      never=("B1", "B2", "B7"))
        finally:
            P.set_flash("auto")
        d_plain = abs(math.log(ppl) - math.log(ppl_plain))
        d_xla = abs(math.log(ppl) - math.log(ppl_xla))
        log(f"  HQQ PPL (2 windows of 2048): kernels {ppl:.4f}, plain versions {ppl_plain:.4f} "
            f"(|d ln PPL| {d_plain:.3e}, limit {EVAL_LN_PPL_TOL:g}), xla route {ppl_xla:.4f} "
            f"(|d ln PPL| {d_xla:.3e}, reported: B2 rounds HQQ's float zeros to bf16)  [{card}]")
        if not d_plain <= EVAL_LN_PPL_TOL:
            raise AssertionError(f"HQQ PPL kernels {ppl} against plain {ppl_plain}")
        del hq
        torch.cuda.empty_cache()

        # 2. a checkpoint at 8B width, 2 layers, through --save_dir
        small = quantize_cfg(P)
        name = "llama3-8b-2layers"
        ckpt = os.path.join(tmp, "ckpt")
        TCFG.NAMED_CONFIGS[name] = small
        try:
            (_, saved, _), dt = timed(lambda: cli_run(
                P, checks, "cli.main --net llama3-8b (2 layers) hqq --save_dir (check)",
                ["--net", name, "--quant_method", "hqq", "--wbits", "4", "--group_size", str(GS),
                 "--save_dir", ckpt]))
        finally:
            del TCFG.NAMED_CONFIGS[name]
        size = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        like = api.quantize(P.init_params(small, torch.Generator(device="cuda").manual_seed(
            CLI_SEED), dtype=torch.float32), small, "hqq", spec)
        loaded, dt_load = timed(lambda: load_checkpoint(ckpt, like))
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(saved), tree_leaves(loaded)))
        rebuilt = all(torch.equal(a, b) for a, b in zip(tree_leaves(saved), tree_leaves(like)))
        toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=torch.Generator(
            device="cuda").manual_seed(SEED + 12), device="cuda")
        with torch.inference_mode():
            a, b = P.forward_logits(saved, toks, small), P.forward_logits(loaded, toks, small)
        log(f"  checkpoint (8B width, 2 layers, HQQ W4 g128 packed): {size / 2**30:.2f} GiB "
            f"written with the run in {dt:.1f} s, loaded in {dt_load:.1f} s; leaves bit-equal "
            f"{same} (rebuilt model {rebuilt}); forward_logits [1, 128] bit-equal "
            f"{bool(torch.equal(a, b))}  [{card}]")
        if not (same and torch.equal(a, b)):
            raise AssertionError("checkpoint round trip is not bit-equal")
        shutil.rmtree(ckpt)
        del saved, like, loaded, a, b
        torch.cuda.empty_cache()

        # 3. HQQ at full depth on the decode paths
        t0 = time.time()
        fp = P.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED + 4))
        hq = api.quantize(fp, cfg, "hqq", spec)
        del fp
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"  HQQ W4 g128 (bf16 random-normal weights, {cfg.num_layers} layers) in "
            f"{time.time() - t0:.2f} s")
        serve_and_compare(P, hq, cfg, card, "HQQ serve fp", counts, FP_MUST, min_distinct=64,
                          quantized_cache=False, never=B5_KEYS)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
        prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")
        cache = P.init_kv_cache(cfg, 1, 512, quantized=8)
        lg, cache = P.decode_step(hq, cache, prompt, 0, cfg)
        first = lg[:, -1].argmax(dim=-1)[:, None]
        toks, _ = run_counted(counts, "HQQ greedy_generate 32 steps (int8 cache)",
                              lambda: P.greedy_generate(hq, cache, first, 128, 32, cfg),
                              must=("B1", "B5"), never=("B6",))
        rel = decode_vs_forward(P, hq, cfg, prompt, torch.cat([first, toks[:, :8]], 1), 8)
        log(f"  HQQ greedy decode (int8 cache): {len(set(toks[0].tolist()))} distinct tokens in "
            f"32; decode-vs-forward max rel logit error {rel:.3e} (limit 0.15)")
        if not rel < 0.15:
            raise AssertionError(f"HQQ decode/forward divergence: rel err {rel:.4f}")
        del hq, cache
        torch.cuda.empty_cache()

        # 4. IR-QLoRA at 8B width, 2 layers, tau_n = 100
        fp = P.init_params(small, torch.Generator(device="cuda").manual_seed(SEED + 7))
        share, blocks = icq_card_vs_cpu(fp["layers"]["k"]["w"][0])
        log(f"  icq_search card vs CPU (k projection [4096, 1024], tau_n 10): chosen factor "
            f"equal on {share:.4f} of {blocks} blocks; codes, absmax, tau codes equal there")
        stamps = [time.perf_counter()]

        def tick(l, n):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            log(f"  ICQ layer {l}/{n} (tau_n 100, 201 factors): {stamps[-1] - stamps[-2]:.2f} s  "
                f"[{card}]")

        ir = api.quantize(fp, small, "irqlora", progress=tick)
        moved = float((ir["layers"]["down"]["w"].float() - fp["layers"]["down"]["w"].float())
                      .abs().max())
        del fp
        ppl_ir = run_counted(counts, "IR-QLoRA compute_ppl [1, 2048] x 2 (B7)",
                             lambda: compute_ppl(ir, small, stream, seqlen=2048, limit=2),
                             must=("B7",))
        cache = P.init_kv_cache(small, 1, 512)
        lg, cache = P.decode_step(ir, cache, prompt, 0, small)
        first = lg[:, -1].argmax(dim=-1)[:, None]
        toks, _ = run_counted(counts, "IR-QLoRA greedy_generate 8 steps (fp cache)",
                              lambda: P.greedy_generate(ir, cache, first, 128, 8, small),
                              must=("B6",), never=B5_KEYS)
        rel = decode_vs_forward(P, ir, small, prompt, torch.cat([first, toks], 1), False)
        log(f"  IR-QLoRA (2 layers, weights moved up to {moved:.3e}): PPL {ppl_ir:.4f} over 2 "
            f"windows; greedy decode (fp cache) vs forward max rel logit error {rel:.3e} "
            f"(limit 0.15)  [{card}]")
        if not (math.isfinite(ppl_ir) and moved > 0 and rel < 0.15):
            raise AssertionError(f"IR-QLoRA: PPL {ppl_ir}, moved {moved}, rel err {rel}")
        del ir, cache
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 10 (the CLI slice) in {time.time() - t_phase:.1f} s  [{card}]")
    return sum_counts(counts)


def to_device(tree, device):
    """A parameter tree (dicts of tensors and QuantizedTensors) on `device`."""
    import dataclasses

    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if hasattr(tree, "scale") and hasattr(tree, "data"):
        return dataclasses.replace(
            tree, data=tree.data.to(device), scale=tree.scale.to(device),
            zero=None if tree.zero is None else tree.zero.to(device))
    return tree.to(device)


#: the golden bound of `tests/test_golden_study.py:36-38`
GOLDEN_REL = 2e-3


def drive_golden(P, card):
    """The study's golden rows on the card: `run_study(ROWS, device="cuda")`
    and `run_study(SEQ2SEQ_ROWS, device="cuda")`, every decoder row (fp, rtn, gptq, awq, smoothquant,
    omniquant, hqq, irqlora, mixed, rtn_s4, rtn_a8; TINY_LLAMA fp32, PPL over 24
    windows of 64 tokens, piqa and arc_easy zero-shot) and the seq2seq rows
    (seq2seq_fp, seq2seq_rtn, seq2seq_gptq: the tiny T5, piqa and arc_easy) against
    `tests/fixtures/golden_study.json` within |got - golden| <= 2e-3 *
    max(1, |golden|). The s4 and a8 rows run B3. The seq2seq rows run under
    "xla" (JAX's default) on the tiny T5's g8 weights, which
    `Seq2SeqTorchLM` pads once to the kernels' tiles (`pad_for_kernels`):
    the only path allowed the `pad` route."""
    from llama3_quantization_tpu_torch.tools import reproduce_study as study

    counts = {}
    table = run_counted(counts, "golden rows (TINY_LLAMA study)",
                        lambda: study.run_study(list(study.ROWS), device="cuda", verbose=False),
                        must=("B3.s4", "B3.s8", "B3.gemm"))
    table.update(run_counted(counts, "golden rows (tiny T5 study, xla, g8 weights padded)",
                             lambda: study.run_study(list(study.SEQ2SEQ_ROWS), device="cuda",
                                                     verbose=False),
                             never=("B1", "B2"), allow=("pad",)))
    golden = json.loads(study.GOLDEN.read_text())
    for method, row in table.items():
        for key, val in row.items():
            g = golden[method][key]
            log(f"  golden row {method}.{key}: {val} (golden {g}, |diff| {abs(val - g):.4g}, "
                f"bound {GOLDEN_REL * max(1.0, abs(g)):.4g})  [{card}]")
    misses = study.golden_misses(table)
    if misses:
        raise AssertionError(f"golden rows missed on the card: {misses}")
    return sum_counts(counts)


#: |ln PPL(kernels) - ln PPL(reference route)| and the largest |log-likelihood|
#: difference per continuation token allowed at full width
EVAL_LN_PPL_TOL = 1e-2
EVAL_LL_TOL = 1e-2
#: the same bound with the model's bf16 activations, kernels against their
#: plain versions: just above what the plain versions read against
#: themselves with every sum over K reversed (`reversed_plain`: 1.585e-2)
#: and the kernels against them (2.000e-2), one run on an H100 80GB HBM3
#: at 700 W
EVAL_LL_BF16_TOL = 2.5e-2


def eval_requests(tokenizer):
    """The study's piqa and arc_easy loglikelihood requests, zero-shot."""
    import random

    from llama3_quantization_tpu_torch.eval.harness import get_task_dict
    from llama3_quantization_tpu_torch.tools.reproduce_study import TASK_DATA

    reqs = []
    for task in get_task_dict(["piqa", "arc_easy"], TASK_DATA).values():
        docs = task.test_docs() if task.has_test_docs() else task.validation_docs()
        for doc in docs:
            ctx = task.fewshot_context(doc, 0, random.Random(42))
            reqs += [r.args for r in task.construct_requests(doc, ctx)]
    return reqs


def drive_eval(P, params, card):
    """The eval front end at full width (Llama-3-8B, 32 layers, the RTN W4
    g128 params; `ByteTokenizer` over the fixture's back half):
    `compute_ppl(seqlen=2048, limit=4)` under pallas with `set_flash("auto")`
    (B2 and B7) against the reference route (the xla backend with
    `set_flash(False)`: no B2, no B7), |d ln PPL| <= EVAL_LN_PPL_TOL;
    `TorchLM.loglikelihood` on the study's piqa and arc_easy requests
    (batch 4) on the kernel route against the same route through B1's and
    B2's plain versions, with fp32 activations (the same packed linears):
    |d log-likelihood| per continuation token <= EVAL_LL_TOL. Reported
    with the bf16 activations of the other phases, the kernel route against
    the plain versions within EVAL_LL_BF16_TOL, set just above the floor
    that the plain versions read against themselves with every sum over K
    reversed (`reversed_plain`): another order of the fp32 sums rounds some
    bf16 activation the other way, and 32 layers of random-normal weights
    compound it. Reported only: both models against the xla route with
    `set_flash(False)`, which rounds each group scale's product once where
    B2 rounds the scale to bf16 first (as the TPU kernel does) and rounds
    every linear's output to the weights' bf16. `TorchLM.greedy_until` on two requests (16 tokens, no stop hit)
    equal to `greedy_generate` from the same bucketed prefill on an fp
    cache (B1 and B6)."""
    import math

    import torch
    from llama3_quantization_tpu_torch.eval import ByteTokenizer, bucket_pow2, compute_ppl
    from llama3_quantization_tpu_torch.eval.harness import TorchLM
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq
    from llama3_quantization_tpu_torch.tools.reproduce_study import CORPUS

    cfg, counts, checks = P.LLAMA3_8B, {}, {}
    tok = ByteTokenizer()
    text = CORPUS.read_text()
    back = text[len(text) // 2:]
    testenc = tok.encode(back)[None, :]
    n_tok = 4 * 2048

    def reference_route(label, fn):
        """`fn()` with B7 off (the eager attention), counted as a check:
        no kernel of the forward may launch."""
        P.set_flash(False)
        try:
            return run_counted(checks, label, fn, never=("B1", "B2", "B7"))
        finally:
            P.set_flash("auto")

    P.set_flash("auto")
    ppl_fn = lambda: compute_ppl(params, cfg, testenc, seqlen=2048, limit=4)  # noqa: E731
    ppl_fn()  # warm-up (the kernels' first launches)
    ppl, secs = run_counted(counts, "compute_ppl [1, 2048] x 4 (pallas, flash auto)",
                            lambda: timed(ppl_fn), must=("B2", "B7"))
    with P.backend("xla"):
        ppl_ref = reference_route("compute_ppl [1, 2048] x 4 (xla, flash off: reference, check)",
                                  ppl_fn)
    d_ln = abs(math.log(ppl) - math.log(ppl_ref))
    log(f"full-width PPL (ByteTokenizer, 4 windows of 2048): kernels {ppl:.4f}, reference "
        f"{ppl_ref:.4f}, |d ln PPL| {d_ln:.3e} (limit {EVAL_LN_PPL_TOL:g}); "
        f"{n_tok / secs:.1f} tok/s host clock  [{card}]")
    if not d_ln <= EVAL_LN_PPL_TOL:
        raise AssertionError(f"PPL kernels {ppl} against reference {ppl_ref}: |d ln| {d_ln}")

    reqs = eval_requests(tok)

    def per_token(a, b):
        return max(abs(x[0] - y[0]) / len(tok.encode(cont))
                   for x, y, (_, cont) in zip(a, b, reqs))

    def plain_route(label, gemv, gemm):
        """`lm_.loglikelihood` with B1 and B2 stood in by `gemv` and `gemm`
        and B7 off, counted as a check."""
        with plain_versions(P, forms=(gemv, gemm)):
            return run_counted(checks, label, lambda: lm_.loglikelihood(reqs),
                               never=("B1", "B2", "B7"))

    def loglikelihoods(p, label, witness=False):
        """The requests on the kernel route (B2), through B1's and B2's
        plain versions, and on the xla route; the largest |d ll| per
        continuation token of the kernel route against each, and with
        `witness` of the plain versions against `reversed_plain`."""
        nonlocal lm_
        lm_ = TorchLM(p, cfg, tok, batch_size=4)
        ll, secs = run_counted(counts, f"TorchLM.loglikelihood x {len(reqs)} ({label}, pallas)",
                               lambda: timed(lambda: lm_.loglikelihood(reqs)), must=("B2",))
        ll_plain = plain_route(f"TorchLM.loglikelihood ({label}, B1/B2 plain, check)",
                               fq.qmm_gemv_plain, fq.qmm_gemm_plain)
        with P.backend("xla"):
            ll_xla = reference_route(f"TorchLM.loglikelihood ({label}, xla, check)",
                                     lambda: lm_.loglikelihood(reqs))
        d_plain, d_xla = per_token(ll, ll_plain), per_token(ll, ll_xla)
        flags = sum(a[1] == b[1] == c[1] for a, b, c in zip(ll, ll_plain, ll_xla))
        log(f"full-width loglikelihood, {label}, {len(reqs)} piqa/arc_easy requests: max |d ll| "
            f"per continuation token {d_plain:.3e} against B1's and B2's plain versions, "
            f"{d_xla:.3e} against the xla route; greedy flags equal on all three {flags}/"
            f"{len(reqs)}; {secs:.2f} s host clock  [{card}]")
        if witness:
            ll_rev = plain_route(f"TorchLM.loglikelihood ({label}, B1/B2 plain reversed, check)",
                                 *reversed_plain(fq))
            log(f"  witness: B1's and B2's plain versions against themselves with every sum "
                f"over K reversed: max |d ll| per continuation token "
                f"{per_token(ll_plain, ll_rev):.3e}  [{card}]")
        return d_plain, d_xla

    lm_ = None
    # bf16 activations (the model as the other phases run it)
    d_plain, _ = loglikelihoods(params, "bf16 activations", witness=True)
    if not d_plain <= EVAL_LL_BF16_TOL:
        raise AssertionError(f"loglikelihood (bf16 activations) kernels against their plain "
                             f"versions: {d_plain} per token (limit {EVAL_LL_BF16_TOL})")
    # fp32 activations (embedding, norms and head in fp32; the same packed
    # RTN linears, which still round x to bf16): the routes' own difference
    wide = fp32_activations(params)
    d_plain, _ = loglikelihoods(wide, "fp32 activations")
    del wide
    if not d_plain <= EVAL_LL_TOL:
        raise AssertionError(f"loglikelihood kernels against their plain versions: {d_plain} "
                             f"per token (limit {EVAL_LL_TOL})")

    lm = TorchLM(params, cfg, tok, batch_size=4)
    lm.max_gen_toks = 16
    seen = []
    lm.tok_decode = lambda ids: (seen.append(list(ids)), tok.decode(ids))[1]
    ctxs = [back[:300], back[5000:5700]]
    stop = ["<<no such text>>"]

    def generate():
        out = []
        for ctx in ctxs:
            lm.greedy_until([(ctx, stop)])
            out.append(seen[-1])  # the tokens of the request's last decode
        return out

    got = run_counted(counts, "TorchLM.greedy_until x 2, 16 tokens (fp cache)", generate,
                      must=("B1", "B6"))
    keep = max(lm.max_length - lm.max_gen_toks, lm.max_length // 2)
    for ctx, toks in zip(ctxs, got):
        ids = lm.tok_encode(ctx)[-keep:]
        n, nb = len(ids), bucket_pow2(len(ids))
        cache = P.init_kv_cache(cfg, 1, bucket_pow2(nb + 16))
        padded = torch.zeros((1, nb), dtype=torch.long, device="cuda")
        padded[0, :n] = torch.tensor(ids, device="cuda")
        with torch.inference_mode():
            lg, cache = P.decode_step(params, cache, padded, 0, cfg)
            first = lg[0, n - 1].argmax().reshape(1, 1)
            rest, _ = P.greedy_generate(params, cache, first, n, 15, cfg)
        ref = [int(first)] + rest[0].tolist()
        log(f"greedy_until ({n}-token context): {toks} (greedy_generate {ref})")
        if toks != ref:
            raise AssertionError(f"greedy_until {toks} != greedy_generate {ref}")
    return sum_counts(counts)


def fp32_activations(params):
    """`params` with the embedding, the norms and the head in fp32 (the same
    quantized linears, which still round x to bf16): the forward keeps its
    activations in fp32."""
    layers = params["layers"]
    return dict(params, embed=params["embed"].float(), lm_head=params["lm_head"].float(),
                norm={"w": params["norm"]["w"].float()},
                layers={**layers, "ln1": {"w": layers["ln1"]["w"].float()},
                        "ln2": {"w": layers["ln2"]["w"].float()}})


def reversed_plain(fq):
    """B1's and B2's plain versions (`qmm_gemv_plain`, `qmm_gemm_plain`)
    with every sum over K taken in the reverse order: the same function
    and rounding points, another order of the fp32 sums."""
    import torch

    def gemv(x2d, qt, out_dtype):
        gs = qt.group_size or qt.k
        g, m = qt.k // gs, x2d.shape[0]
        x3 = x2d.to(torch.bfloat16).float().reshape(m, g, gs).flip(-1)
        c3 = fq._codes(qt).float().reshape(g, gs, qt.n).flip(1)
        dot = torch.einsum("mgk,gkn->mgn", x3, c3)
        acc = dot * qt.scale[None] - x3.sum(dim=-1)[..., None] * (qt.zero * qt.scale)[None]
        return acc.flip(1).sum(dim=1).to(out_dtype)

    def gemm(x2d, qt, out_dtype):
        w = fq.dequant_bf16(qt).float().flip(0)
        return torch.matmul(x2d.to(torch.bfloat16).float().flip(-1), w).to(out_dtype)

    return gemv, gemm


#: K of the down projection, whose last group the control leaves out
DOWN_K = 14336


def dropped_group_plain(fq, k=DOWN_K):
    """B1's and B2's plain versions with a fault that a kernel's loop over
    K could have: the last group of input channels of every linear of K =
    `k` (default DOWN_K: the down projection, 1 of its 112 groups) left out
    of the sum."""

    def cut(x2d, qt):
        if qt.k != k:
            return x2d
        x2d = x2d.clone()
        x2d[:, -(qt.group_size or qt.k):] = 0
        return x2d

    return (lambda x2d, qt, out_dtype: fq.qmm_gemv_plain(cut(x2d, qt), qt, out_dtype),
            lambda x2d, qt, out_dtype: fq.qmm_gemm_plain(cut(x2d, qt), qt, out_dtype))


#: phase 11's bounds: the UPR score (-mean CE a query token) of the kernel
#: route against the plain versions with fp32 activations, the cosine of
#: each STS embedding to the plain versions' (fp32 activations), and
#: `HFCausalLM` over `forward_logits` against `TorchLM` a continuation token.
#: With fp32 activations the log-likelihoods are held to the eval check's
#: EVAL_LL_TOL, and wikitext's |d ln word_perplexity| to EVAL_LN_PPL_TOL
UPR_TOL = 1e-2
STS_MIN_COS = 0.999
#: phase 11's per-token |d ll| with the model's bf16 activations, kernels
#: against B1's and B2's plain versions with the eager attention: set
#: between what a sound route reads there (`reversed_plain` with B7: at
#: most 3.066e-2) and what a faulty one reads (`dropped_group_plain`: at
#: least 1.811e-1), on the phase's own requests at two seeds (`--harness
#: --harness-seed 0` and `1`, one run each on an H100 80GB HBM3 at 700 W;
#: the kernels read 2.739e-2 and 2.257e-2)
HARNESS_LL_BF16_TOL = 5e-2
HF_CAUSAL_TOL = 1e-4
#: the harness tasks of phase 11 (`reproduce_study.SYNTHETIC_TASKS`'s order)
#: and `greedy_until`'s budget there (BaseLM's 256 cut for time)
HARNESS_TASKS = ("hellaswag", "winogrande", "hendrycksTest-abstract_algebra", "lambada_openai",
                 "wikitext", "gsm8k")
HARNESS_GEN_TOKS = 32


def harness_deltas(tok, ref_calls, got_calls):
    """Between two runs of the same requests (each request type both runs
    asked for, one call a type as `simple_evaluate` makes them): the largest
    |d log-likelihood| a continuation token and that continuation's tokens,
    the greedy flags equal and their number, and the largest |d rolling
    log-likelihood| a token."""
    d_ll, at, same, n, d_roll = 0.0, 0, 0, 0, 0.0
    got_by_kind = {kind: (reqs, out) for kind, reqs, out in got_calls}
    for kind, reqs, a in ref_calls:
        if kind not in got_by_kind:
            continue
        reqs2, b = got_by_kind[kind]
        if reqs != reqs2:
            raise AssertionError(f"the two runs asked different {kind} requests")
        if kind == "loglikelihood":
            for (_, cont), x, y in zip(reqs, a, b):
                toks = max(1, len(tok.encode(cont)))
                if abs(x[0] - y[0]) / toks > d_ll:
                    d_ll, at = abs(x[0] - y[0]) / toks, toks
                same, n = same + (x[1] == y[1]), n + 1
        elif kind == "loglikelihood_rolling":
            for doc, x, y in zip(reqs, a, b):
                doc = doc if isinstance(doc, str) else doc[0]
                d_roll = max(d_roll, abs(x - y) / len(tok.encode(doc)))
    return d_ll, at, same, n, d_roll


def metric_line(results):
    """Each task's metrics (stderrs left out) on one line."""
    return "; ".join(f"{task} " + ", ".join(f"{k} {v:.4g}" for k, v in row.items()
                                            if not k.endswith("_stderr"))
                     for task, row in results.items())


def drive_harness(P, params, card, seed=0):
    """Phase 11, the rest of the harness at full width (Llama-3-8B, 32
    layers, the RTN W4 g128 params of the eval phase, `ByteTokenizer`):

    1. `simple_evaluate(TorchLM(batch_size=4), HARNESS_TASKS,
       task_data=synthetic_task_data(...))`: hellaswag (8 docs of 4
       endings), winogrande (8, partial evaluation), hendrycksTest-
       abstract_algebra (8), lambada_openai (8), wikitext (2 pages of ~5,000
       bytes: rolling windows of 2048, B2 and B7) and gsm8k (2 docs:
       `greedy_until` to "\\n" or HARNESS_GEN_TOKS tokens, a B2 or eager
       prefill, then B1 and B6), with the n-gram pickle the port's `Janitor`
       wrote from hellaswag's first 4 docs; on the kernel route and on B1's
       and B2's plain versions with the eager attention: ln word_perplexity
       within EVAL_LN_PPL_TOL, the per-token |d ll| within
       HARNESS_LL_BF16_TOL. The eval check's 2.5e-2 a token does not hold
       here: B7 and the eager attention round p to bf16 at other points,
       which adds to the sums' order on lambada's 3-token continuations. So
       the phase reads, on the loglikelihood tasks, a sound route (B1's and
       B2's plain versions with every sum over K reversed and B7) and a
       faulty one (`dropped_group_plain`, eager attention) against the same
       reference, and requires the kernels within the bound and the control
       past it. The attention routes are held with fp32 activations (2.).
       gsm8k's tokens on the kernel route equal `greedy_generate` from the
       same bucketed prefill (the first step where the plain route's differ
       reported); `acc_decontaminate` exactly the accuracy of hellaswag's
       other 4 docs; both routes' metrics and the MMLU rollup reported.
    2. The same but gsm8k with fp32 activations (`fp32_activations`),
       against the plain versions with the eager attention: EVAL_LL_TOL a
       token, ln word_perplexity within EVAL_LN_PPL_TOL.
    3. `UPRReranker` (fp32 activations) on 2 queries x 8 fixture passages
       (bucketed lengths 256 and up: B2 and B7) against the plain versions
       within UPR_TOL, the rankings reported beside BM25's.
    4. `STSEncoder` (fp32 activations) on 16 synthetic sentence pairs
       (bucketed to 128: B2 and B7): each embedding's cosine to the
       plain versions' >= STS_MIN_COS; Spearman reported.
    5. `HFCausalLM` over an `nn.Module` whose `.logits` are the port's
       `forward_logits` (bf16 model, right-padded as `TorchLM` pads) on the
       27 study requests against `TorchLM`: within HF_CAUSAL_TOL a token,
       greedy flags equal.
    6. `cli.main --tasks hellaswag,winogrande,hendrycksTest-* --limit 2` at
       8B width, 2 layers, with `datasets` unimportable: the names pass the
       checks and every task is skipped with JAX's offline message."""
    import contextlib
    import io
    import math
    import random
    import shutil
    import tempfile
    import types

    from llama3_quantization_tpu_torch import cli
    from llama3_quantization_tpu_torch.decontamination import janitor
    from llama3_quantization_tpu_torch.decontamination.decontaminate import get_train_overlap
    from llama3_quantization_tpu_torch.eval import ByteTokenizer, bucket_pow2
    from llama3_quantization_tpu_torch.eval.harness import (
        HFCausalLM, TorchLM, get_task_dict, simple_evaluate)
    from llama3_quantization_tpu_torch.eval.mmlu_categories import mmlu_rollup
    from llama3_quantization_tpu_torch.eval.retrieval import BM25Index, UPRReranker
    from llama3_quantization_tpu_torch.eval.sts import (
        STSEncoder, cosine_sim, evaluate_sts, spearman)
    from llama3_quantization_tpu_torch.models import configs as TCFG
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq
    from llama3_quantization_tpu_torch.tools.benchmark_sts import synthetic_sts
    from llama3_quantization_tpu_torch.tools.reproduce_study import (
        CORPUS, Recorder, synthetic_task_data)

    import numpy as np
    import torch

    cfg, counts, checks = P.LLAMA3_8B, {}, {}
    tok = ByteTokenizer()
    t_phase = time.time()
    data = synthetic_task_data(seed=SEED + 20 + seed)
    tmp = tempfile.mkdtemp(prefix="l3q_harness_")
    try:
        # the n-grams of hellaswag's first half, as a training corpus's
        hs = get_task_dict(["hellaswag"], data)["hellaswag"]
        hs_docs = list(hs.validation_docs())
        queries = [hs.doc_to_decontamination_query(d) for d in hs_docs]
        half = len(queries) // 2
        jan = janitor.Janitor()
        for q in queries[:half]:
            jan.register_contaminant(q)
        grams = os.path.join(tmp, "hellaswag_13grams.pkl")
        jan.save_contamination_ngrams(grams)
        overlap = get_train_overlap({"hellaswag": queries}, grams)["hellaswag"]
        path = ("native (csrc/janitor_util.cpp, built with g++)" if janitor.native_used()
                else "pure Python (no g++)")
        log(f"  decontamination: the janitor's {path} path; {len(jan.dirt_ngrams)} 13-grams "
            f"from hellaswag docs 0-{half - 1}; docs overlapping them {sorted(overlap)}")
        if overlap != set(range(half)):
            raise AssertionError(f"hellaswag docs overlapping the n-grams: {sorted(overlap)}")

        def evaluate(p, tasks, label, plain=None, flash=False, must=(), **kw):
            """`simple_evaluate` through a `Recorder` of `TorchLM(p)`, on the
            kernel route or with B1 and B2 stood in by `plain` (a (gemv,
            gemm) pair) and the eager attention (B7 if `flash`): (results,
            calls, each greedy_until request's (context ids, generated ids),
            host seconds)."""
            lm = TorchLM(p, cfg, tok, batch_size=4)
            lm.max_gen_toks = HARNESS_GEN_TOKS
            seen, gens = [], []
            decode, generate = lm.tok_decode, lm._model_generate

            def tok_decode(ids):
                seen.append(list(ids))
                return decode(ids)

            def model_generate(context, max_gen, stops):
                text = generate(context, max_gen, stops)
                gens.append((list(context), seen[-1]))
                return text

            lm.tok_decode, lm._model_generate = tok_decode, model_generate
            rec = Recorder(lm)
            run = lambda: timed(lambda: simple_evaluate(  # noqa: E731
                rec, list(tasks), task_data={t: data[t] for t in tasks}, bootstrap_iters=100,
                **kw))
            if plain:
                with plain_versions(P, flash, forms=plain):
                    res, secs = run_counted(checks, label, run,
                                            never=("B1", "B2") + (() if flash else ("B7",)))
            else:
                res, secs = run_counted(counts, label, run, must=must)
            return res["results"], rec.calls, gens, secs

        def routes(p, tasks, label, bound, must, **kw):
            """Kernel and plain runs of `tasks` (B1's and B2's plain versions
            with the eager attention): wikitext's ln word_perplexity checked,
            and the per-token |d ll| against `bound` if given, else reported;
            (kernel run, plain run, that |d ll|)."""
            got = evaluate(p, tasks, f"simple_evaluate {len(tasks)} tasks ({label}, kernels)",
                           must=must, **kw)
            ref = evaluate(p, tasks, f"simple_evaluate {len(tasks)} tasks ({label}, B1/B2 "
                           "plain, eager attention, check)", plain=PLAIN, **kw)
            d_ll, at, same, n, d_roll = harness_deltas(tok, ref[1], got[1])
            wp = got[0]["wikitext"]["word_perplexity"], ref[0]["wikitext"]["word_perplexity"]
            d_wp = abs(math.log(wp[0]) - math.log(wp[1]))
            limit = f"limit {bound:g}" if bound else "held below"
            log(f"  harness, {label}: {n} log-likelihoods against B1's and B2's plain versions "
                f"with the eager attention, max |d ll| per continuation token {d_ll:.3e} "
                f"({limit}; a {at}-token continuation), greedy flags equal {same}/{n}; "
                f"wikitext rolling max |d ll| a token {d_roll:.3e}, word_perplexity "
                f"{wp[0]:.6g} against {wp[1]:.6g}, |d ln| {d_wp:.3e} (limit "
                f"{EVAL_LN_PPL_TOL:g}); {got[3]:.1f} s kernels, {ref[3]:.1f} s plain, host "
                f"clock  [{card}]")
            log(f"    kernels: {metric_line(got[0])}")
            log(f"    plain:   {metric_line(ref[0])}")
            if not ((not bound or d_ll <= bound) and d_wp <= EVAL_LN_PPL_TOL):
                raise AssertionError(f"harness ({label}): |d ll| {d_ll} a token (limit {bound}), "
                                     f"|d ln word_perplexity| {d_wp}")
            return got, ref, d_ll

        # 1. every task, the model's bf16 activations, decontaminated; the
        # per-token |d ll| against the plain versions with the eager
        # attention is held below HARNESS_LL_BF16_TOL, which this run also
        # places between a sound route's reading and a faulty route's
        PLAIN = (fq.qmm_gemv_plain, fq.qmm_gemm_plain)
        (res, calls, gens, _), (_, calls_p, gens_p, _), d_ll = routes(
            params, HARNESS_TASKS, "bf16 activations", None,
            ("B1", "B2", "B6", "B7"), decontamination_ngrams_path=grams)
        ll_tasks = HARNESS_TASKS[:4]  # the tasks that ask for loglikelihoods
        readings = {}
        for key, forms, flash, what in (
                ("witness", reversed_plain(fq), True, "every sum over K reversed, B7"),
                ("control", dropped_group_plain(fq), False,
                 f"the last group of {GS} input channels of K = {DOWN_K} left out, eager "
                 "attention")):
            _, calls_x, _, secs = evaluate(params, ll_tasks, f"simple_evaluate {len(ll_tasks)} "
                                           f"tasks (bf16, B1/B2 plain, {key}, check)",
                                           plain=forms, flash=flash)
            readings[key], at, same, n, _ = harness_deltas(tok, calls_p, calls_x)
            log(f"  harness, bf16 activations, {key}: B1's and B2's plain versions with {what}, "
                f"against them with the eager attention: max |d ll| per continuation token "
                f"{readings[key]:.3e} (a {at}-token continuation), greedy flags equal "
                f"{same}/{n}; {secs:.1f} s  [{card}]")
        log(f"  harness, bf16 activations: kernels {d_ll:.3e}, witness {readings['witness']:.3e},"
            f" control {readings['control']:.3e} a token; limit {HARNESS_LL_BF16_TOL:g} (the "
            f"kernels within it, the control past it)  [{card}]")
        if not d_ll <= HARNESS_LL_BF16_TOL < readings["control"]:
            raise AssertionError(f"harness (bf16 activations): kernels against B1/B2 plain "
                                 f"|d ll| {d_ll} a token, control {readings['control']} (limit "
                                 f"{HARNESS_LL_BF16_TOL} between them)")
        log(f"    MMLU rollup (kernels): {json.dumps(mmlu_rollup(res))}")
        lls = {tuple(r): v[0] for kind, reqs, vals in calls if kind == "loglikelihood"
               for r, v in zip(reqs, vals)}
        accs = []
        for doc in hs_docs:
            reqs = hs.construct_requests(doc, hs.fewshot_context(doc, 0, random.Random(42)))
            accs.append(hs.process_results(doc, [lls[tuple(r.args)] for r in reqs])["acc"])
        row, clean = res["hellaswag"], accs[half:]
        log(f"  hellaswag acc {row['acc']} over all {len(accs)} docs, acc_decontaminate "
            f"{row['acc_decontaminate']} (docs {half}-{len(accs) - 1}: {clean})")
        if not (row["acc"] == sum(accs) / len(accs)
                and row["acc_decontaminate"] == sum(clean) / len(clean)):
            raise AssertionError(f"hellaswag acc {row['acc']}, acc_decontaminate "
                                 f"{row['acc_decontaminate']}; per doc {accs}")
        for (ctx, toks), (_, toks_p) in zip(gens, gens_p):
            n, nb = len(ctx), bucket_pow2(len(ctx))
            cache = P.init_kv_cache(cfg, 1, bucket_pow2(nb + HARNESS_GEN_TOKS))
            padded = torch.zeros((1, nb), dtype=torch.long, device="cuda")
            padded[0, :n] = torch.tensor(ctx, device="cuda")
            with torch.inference_mode():
                lg, cache = P.decode_step(params, cache, padded, 0, cfg)
                first = lg[0, n - 1].argmax().reshape(1, 1)
                ref = [int(first)]
                if len(toks) > 1:
                    rest, _ = P.greedy_generate(params, cache, first, n, len(toks) - 1, cfg)
                    ref += rest[0].tolist()
            differ = next((i for i, (a, b) in enumerate(zip(toks, toks_p)) if a != b), None)
            log(f"  gsm8k greedy_until ({n}-token context): {len(toks)} tokens, equal to "
                f"greedy_generate {toks == ref}; the plain route's "
                + (f"first differ at step {differ}" if differ is not None else
                   f"equal through {min(len(toks), len(toks_p))} steps")
                + f" ({len(toks_p)} tokens)")
            if toks != ref:
                raise AssertionError(f"gsm8k greedy_until {toks} != greedy_generate {ref}")

        # 2. fp32 activations, the log-likelihood tasks
        wide = fp32_activations(params)
        routes(wide, HARNESS_TASKS[:-1], "fp32 activations", EVAL_LL_TOL, ("B2", "B7"))

        # 3. UPR on 2 queries x 8 passages
        docs = [d.strip() for d in CORPUS.read_text().split("\n \n") if 300 < len(d) < 900]
        rng = np.random.default_rng(SEED + 21 + seed)
        passages = {f"p{i}": docs[int(j)]
                    for i, j in enumerate(rng.choice(len(docs), 8, replace=False))}
        upr_q = {f"q{k}": " ".join(passages[f"p{3 * k}"].split()[4:12]) for k in range(2)}
        bm25 = BM25Index(passages)
        first = {q: {p: bm25.search(t, top_k=8).get(p, 0.0) for p in passages}
                 for q, t in upr_q.items()}
        upr = UPRReranker(wide, cfg, tok)
        upr_run = lambda: upr.rerank(passages, upr_q, first, top_k=8, batch_size=8)  # noqa: E731
        got = run_counted(counts, "UPRReranker.rerank 2 x 8 (fp32 activations, kernels)",
                          upr_run, must=("B2", "B7"))
        with plain_versions(P):
            ref = run_counted(checks, "UPRReranker.rerank (plain versions, check)", upr_run,
                              never=("B1", "B2", "B7"))
        d_upr = max(abs(got[q][p] - ref[q][p]) for q in got for p in got[q])
        lens = sorted({bucket_pow2(len(tok.encode(f"Passage: {t} x"))) for t in passages.values()})
        log(f"  UPR (2 queries x 8 passages, buckets {lens}): max |d score| (-mean CE a query "
            f"token) {d_upr:.3e} (limit {UPR_TOL:g})  [{card}]")
        for q in upr_q:
            rank = lambda sc: [p for p, _ in sorted(sc.items(), key=lambda kv: -kv[1])]  # noqa: E731
            log(f"    {q}: kernels {rank(got[q])}, plain {rank(ref[q])}, BM25 {rank(first[q])}")
        if not d_upr <= UPR_TOL:
            raise AssertionError(f"UPR kernels against plain: {d_upr}")

        # 4. STS on 16 pairs
        sts_pairs, gold = synthetic_sts(16, seed=SEED + seed)
        sents = [a for a, _ in sts_pairs] + [b for _, b in sts_pairs]
        enc = STSEncoder(wide, cfg, tok)
        sts_run = lambda: (enc.encode(sents, 8), evaluate_sts(enc, sts_pairs, gold, 8))  # noqa
        (emb, sts), _ = run_counted(counts, "STSEncoder 16 pairs (fp32 activations, kernels)",
                                    lambda: timed(sts_run), must=("B2", "B7"))
        with plain_versions(P):
            emb_p, sts_p = run_counted(checks, "STSEncoder (plain versions, check)", sts_run,
                                       never=("B1", "B2", "B7"))
        cos = cosine_sim(emb, emb_p)
        rho = spearman(cosine_sim(emb[:16], emb[16:]).tolist(), gold)
        log(f"  STS (16 pairs): each embedding's cosine to the plain versions' >= {cos.min():.6f} "
            f"(limit {STS_MIN_COS}); Spearman of cosine vs gold {sts['spearman_cosine']:.4f} "
            f"(evaluate_sts), {rho:.4f} from the one batch; plain {sts_p['spearman_cosine']:.4f}"
            f"  [{card}]")
        if not cos.min() >= STS_MIN_COS:
            raise AssertionError(f"STS embeddings: cosine {cos.min()}")
        del wide, upr, enc
        torch.cuda.empty_cache()

        # 5. hf-causal over forward_logits
        class Causal(torch.nn.Module):
            """`forward_logits` as a causal LM: `.logits` of the batch
            right-padded to `TorchLM`'s bucket, cut back. It has no
            parameters of its own, so `HFCausalLM` runs it on its default
            device, the card."""

            def forward(self, ids):
                b, s = ids.shape
                padded = torch.zeros((b, min(bucket_pow2(s), 2049)), dtype=ids.dtype,
                                     device=ids.device)
                padded[:, :s] = ids
                with torch.inference_mode():
                    logits = P.forward_logits(params, padded, cfg)[:, :s]
                return types.SimpleNamespace(logits=logits)

        reqs = eval_requests(tok)
        hf = HFCausalLM(model=Causal(), tokenizer=tok, batch_size=4)
        ll_hf = run_counted(counts, f"HFCausalLM.loglikelihood x {len(reqs)} (forward_logits)",
                            lambda: hf.loglikelihood(reqs), must=("B2",))
        ll_t = run_counted(counts, f"TorchLM.loglikelihood x {len(reqs)} (beside hf-causal)",
                           lambda: TorchLM(params, cfg, tok, batch_size=4).loglikelihood(reqs),
                           must=("B2",))
        d_hf = max(abs(a[0] - b[0]) / len(tok.encode(c)) for a, b, (_, c) in
                   zip(ll_hf, ll_t, reqs))
        flags = sum(a[1] == b[1] for a, b in zip(ll_hf, ll_t))
        log(f"  hf-causal: HFCausalLM (device {hf.device}) against TorchLM on {len(reqs)} "
            f"requests: max |d ll| a continuation token {d_hf:.3e} (limit {HF_CAUSAL_TOL:g}), "
            f"greedy flags equal {flags}/{len(reqs)}  [{card}]")
        if not (d_hf <= HF_CAUSAL_TOL and flags == len(reqs) and hf.device.type == "cuda"):
            raise AssertionError(f"hf-causal against TorchLM: {d_hf} a token, flags {flags}, "
                                 f"device {hf.device}")

        # 6. the CLI's task names, offline
        name = "llama3-8b-2layers"
        TCFG.NAMED_CONFIGS[name] = quantize_cfg(P)
        had = sys.modules.get("datasets", False)
        sys.modules["datasets"] = None  # no download is tried; tasks skip as offline
        out, err = io.StringIO(), io.StringIO()
        pats = ["hellaswag", "winogrande", "hendrycksTest-*"]
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                cli_res = run_counted(checks, "cli.main --tasks (2 layers, offline, check)",
                                      lambda: cli.main(["--net", name, "--quant_method", "none",
                                                        "--tasks", ",".join(pats),
                                                        "--limit", "2"]))
        finally:
            del TCFG.NAMED_CONFIGS[name]
            if had is False:
                del sys.modules["datasets"]
            else:
                sys.modules["datasets"] = had
        skipped = re.findall(r"\[cli\] skipping task (\S+): (.*)", err.getvalue())
        names = cli.check_tasks(pats)
        log(f"  cli.main --tasks {','.join(pats)} --limit 2 (8B width, 2 layers): {len(names)} "
            f"names pass the checks, {len(skipped)} skipped offline, e.g. "
            f"'{skipped[0][0]}: {skipped[0][1][:90]}...'; results {cli_res}")
        if sorted(n for n, _ in skipped) != sorted(names) or cli_res != {}:
            raise AssertionError(f"cli --tasks offline: skipped {len(skipped)} of {len(names)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 11 (the rest of the harness) in {time.time() - t_phase:.1f} s  [{card}]")
    return sum_counts(counts)


# ---------------------------------------------------------------- phase 12 ----
#: (K, N, group size) of OPT-125M's and Falcon-7B's decoder linears; Falcon-7B
#: at g64: JAX refuses g128 at its K = 4544 = 71 x 64 (ROADMAP A 4.2)
ARCH_LINEARS = {
    "opt-125m q/k/v/o": (768, 768, 128), "opt-125m fc1": (768, 3072, 128),
    "opt-125m fc2": (3072, 768, 128), "falcon-7b q/o": (4544, 4544, 64),
    "falcon-7b k/v": (4544, 64, 64), "falcon-7b fc1": (4544, 18176, 64),
    "falcon-7b fc2": (18176, 4544, 64),
}
#: (kernel, M) of those checks: batch-1 decode, the 8-slot engine, a prefill
ARCH_QMM_CASES = (("B1", 1), ("B1", 8), ("B2", 128))


def check_arch_kernels(P, gen, results):
    """Phase 12's shapes against the plain versions: B1 at M = 1 and 8 and
    B2 at M = 128 on ARCH_LINEARS (fp32 out within 1e-4 * max|ref|, bf16
    within 1e-2, as `check_qmatmul`); B5 (int8 and int4, with and without
    statistics) and B6 at OPT-125M's rep 1, D = 64, T = 512 (their own
    bounds). B7 at Falcon-7B's and OPT-125M's heads is in FLASH_CASES."""
    import torch
    from llama3_quantization_tpu_torch.models.synthetic import _rand_qtensor
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    for label, (k, n, gs) in ARCH_LINEARS.items():
        qt = _rand_qtensor(gen, k, n, P.QuantSpec(n_bits=4, group_size=gs), 1, "cuda").layer(0)
        for kid, m in ARCH_QMM_CASES:
            kern, plain = ((fq.qmm_gemv, fq.qmm_gemv_plain) if kid == "B1"
                           else (fq.qmm_gemm, fq.qmm_gemm_plain))
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            compare(f"{kid} {label} g{gs} M={m} fp32-out", kern(x, qt, torch.float32),
                    plain(x, qt, torch.float32), 1e-4)
            err = compare(f"{kid} {label} g{gs} M={m} bf16-out", kern(x, qt, torch.bfloat16),
                          plain(x, qt, torch.bfloat16), 1e-2)
            results.setdefault(kid, {})[f"{label} M={m}"] = err
    check_decode_forms(P, gen, results, g=12, rep=1, d=64, ts=(512,), tag="rep=1 D=64 ")
    check_fp_decode(P, gen, results, g=12, rep=1, d=64,
                    cases=((1, 512, "bf16", True), (8, 512, "bf16", False)), tag="rep=1 D=64 ")


#: phase 12's bound on a full-width forward's logits, kernels against B1's
#: and B2's plain versions with the eager attention: every position's row
#: within ARCH_ROW_TOL * that row's max|logit|. Set between what sound
#: routes read (Mixtral-8x7B on the plain route's expert picks: the kernels
#: 2.202e-2, reversed sums + B7 2.131e-2; OPT-125M 1.399e-2, Falcon-7B
#: 2.210e-2) and what a faulty one reads (every down projection's last
#: group of 128 left out: 1.336e-1), NVIDIA H100 80GB HBM3
ARCH_ROW_TOL = 5e-2


def logit_rows(got, ref) -> float:
    """max over positions of max|got - ref| / max|ref| (a row is one
    position's logits); fails on a non-finite logit."""
    g = got.float().reshape(-1, got.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    if not (bool(g.isfinite().all()) and bool(r.isfinite().all())):
        raise AssertionError("non-finite logits")
    return float(((g - r).abs().amax(dim=-1) / r.abs().amax(dim=-1).clamp(min=1e-30)).max())


def arch_forwards(P, params, cfg, name, counts, checks, seqs, gen):
    """`forward_logits` at [1, S] for S in `seqs` on the kernels (B2 and B7
    must run, no route off them) against B1's and B2's plain versions with
    the eager attention: each row within ARCH_ROW_TOL. Returns the prompt
    of the first S and the readings."""
    import torch

    readings = {}
    prompt = None
    for s in seqs:
        toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device="cuda")
        prompt = toks if prompt is None else prompt
        got = run_counted(counts, f"{name} forward_logits [1,{s}]",
                          lambda: P.forward_logits(params, toks, cfg), must=("B2", "B7"))
        with plain_versions(P):
            ref = run_counted(checks, f"{name} forward [1,{s}], plain + eager (check)",
                              lambda: P.forward_logits(params, toks, cfg),
                              never=("B1", "B2", "B7"))
        readings[s] = logit_rows(got, ref)
        log(f"  {name} forward [1, {s}], kernels vs plain + eager: max over rows of "
            f"max|d logit| / max|logit| {readings[s]:.3e} (bound {ARCH_ROW_TOL:g})")
        if not readings[s] <= ARCH_ROW_TOL:
            raise AssertionError(f"{name} forward [1, {s}]: {readings[s]} above {ARCH_ROW_TOL}")
        del got, ref
    return prompt, readings


def arch_decodes(P, params, cfg, name, counts, prompt, caches, moe_limit=0.15):
    """A prefill of `prompt` and 32 greedy steps on each cache of `caches`
    ((bits, must, allow, never) for bits 8 or False), then the
    teacher-forced decode against the forward over 8 steps (< 0.15). On an
    MoE the free comparison is reported (a pick flipped by the cache's
    rounding moves a token's expert mix; under `moe_limit` otherwise) and
    the decode on the forward's expert picks is held to 0.15."""
    import torch

    n = 32
    s = prompt.shape[1]
    for bits, must, allow, never in caches:
        kind = "int8" if bits else "fp"
        cache = P.init_kv_cache(cfg, 1, 512, quantized=bits)
        lg, cache = P.decode_step(params, cache, prompt, 0, cfg)
        tok = lg[:, -1].argmax(dim=-1)[:, None]
        (toks, _), t = run_counted(
            counts, f"{name} {kind} greedy_generate {n} steps",
            lambda: timed(lambda: P.greedy_generate(params, cache, tok, s, n, cfg)),
            must=must, allow=allow, never=never)
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise AssertionError(f"{name} {kind} greedy_generate: tokens out of range")
        cont = torch.cat([tok, toks[:, :8]], 1)
        rel = decode_vs_forward(P, params, cfg, prompt, cont, bits)
        log(f"  {name} {kind} decode: {n / t:.2f} tok/s (batch 1, KV of 512, first call, host "
            f"clock); decode-vs-forward max rel logit error {rel:.3e} over 8 steps (limit "
            f"{'0.15' if moe_limit else 'none: reported'})")
        if moe_limit is not None and not rel < moe_limit:
            raise AssertionError(f"{name} {kind} decode/forward divergence: rel err {rel:.4f}")
        if cfg.is_moe:
            with routing_log() as fwd:
                full = P.forward_logits(params, torch.cat([prompt, cont], 1), cfg)[0].float()
            spans = [(0, s)] + [(s + i, 1) for i in range(cont.shape[1] - 1)]
            with routing_log(replay=fwd, spans=spans, layers=cfg.num_layers):
                dec = teacher_forced(P, params, cfg, prompt, cont[:, :-1], bits)
            rel = float((dec - full[s : s + dec.shape[0]]).abs().max() / full.abs().max())
            log(f"  {name} {kind} decode-vs-forward on the forward's expert picks: max rel "
                f"logit error {rel:.3e} (limit 0.15)")
            if not rel < 0.15:
                raise AssertionError(f"{name} {kind} decode/forward divergence on the forward's "
                                     f"picks: rel err {rel:.4f}")
        del cache


def build_layerwise(P, cfg, spec, seed0):
    """`cfg` at full depth, one layer at a time: a one-layer `init_params`
    (bf16, seed `seed0 + i`) RTN-quantized, copied into stacks allocated
    after the first layer; the embedding, final norm and head are layer 0's
    draw. Never holds more than one layer in bf16."""
    import dataclasses

    import torch

    one = dataclasses.replace(cfg, num_layers=1)
    L = cfg.num_layers

    def alloc(x):
        if isinstance(x, dict):
            return {k: alloc(v) for k, v in x.items()}
        if isinstance(x, P.QuantizedTensor):
            return dataclasses.replace(x, data=alloc(x.data), scale=alloc(x.scale),
                                       zero=None if x.zero is None else alloc(x.zero))
        return torch.empty((L, *x.shape[1:]), dtype=x.dtype, device=x.device)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        elif isinstance(dst, P.QuantizedTensor):
            for f in ("data", "scale", "zero"):
                if getattr(dst, f) is not None:
                    getattr(dst, f)[i].copy_(getattr(src, f)[0])
        else:
            dst[i].copy_(src[0])

    params = None
    for i in range(L):
        gen = torch.Generator(device="cuda").manual_seed(seed0 + i)
        layer = P.quantize_model_rtn(P.init_params(one, gen, dtype=torch.bfloat16), one, spec,
                                     pack=True)
        if params is None:
            params = dict(layer, layers=alloc(layer["layers"]))
        put(params["layers"], layer["layers"], i)
        del layer
    torch.cuda.synchronize()
    return params


class routing_log:
    """Records the router's top-k picks of each MoE layer (`_moe_topk`:
    weights and expert ids, dense and capacity paths alike) while active;
    with `replay` (a record of an earlier run), returns those picks layer by
    layer instead of computing them, so that the run takes the recorded
    run's experts with its weights. With `spans` ((start, length) of each
    call of `layers` MoE layers, for a decode fed token by token) the record
    is one forward over the whole sequence, and each call takes its
    positions' picks from it."""

    def __init__(self, replay=None, spans=None, layers=None):
        from llama3_quantization_tpu_torch.models import transformer as TT

        self.tt, self.topk = TT, []
        self.replay = None if replay is None else list(replay.topk)
        self.spans, self.layers = spans, layers

    @property
    def picks(self):
        """Each call's picked expert ids, sorted, `[tokens, k]`."""
        return [i.reshape(-1, i.shape[-1]).sort(dim=-1).values for _, i in self.topk]

    def _replayed(self, x):
        if self.spans is None:
            v, i = self.replay.pop(0)
        else:
            call, layer = divmod(len(self.topk), self.layers)
            start, n = self.spans[call]
            v, i = (t[:, start : start + n] for t in self.replay[layer])
        lead = x.shape[:-1]
        return v.reshape(*lead, -1), i.reshape(*lead, -1)

    def __enter__(self):
        self.orig = self.tt._moe_topk

        def rec(p, x, cfg):
            out = self.orig(p, x, cfg) if self.replay is None else self._replayed(x)
            self.topk.append(out)
            return out

        self.tt._moe_topk = rec
        return self

    def __exit__(self, *exc):
        self.tt._moe_topk = self.orig


def capacity_drops(log, cfg, factor):
    """(picks, dropped) over the capacity-dispatch MoE calls a
    `routing_log` recorded: an expert takes at most C = ceil(factor * k *
    T / E) of a call's T tokens (at most T), rounded up to a multiple of 8,
    so an expert picked n times drops max(0, n - C), whatever the queue's
    order."""
    import torch

    e, k = cfg.num_experts, cfg.num_experts_per_tok
    picks = dropped = 0
    for ids in log.picks:
        t = ids.shape[0]
        c = -(-min(t, -(-int(factor * k * t) // e)) // 8) * 8
        n = torch.bincount(ids.reshape(-1), minlength=e)
        picks += int(n.sum())
        dropped += int((n - c).clamp(min=0).sum())
    return picks, dropped


def flipped(a, b) -> int:
    """(layer, token) pairs whose picked experts differ between two logs."""
    return sum(int((x != y).any(dim=-1).sum()) for x, y in zip(a.picks, b.picks))


def arch_summary(name, counts, t0, card):
    """Phase 12's line for one model: its launches of B1, B2, B5, B6 and
    B7, the routes its calls took, its seconds."""
    from llama3_quantization_tpu_torch.ops import launches

    total = {k: sum(c[k] for c in counts.values()) for k in launches.COUNTS}
    b5 = sum(total[k] for k in B5_KEYS)
    routes = {k: total[k] for k in launches.ROUTES if total[k]}
    log(f"  {name}: launches B1 {total['B1']}, B2 {total['B2']}, B5 {b5} (forms "
        f"{ {k: total[k] for k in B5_KEYS if total[k]} }), B6 {total['B6']}, B7 {total['B7']}; "
        f"routes off the kernels {json.dumps(routes)}; {time.time() - t0:.1f} s  [{card}]")


def routed_b2_forward(P, params, cfg, counts, checks, gen):
    """Mixtral's `forward_logits` at [1, 2048] on the plain versions' expert
    picks: routed (each expert on its ~512 picks, B2, no B1) against the
    plain versions with the eager attention, each row within ARCH_ROW_TOL,
    and against the dense dispatch (every expert on all 2048 rows), bit for
    bit: B2's rows do not depend on M, and both dispatches combine alike."""
    import torch
    from llama3_quantization_tpu_torch.models import transformer as TT

    toks = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")

    def forward():
        return P.forward_logits(params, toks, cfg)

    with plain_versions(P), routing_log() as route_p:
        ref = run_counted(checks, "Mixtral-8x7B forward [1,2048], plain + eager (check)", forward,
                          never=("B1", "B2", "B7"))
    with routing_log(replay=route_p):
        routed = run_counted(counts, "Mixtral-8x7B forward_logits [1,2048] routed", forward,
                             must=("B2", "B7"), never=("B1",))
    above, TT.MOE_ROUTED_ABOVE = TT.MOE_ROUTED_ABOVE, 1 << 30
    try:
        with routing_log(replay=route_p):
            dense = run_counted(checks, "Mixtral-8x7B forward [1,2048] dense (check)", forward,
                                must=("B2", "B7"), never=("B1",))
    finally:
        TT.MOE_ROUTED_ABOVE = above
    r_p, r_d = logit_rows(routed, ref), logit_rows(routed, dense)
    log(f"  Mixtral-8x7B forward [1, 2048] routed, on the plain route's picks: max over rows of "
        f"max|d logit| / max|logit| vs plain + eager {r_p:.3e} (bound {ARCH_ROW_TOL:g}), vs "
        f"dense {r_d:.3e} (bound 0)")
    if not (r_p <= ARCH_ROW_TOL and r_d == 0.0):
        raise AssertionError(f"Mixtral-8x7B [1, 2048] routed: {r_p} vs plain, {r_d} vs dense")


def moe_dispatch_times(P, params, cfg, card, reps=20):
    """The MoE's two no-drop dispatches on the full-depth model, by the rows
    of a call, `MOE_ROUTED_ABOVE` forced either way: ms a cached decode step
    at B = 1, 8 and 64 rows (int8 cache, 256 positions prefilled) and a
    `forward_logits` at [1, S], S = 128, 192, 256, 512, 1024 and 2048; `reps`
    calls back to back after 3 warm-ups, the card synced once after them
    (host clock), dense and routed alternated, twice."""
    import torch
    from llama3_quantization_tpu_torch.models import transformer as TT

    def per_call(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / reps

    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    cases = []
    for b in (1, 8, 64):
        cache = P.init_kv_cache(cfg, b, 512, quantized=8)
        prompt = torch.randint(0, cfg.vocab_size, (b, 256), generator=gen, device="cuda")
        P.decode_step(params, cache, prompt, 0, cfg)
        tok = prompt[:, -1:]
        cases.append((f"decode step B = {b}", lambda c=cache, t=tok: P.decode_step(
            params, c, t, 256, cfg)))
    for s in (128, 192, 256, 512, 1024, 2048):
        toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device="cuda")
        cases.append((f"forward [1, {s}]", lambda t=toks: P.forward_logits(params, t, cfg)))
    above = TT.MOE_ROUTED_ABOVE
    try:
        for what, fn in cases:
            times = {"dense": [], "routed": []}
            for _ in range(2):
                for form, forced in (("dense", 1 << 30), ("routed", 0)):
                    TT.MOE_ROUTED_ABOVE = forced
                    times[form].append(per_call(fn))
            dense, routed = (", ".join(f"{t:.3f}" for t in times[f]) for f in times)
            log(f"  MoE dispatch, Mixtral-8x7B {what}: dense {dense} ms, routed {routed} ms a "
                f"call (dense / routed {sum(times['dense']) / sum(times['routed']):.3f})  "
                f"[{card}]")
    finally:
        TT.MOE_ROUTED_ABOVE = above


def drive_mixtral(P, card, gen, timing=False):
    """Phase 12's Mixtral-8x7B (`drive_archs`, 3); with `timing` also the
    MoE's two dispatches timed by rows (`moe_dispatch_times`). Returns its
    launch counts by label."""
    import gc

    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    t0, counts, checks = time.time(), {}, {}
    cfg = P.MIXTRAL_8X7B
    params = build_layerwise(P, cfg, P.QuantSpec(n_bits=4, group_size=GS), 100)
    log(f"phase 12: Mixtral-8x7B W4 g{GS} packed, {cfg.num_layers} layers x "
        f"{cfg.num_experts} experts, built layer by layer in {time.time() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")

    def forward():
        return P.forward_logits(params, toks, cfg)

    with routing_log() as route_k:
        dense = run_counted(counts, "Mixtral-8x7B forward_logits [1,128] dense", forward,
                            must=("B2", "B7"), never=("B1",))
    with plain_versions(P), routing_log() as route_p:
        ref = run_counted(checks, "Mixtral-8x7B forward, plain + eager (check)", forward,
                          never=("B1", "B2", "B7"))
    flips = flipped(route_k, route_p)
    r_free = logit_rows(dense, ref)
    # the same forwards on the plain route's expert picks: what is left is
    # the kernels' arithmetic, not which experts a near tie picked
    with routing_log(replay=route_p):
        replayed = run_counted(checks, "Mixtral-8x7B forward, kernels on plain's picks (check)",
                               forward, must=("B2", "B7"))
    with plain_versions(P, flash=True, forms=reversed_plain(fq)), routing_log(replay=route_p):
        witness = run_counted(checks, "Mixtral-8x7B forward, sums reversed + B7 (witness)",
                              forward, never=("B1", "B2"))
    with plain_versions(P, forms=dropped_group_plain(fq)), routing_log(replay=route_p):
        control = run_counted(checks, "Mixtral-8x7B forward, down's last group out (control)",
                              forward, never=("B1", "B2", "B7"))
    r_k, r_w, r_c = (logit_rows(x, ref) for x in (replayed, witness, control))
    log(f"  Mixtral-8x7B forward [1, 128]: expert picks that differ between the kernels and the "
        f"plain versions {flips} of {len(route_k.picks) * toks.shape[1]} (layer, token); free "
        f"run, kernels vs plain + eager, max over rows of max|d logit| / max|logit| "
        f"{r_free:.3e} (reported: a flipped pick moves a token's expert mix); on the plain "
        f"route's picks: kernels {r_k:.3e}, witness (reversed sums + B7) {r_w:.3e}, control "
        f"(every down's last group out) {r_c:.3e} (bound {ARCH_ROW_TOL:g}; the control must "
        f"read past it)")
    if not (r_k <= ARCH_ROW_TOL and r_w <= ARCH_ROW_TOL and r_c > ARCH_ROW_TOL):
        raise AssertionError(f"Mixtral-8x7B: kernels {r_k}, witness {r_w}, control {r_c} "
                             f"against the bound {ARCH_ROW_TOL}")
    del ref, replayed, witness, control
    try:
        P.set_moe_capacity(8.0)
        with routing_log() as route_c:
            roomy = run_counted(counts, "Mixtral-8x7B forward [1,128] capacity 8.0", forward,
                                must=("B2", "B7"))
        dropped8 = capacity_drops(route_c, cfg, 8.0)[1]
        # the same capacity forward on the dense kernel run's picks
        with routing_log(replay=route_k):
            roomy_r = run_counted(checks, "Mixtral-8x7B capacity 8.0 on dense's picks (check)",
                                  forward, must=("B2", "B7"))
        P.set_moe_capacity(1.25)
        with routing_log() as route_t:
            tight = run_counted(counts, "Mixtral-8x7B forward [1,128] capacity 1.25", forward,
                                must=("B2", "B7"))
        picks, dropped = capacity_drops(route_t, cfg, 1.25)
    finally:
        P.set_moe_capacity(None)
    r_cap, r_cap_free = logit_rows(roomy_r, dense), logit_rows(roomy, dense)
    log(f"  Mixtral-8x7B capacity 8.0: {dropped8} picks dropped; {flipped(route_c, route_k)} "
        f"picks differ from the dense run's (the combine sums the same products in another "
        f"order); on the dense run's picks vs dense: max over rows {r_cap:.3e} (bound "
        f"{ARCH_ROW_TOL:g}), free run {r_cap_free:.3e} (reported); capacity 1.25: finite "
        f"{bool(tight.isfinite().all())}, {dropped} of {picks} picks dropped, max over rows vs "
        f"dense {logit_rows(tight, dense):.3e} (reported)")
    if not (r_cap <= ARCH_ROW_TOL and dropped8 == 0 and bool(tight.isfinite().all())):
        raise AssertionError(f"Mixtral-8x7B capacity: 8.0 reads {r_cap}, {dropped8} dropped")
    del dense, roomy, roomy_r, tight
    routed_b2_forward(P, params, cfg, counts, checks, gen)
    arch_decodes(P, params, cfg, "Mixtral-8x7B", counts, toks,
                 ((8, ("B1", "B5"), (), ("B5.stats", "B6")),), moe_limit=None)
    serve_and_compare(P, params, cfg, card, "Mixtral-8x7B serve int8", counts,
                      ("B1", "B2", "B5"), never=("B5.stats",), windowed=False)
    if timing:
        moe_dispatch_times(P, params, cfg, card)
    arch_summary("Mixtral-8x7B", counts, t0, card)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def drive_archs(P, card):
    """Phase 12, the other architectures, each at full width and depth,
    RTN-quantized and freed before the next is built:

    1. OPT-125M (`OPT_125M`, `init_params` seed 3, bf16, W4 g128 packed):
       `forward_logits` at [1, 128] and [1, 2048] (B2, B7) against the plain
       versions with the eager attention (ARCH_ROW_TOL a row); a 128-token
       prefill and 32 greedy steps on the int8 cache (B1, B5) and on the fp
       cache (B1, B6), decode against the teacher-forced forward < 0.15;
       `decode_window` for 32 steps (B1, B5 with statistics: OPT windows,
       JAX's gate); the default `ServingEngine(8, 512)` on the int8 cache,
       the 16 requests, pipelined = sequential, windowed.
    2. Falcon-7B (`FALCON_7B`, seed 4, W4 g64): the same forwards (B7 at 71
       query heads over one K/V head); 32 greedy steps on the int8 and the
       fp cache on B1 with the eager attention, the only routes allowed
       `B5.eager` and `B6.eager` (rep 71 > 8; JAX's gate also sends D = 64
       eager); the default engine (fp cache) on the 16 requests.
    3. Mixtral-8x7B (`MIXTRAL_8X7B`, W4 g128 packed, built layer by layer,
       seeds 100 + i; `drive_mixtral`): `forward_logits` [1, 128] dense
       (every expert on B2, no B1) on the kernels and
       on the plain versions, the experts' picks that differ between them
       counted (a near tie flips with any rounding, and a flip moves that
       token's output: the free runs' distance is reported); then on the
       plain route's picks (`routing_log(replay=...)`) the kernels, a sound
       witness (the plain versions' sums reversed, B7) and a faulty control
       (every down projection's last group of 128 left out,
       `dropped_group_plain`) against the plain versions, within
       ARCH_ROW_TOL but the control, which must read past it; under
       `set_moe_capacity(8.0)` (nothing can drop) on the dense run's picks
       within ARCH_ROW_TOL of the dense forward (the free run's distance
       and its flipped picks reported), under 1.25 finite with the dropped
       picks counted; `routed_b2_forward` at [1, 2048]; 32 greedy int8
       steps (B1 per expert, B5), decode
       against the forward on the forward's picks; the int8 engine on the
       16 requests (MoE never windows)."""
    import gc

    import torch

    t_phase = time.time()
    paths = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)

    # 1. OPT-125M
    t0, counts, checks = time.time(), {}, {}
    cfg = P.OPT_125M
    params = P.quantize_model_rtn(
        P.init_params(cfg, torch.Generator(device="cuda").manual_seed(3), dtype=torch.bfloat16),
        cfg, P.QuantSpec(n_bits=4, group_size=GS), pack=True)
    log(f"phase 12: OPT-125M W4 g{GS} packed, {cfg.num_layers} layers, built in "
        f"{time.time() - t0:.2f} s")
    prompt, _ = arch_forwards(P, params, cfg, "OPT-125M", counts, checks, (128, 2048), gen)
    arch_decodes(P, params, cfg, "OPT-125M", counts, prompt,
                 ((8, ("B1", "B5"), (), ()), (False, ("B1", "B6"), (), B5_KEYS)))
    cache = P.init_kv_cache(cfg, 1, 512, quantized=8)
    lg, cache = P.decode_step(params, cache, prompt, 0, cfg)
    toks, _ = run_counted(counts, "OPT-125M decode_window 32 steps (int8)",
                          lambda: P.decode_window(params, cache, lg[:, -1].argmax(-1)[:, None],
                                                  128, 32, cfg), must=("B1", "B5.stats"))
    if not (P.windowed_ok(cfg, cache) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
        raise AssertionError("OPT-125M: windowed decode refused or tokens out of range")
    del cache
    serve_and_compare(P, params, cfg, card, "OPT-125M serve int8", counts, PALLAS_MUST,
                      windowed=True)
    arch_summary("OPT-125M", counts, t0, card)
    paths.update(counts)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # 2. Falcon-7B
    t0, counts, checks = time.time(), {}, {}
    cfg = P.FALCON_7B
    params = P.quantize_model_rtn(
        P.init_params(cfg, torch.Generator(device="cuda").manual_seed(4), dtype=torch.bfloat16),
        cfg, P.QuantSpec(n_bits=4, group_size=64), pack=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 12: Falcon-7B W4 g64 packed, {cfg.num_layers} layers, built in "
        f"{time.time() - t0:.2f} s ({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated)")
    prompt, _ = arch_forwards(P, params, cfg, "Falcon-7B", counts, checks, (128, 2048), gen)
    arch_decodes(P, params, cfg, "Falcon-7B", counts, prompt,
                 ((8, ("B1",), ("B5.eager",), B5_KEYS + ("B6",)),
                  (False, ("B1",), ("B6.eager",), B5_KEYS + ("B6",))))
    serve_and_compare(P, params, cfg, card, "Falcon-7B serve fp", counts, ("B1", "B2"),
                      quantized_cache=False, never=B5_KEYS + ("B6",), allow=("B6.eager",))
    arch_summary("Falcon-7B", counts, t0, card)
    paths.update(counts)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # 3. Mixtral-8x7B
    paths.update(drive_mixtral(P, card, gen))
    log(f"phase 12 (other architectures) in {time.time() - t_phase:.1f} s  [{card}]")
    return sum_counts(paths)


# ---------------------------------------------------------------- phase 13 ----
#: T0-3B, the reference's seq2seq model (bigscience/T0_3B `config.json`:
#: gated-gelu, untied head); built here since the JAX package names no such
#: config
T0_3B = dict(vocab_size=32128, d_model=2048, d_kv=64, d_ff=5120, num_heads=32, num_layers=24,
             num_decoder_layers=24, rel_buckets=32, rel_max_distance=128, gated_act=True,
             tie_word_embeddings=False, layer_norm_eps=1e-6, decoder_start_token_id=0,
             pad_token_id=0, eos_token_id=1)
#: (K, N) of T0-3B's linears at g128
T5_LINEARS = {"t0-3b q/k/v/o/cq/ck/cv/co": (2048, 2048), "t0-3b wi0/wi1": (2048, 5120),
              "t0-3b wo": (5120, 2048)}
#: (kernel, M) of their checks: cached steps at B = 1, 4, 8; a [1, 128]
#: decoder; the [4, 512] encoder
T5_QMM_CASES = (("B1", 1), ("B1", 4), ("B1", 8), ("B2", 128), ("B2", 2048))
#: linears a T0-3B layer runs through `qlinear`: the encoder's, the
#: decoder's, a cached step's (the cross k/v come from the state)
T5_ENC_LINEARS, T5_DEC_LINEARS, T5_STEP_LINEARS = 7, 11, 9
T5_STEPS = 32
#: phase 13's bound on the T0-3B forward's logits, kernels against B1's and
#: B2's plain versions (the attention is eager on both): every position's
#: row within T5_ROW_TOL * that row's max|logit|; the sound witness
#: (reversed sums) must read within it and the faulty control (every wo's
#: last group of 128 left out) past it, in the same run. Readings: kernels
#: 2.217e-2, witness 2.250e-2, control 8.057e-2 (NVIDIA H100 80GB HBM3,
#: 700 W)
T5_ROW_TOL = ARCH_ROW_TOL


def check_t5_kernels(P, gen, results):
    """B1 at M = 1, 4 and 8 and B2 at M = 128 and 2048 on T0-3B's three
    linear shapes (W4 g128): fp32 out within 1e-4 * max|ref|, bf16 within
    1e-2, as `check_qmatmul`."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    for label, (k, n) in T5_LINEARS.items():
        qt = rand_weights(P, k, n, 1, gen)[0]
        for kid, m in T5_QMM_CASES:
            kern, plain = ((fq.qmm_gemv, fq.qmm_gemv_plain) if kid == "B1"
                           else (fq.qmm_gemm, fq.qmm_gemm_plain))
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            compare(f"{kid} {label} M={m} fp32-out", kern(x, qt, torch.float32),
                    plain(x, qt, torch.float32), 1e-4)
            err = compare(f"{kid} {label} M={m} bf16-out", kern(x, qt, torch.bfloat16),
                          plain(x, qt, torch.bfloat16), 1e-2)
            results.setdefault(kid, {})[f"{label} M={m}"] = err


def t5_fp32_activations(params):
    """`params` with `shared`, the norms, the relative-bias tables and the
    head in fp32 (the same quantized linears, which still round x to bf16):
    the trunk keeps its activations in fp32."""
    wide = {k: v if k in ("enc", "dec") else v.float() for k, v in params.items()}
    for side in ("enc", "dec"):
        wide[side] = {"layers": {k: w.float() if k.startswith("ln") else w
                                 for k, w in params[side]["layers"].items()}}
    return wide


def write_t5_dir(params, cfg, path):
    """An HF T5 directory of `params`: `model.safetensors` under HF's names
    (linears back to `[out, in]`) and a `config.json`."""
    from llama3_quantization_tpu_torch.models import hf_loader
    from llama3_quantization_tpu_torch.models import seq2seq as S

    tensors = {"shared.weight": params["shared"], "lm_head.weight": params["lm_head"].T,
               "encoder.final_layer_norm.weight": params["enc_ln"],
               "decoder.final_layer_norm.weight": params["dec_ln"]}
    for side, sub, names in (("encoder", 1, S.T5_ENC_NAMES), ("decoder", 2, S.T5_DEC_NAMES)):
        tensors[f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = \
            params[side[:3] + "_rel"]
        for ours, theirs in {**names, **S.t5_mlp_names(cfg.gated_act, sub)}.items():
            for i, w in enumerate(params[side[:3]]["layers"][ours]):
                tensors[f"{side}.block.{i}.{theirs}"] = w if ours.startswith("ln") else w.T
    hf_loader.write_safetensors(tensors, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "t5", "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
                   "d_kv": cfg.d_kv, "d_ff": cfg.d_ff, "num_heads": cfg.num_heads,
                   "num_layers": cfg.num_layers, "num_decoder_layers": cfg.num_decoder_layers,
                   "relative_attention_num_buckets": cfg.rel_buckets,
                   "relative_attention_max_distance": cfg.rel_max_distance,
                   "feed_forward_proj": "gated-gelu" if cfg.gated_act else "relu",
                   "tie_word_embeddings": cfg.tie_word_embeddings,
                   "layer_norm_epsilon": cfg.layer_norm_eps,
                   "decoder_start_token_id": cfg.decoder_start_token_id,
                   "pad_token_id": cfg.pad_token_id, "eos_token_id": cfg.eos_token_id}, f)


def drive_seq2seq(P, card):
    """Phase 13, the T5 trunk at T0-3B's published width and depth (`T0_3B`:
    24 + 24 layers, bf16 random normals from `init_seq2seq_params` seed 17,
    RTN W4 g128 packed by `quantize_seq2seq_rtn`):

    1. `forward_logits_seq2seq` on an encoder [4, 512] (row 3 padded from
       position 300) and a decoder [4, 128]: B2 only, 432 launches (7 + 11
       linears x 24 layers); against B1's and B2's plain versions (the
       attention eager on both), with the sound witness (reversed sums) and
       the faulty control (every wo's last group left out) read in the same
       run: max over positions of max|d logit| / max|logit| within
       T5_ROW_TOL, the control past it;
    2. `greedy_generate_seq2seq_cached`, 32 steps at B = 4: B2 only for the
       encoder and the cross K/V (216), then 216 B1 launches a step; each
       step's logits (the stream fed back) against the teacher-forced
       `decode_logits` (< 0.15, phase 4's bound); the stream against the
       O(T^2) `greedy_generate_seq2seq` (B2), equal but at near ties (a
       row's first difference where the cached step's top-2 gap is within
       twice its distance to the teacher-forced logits), counted and
       printed;
    3. 4 cached steps under `utils.profile_trace`, read back by
       `tools/profile_report`: B1's kernel (`qmm_gemv_kernel`) 864 times;
    4. `Seq2SeqTorchLM` (`ByteTokenizer`, batch 4) on the study's 27 piqa
       and arc_easy requests with fp32 activations, kernels against the
       plain versions, |d ll| per continuation token <= EVAL_LL_TOL;
       `greedy_until` on two contexts (16 tokens) equal to
       `greedy_generate_seq2seq_cached` from the same bucketed input;
    5. `api.quantize(method="gptq")` at T0-3B width, 2 + 2 layers, 8
       calibration windows of 512 bytes of the fixture's front half
       (`ByteTokenizer`) split by `split_calib_pairs`: seconds a block,
       capture under "xla" (no kernel), and its mean |d logit| against the
       fp model below RTN W4 g128's on held-out windows of the back half;
    6. `cli.main` on an HF directory of that 2 + 2-layer model (written by
       `write_safetensors`) with `--quant_method gptq --wbits 4 --group_size
       128 --calib_dataset synthetic --nsamples 4 --seqlen 512`: JAX's
       `t5-seq2seq` and `gptq W4 g128 applied (seq2seq)` lines;

    No call may launch B5, B6 or B7, or take a route off the kernels."""
    import contextlib
    import gc
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    from llama3_quantization_tpu_torch import api, cli
    from llama3_quantization_tpu_torch.eval import ByteTokenizer, bucket_pow2
    from llama3_quantization_tpu_torch.eval import data as tdata
    from llama3_quantization_tpu_torch.eval.harness import Seq2SeqTorchLM
    from llama3_quantization_tpu_torch.models import seq2seq as S
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq
    from llama3_quantization_tpu_torch.tools import profile_report
    from llama3_quantization_tpu_torch.tools.reproduce_study import CORPUS
    from llama3_quantization_tpu_torch.utils import profile_trace

    t_phase = time.time()
    counts, checks = {}, {}
    never = B5_KEYS + ("B6", "B6.f32", "B7", "B7.stats")
    kernels_off = ("B1", "B2") + never
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    cfg = P.Seq2SeqConfig(**T0_3B)
    spec = P.QuantSpec(n_bits=4, group_size=GS)
    L = cfg.num_layers

    t0 = time.time()
    fp = P.init_seq2seq_params(cfg, torch.Generator(device="cuda").manual_seed(17),
                               dtype=torch.bfloat16)
    torch.cuda.synchronize()
    fp_gib = torch.cuda.memory_allocated() / 2**30
    params = P.quantize_seq2seq_rtn(fp, cfg, spec, pack=True)
    del fp
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 13: T0-3B W4 g{GS} packed, {L} + {cfg.num_decoder_layers} layers, built in "
        f"{time.time() - t0:.2f} s ({fp_gib:.2f} GiB allocated with the bf16 weights, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after quantizing)")

    # 1. the teacher-forced forward
    enc = torch.randint(2, cfg.vocab_size, (4, 512), generator=gen, device="cuda")
    enc[3, 300:] = cfg.pad_token_id
    dec = torch.randint(2, cfg.vocab_size, (4, 128), generator=gen, device="cuda")
    dec[:, 0] = cfg.decoder_start_token_id

    def forward():
        return P.forward_logits_seq2seq(params, enc, dec, cfg)

    label = "T0-3B forward_logits_seq2seq enc [4,512] dec [4,128]"
    logits, secs = run_counted(counts, label, lambda: timed(forward), must=("B2",),
                               never=("B1",) + never)
    b2 = (T5_ENC_LINEARS + T5_DEC_LINEARS) * L
    if counts[label]["B2"] != b2:
        raise AssertionError(f"{label}: {counts[label]['B2']} B2 launches, not {b2}")
    with plain_versions(P):
        ref = run_counted(checks, "T0-3B forward, plain (check)", forward, never=kernels_off)
    with plain_versions(P, forms=reversed_plain(fq)):
        witness = run_counted(checks, "T0-3B forward, sums reversed (witness)", forward,
                              never=kernels_off)
    with plain_versions(P, forms=dropped_group_plain(fq, k=cfg.d_ff)):
        control = run_counted(checks, "T0-3B forward, wo's last group out (control)", forward,
                              never=kernels_off)
    r_k, r_w, r_c = (logit_rows(x, ref) for x in (logits, witness, control))
    log(f"  T0-3B forward (first call {secs:.2f} s host clock, {b2} B2 launches), kernels vs "
        f"plain, max over rows of max|d logit| / max|logit|: kernels {r_k:.3e}, witness "
        f"(reversed sums) {r_w:.3e}, control (every wo's last group of {GS} out) {r_c:.3e} "
        f"(bound {T5_ROW_TOL:g}; the control must read past it)  [{card}]")
    if not (r_k <= T5_ROW_TOL and r_w <= T5_ROW_TOL and r_c > T5_ROW_TOL):
        raise AssertionError(f"T0-3B forward: kernels {r_k}, witness {r_w}, control {r_c} "
                             f"against the bound {T5_ROW_TOL}")
    del logits, ref, witness, control

    # 2. the cached decode
    n, start = T5_STEPS, cfg.decoder_start_token_id
    label = f"T0-3B greedy_generate_seq2seq_cached {n} steps, B=4"
    toks, secs = run_counted(
        counts, label, lambda: timed(lambda: P.greedy_generate_seq2seq_cached(params, enc, n, cfg)),
        must=("B1", "B2"), never=never)
    b1, b2 = T5_STEP_LINEARS * L * n, (T5_ENC_LINEARS + 2) * L
    if (counts[label]["B1"], counts[label]["B2"]) != (b1, b2):
        raise AssertionError(f"{label}: B1 {counts[label]['B1']} (not {b1}), B2 "
                             f"{counts[label]['B2']} (not {b2}: the encoder and cross K/V only)")
    if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{label}: tokens out of range")

    def stepped():
        state = S.init_seq2seq_state(params, enc, n, cfg)
        tok, out = torch.full((4, 1), start, dtype=torch.long, device="cuda"), []
        for i in range(n):
            lg, state = S.decode_step_seq2seq(params, state, tok, i, cfg)
            out.append(lg[:, 0].float())
            tok = toks[:, i : i + 1]
        return torch.stack(out, 1), state["enc_h"], state["enc_mask"]

    steps, enc_h, enc_mask = run_counted(checks, "T0-3B cached steps fed the stream (check)",
                                         stepped, must=("B1",), never=never)
    if not torch.equal(steps.argmax(-1), toks):
        raise AssertionError("T0-3B: the cached steps fed their own stream gave another stream")
    dec_in = torch.cat([torch.full((4, 1), start, dtype=torch.long, device="cuda"),
                        toks[:, :-1]], 1)
    tf = run_counted(checks, "T0-3B teacher-forced decode_logits [4, 32] (check)",
                     lambda: S.decode_logits(params, dec_in, enc_h, cfg, P.NO_QUANT,
                                             enc_mask).float(), must=("B2",), never=never)
    rel = float((steps - tf).abs().max() / tf.abs().max())
    reforward = run_counted(checks, "T0-3B greedy_generate_seq2seq re-forward (check)",
                            lambda: P.greedy_generate_seq2seq(params, enc, n, cfg),
                            must=("B2",), never=("B1",) + never)
    ties = []
    for row in range(4):
        diff = (toks[row] != reforward[row]).nonzero()
        if len(diff):
            i = int(diff[0])
            top = steps[row, i].topk(2).values
            gap, dist = float(top[0] - top[1]), float((steps[row, i] - tf[row, i]).abs().max())
            ties.append((row, i, gap, dist))
    log(f"  T0-3B cached decode: {4 * n / secs:.1f} tok/s (B=4, {n} steps, first call, host "
        f"clock); each step's logits vs the teacher-forced decode_logits: max rel error "
        f"{rel:.3e} (limit 0.15); stream vs the re-forward: {4 - len(ties)} of 4 rows equal, "
        f"first differences (row, step, top-2 gap, |d logit| to teacher-forced) {ties}  [{card}]")
    if not rel < 0.15:
        raise AssertionError(f"T0-3B decode/forward divergence: rel err {rel:.4f}")
    far = [t for t in ties if t[2] > 2 * t[3]]
    if far:
        raise AssertionError(f"T0-3B: cached and re-forward streams differ away from a near "
                             f"tie: {far}")
    del steps, tf, enc_h

    # 3. the profiler around 4 cached steps, read back by the trace report
    state = run_counted(counts, "T0-3B init_seq2seq_state (profiled steps' state)",
                        lambda: S.init_seq2seq_state(params, enc, 4, cfg), must=("B2",),
                        never=("B1",) + never)
    with tempfile.TemporaryDirectory(prefix="t5_trace_") as tdir:
        def traced():
            tok = torch.full((4, 1), start, dtype=torch.long, device="cuda")
            with profile_trace(tdir):
                for i in range(4):
                    lg, _ = S.decode_step_seq2seq(params, state, tok, i, cfg)
                    tok = lg[:, 0].argmax(-1)[:, None]

        run_counted(counts, "T0-3B 4 cached steps under profile_trace", traced, must=("B1",),
                    never=("B2",) + never)
        rows = profile_report.main([tdir, "--steps", "4", "--top", "200"])
    b1 = sum(r["count"] for r in rows if "qmm_gemv_kernel" in r["name"])
    log(f"  profile_report: B1 (qmm_gemv_kernel) {b1} launches in the trace "
        f"({[r['name'][:40] for r in rows[:3]]} lead)  [{card}]")
    if b1 != 4 * T5_STEP_LINEARS * L:
        raise AssertionError(f"profile_report: {b1} B1 launches, not {4 * T5_STEP_LINEARS * L}")
    del state

    # 4. the harness's seq2seq engine
    tok = ByteTokenizer()
    reqs = eval_requests(tok)
    ntok = [len(tok.encode(cont)) for _, cont in reqs]
    wide = t5_fp32_activations(params)
    lm = Seq2SeqTorchLM(wide, cfg, tok, batch_size=4)
    ll = run_counted(counts, f"Seq2SeqTorchLM.loglikelihood x {len(reqs)} (fp32 activations)",
                     lambda: lm.loglikelihood(reqs), must=("B2",), never=never)
    with plain_versions(P):
        ll_plain = run_counted(checks, "Seq2SeqTorchLM.loglikelihood, plain (check)",
                               lambda: lm.loglikelihood(reqs), never=kernels_off)
    d_ll = max(abs(a[0] - b[0]) / c for a, b, c in zip(ll, ll_plain, ntok))
    flags = sum(a[1] == b[1] for a, b in zip(ll, ll_plain))
    del lm, wide
    lm = Seq2SeqTorchLM(params, cfg, tok, batch_size=4)
    lm.max_gen_toks = 16
    seen = []
    lm.tok_decode = lambda ids: (seen.append(list(ids)), tok.decode(ids))[1]
    text = CORPUS.read_text()
    back = text[len(text) // 2:]
    ctxs = [back[:300], back[5000:5700]]

    def generate():
        out = []
        for ctx in ctxs:
            lm.greedy_until([(ctx, ["<<no such text>>"])])
            out.append(seen[-1])
        return out

    got = run_counted(counts, "Seq2SeqTorchLM.greedy_until x 2, 16 tokens", generate,
                      must=("B1", "B2"), never=never)
    keep = max(lm.max_length - lm.max_gen_toks, lm.max_length // 2)
    refs = []
    for ctx in ctxs:
        ids = lm.tok_encode(ctx)[-keep:]
        padded = torch.full((1, bucket_pow2(len(ids))), cfg.pad_token_id, dtype=torch.long,
                            device="cuda")
        padded[0, : len(ids)] = torch.tensor(ids, device="cuda")
        with torch.inference_mode():
            stream = P.greedy_generate_seq2seq_cached(params, padded, 16, cfg)[0].tolist()
        refs.append(stream[: stream.index(cfg.eos_token_id)] if cfg.eos_token_id in stream
                    else stream)
    log(f"  Seq2SeqTorchLM, {len(reqs)} piqa/arc_easy requests, fp32 activations: max |d ll| "
        f"per continuation token {d_ll:.3e} against B1's and B2's plain versions (limit "
        f"{EVAL_LL_TOL:g}), greedy flags equal {flags}/{len(reqs)}; greedy_until {got} "
        f"(greedy_generate_seq2seq_cached {refs})  [{card}]")
    if not d_ll <= EVAL_LL_TOL:
        raise AssertionError(f"Seq2SeqTorchLM kernels against plain: {d_ll} per token")
    if got != refs:
        raise AssertionError(f"greedy_until {got} != greedy_generate_seq2seq_cached {refs}")
    del lm, params
    gc.collect()
    torch.cuda.empty_cache()

    # 5. GPTQ at T0-3B width, 2 + 2 layers
    small = P.Seq2SeqConfig(**{**T0_3B, "num_layers": 2, "num_decoder_layers": 2})
    fp2 = P.init_seq2seq_params(small, torch.Generator(device="cuda").manual_seed(18),
                                dtype=torch.bfloat16)
    # text, not random ids: on random ids the activations are isotropic, so
    # GPTQ has nothing to gain over RTN and fits its Hessians' noise
    front, held = tok.encode(text[: len(text) // 2]), tok.encode(back)
    starts = np.random.default_rng(SEED + 18).integers(0, len(front) - 512, 8)
    calib = np.stack([front[s0 : s0 + 512] for s0 in starts])
    marks = []

    def progress(done, total, errs):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    gq = run_counted(counts, "T0-3B width, 2 + 2 layers: api.quantize gptq W4 g128 (8 x 512)",
                     lambda: api.quantize(fp2, small, "gptq", spec, calib_tokens=calib,
                                          progress=progress), never=kernels_off)
    block_s = [round(b - a, 2) for a, b in zip(marks, marks[1:])]
    rtn = P.quantize_seq2seq_rtn(fp2, small, spec)
    h_enc = torch.from_numpy(np.stack([held[i * 700 : i * 700 + 512]
                                       for i in range(2)])).to("cuda")
    h_dec = torch.from_numpy(np.stack([held[5000 + i * 300 : 5128 + i * 300]
                                       for i in range(2)])).to("cuda")
    h_dec[:, 0] = start
    with torch.inference_mode():
        ref = P.forward_logits_seq2seq(fp2, h_enc, h_dec, small).float()
        e_g, e_r = (float((run_counted(counts, f"T0-3B width 2 + 2 forward ({name})",
                                       lambda: P.forward_logits_seq2seq(q, h_enc, h_dec, small),
                                       must=("B2",), never=never).float() - ref).abs().mean())
                    for name, q in (("gptq", gq), ("rtn", rtn)))
    log(f"  GPTQ W4 g{GS} at T0-3B width (2 + 2 layers, 8 windows of 512 split by "
        f"split_calib_pairs, bytes of the fixture's front half): seconds a block {block_s}; "
        f"held-out (the back half) mean |d logit| against the fp model: GPTQ {e_g:.4e}, RTN "
        f"{e_r:.4e}  [{card}]")
    if not e_g < e_r:
        raise AssertionError(f"T0-3B GPTQ {e_g} not below RTN {e_r}")
    del gq, rtn, ref

    # 6. the CLI on an HF directory of that model
    tmp = tempfile.mkdtemp(prefix="t0_3b_2x2_")
    try:
        write_t5_dir(fp2, small, tmp)
        del fp2
        gc.collect()
        torch.cuda.empty_cache()

        class NoTokenizer:  # the directory holds no tokenizer files
            def __init__(self, *a, **k):
                raise OSError("no tokenizer files in this directory")

        had, tdata.HFTokenizer = tdata.HFTokenizer, NoTokenizer
        err = io.StringIO()
        argv = ["--model", tmp, "--quant_method", "gptq", "--wbits", "4", "--group_size",
                str(GS), "--calib_dataset", "synthetic", "--nsamples", "4", "--seqlen", "512"]
        try:
            with contextlib.redirect_stderr(err):
                run_counted(counts, "cli.main --model <T0-3B width 2 + 2 dir> gptq W4 g128",
                            lambda: cli.main(argv), never=kernels_off)
        finally:
            tdata.HFTokenizer = had
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines = err.getvalue().strip().splitlines()
    log("  cli.main " + " ".join(argv[2:]) + ": " + " | ".join(lines))
    want = ("(t5-seq2seq, 2L)", f"gptq W4 g{GS} applied (seq2seq)")
    if not all(any(w in line for line in lines) for w in want):
        raise AssertionError(f"cli.main on a T5 directory: {want} not in {lines}")
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 13 (the T5 trunk) in {time.time() - t_phase:.1f} s  [{card}]")
    return sum_counts(counts)


#: phase 14's depth: Llama-3-8B at full width, 8 of 32 layers (for time)
PARALLEL_LAYERS = 8
#: the tensor-parallel widths whose shard shapes phase 14's kernel checks hold
PARALLEL_TPS = (2, 4, 8)


def parallel_shards(tp):
    """(name, (K, N)) of each Llama-3-8B W4 g128 linear's shard at `tp`:
    column shards of q, k/v and gate/up, row shards of o and down."""
    return (("q col", (4096, 4096 // tp)), ("k/v col", (4096, 1024 // tp)),
            ("gate/up col", (4096, 14336 // tp)), ("o row", (4096 // tp, 4096)),
            ("down row", (14336 // tp, 4096)))


def check_parallel_kernels(P, gen, results):
    """Phase 14's shapes: B1 at M = 1 and 8 and B2 at M = 128 on every
    column and row shard of the Llama-3-8B W4 g128 linears at tp = 2, 4, 8
    (each one B1 and B2 take unpadded: no `pad` route), phase 3's
    tolerances; B5 (int8 and int4, with and without stats) and B6 on the
    local KV groups G = 8 / tp (4, 2, 1), rep 4; B7 at the local heads
    H = 32 / tp over G = 8 / tp, S = 2048, row by row."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    for tp in PARALLEL_TPS:
        for name, (k, n) in parallel_shards(tp):
            qt = rand_weights(P, k, n, 1, gen)[0]
            if not (fq.b1_takes(8, k, n, GS, 4, True) and fq.b2_takes(k, n, GS, 4, True)):
                raise AssertionError(f"tp {tp} {name} [{k}, {n}]: B1 or B2 would pad it")
            for kid, m in (("B1", 1), ("B1", 8), ("B2", 128)):
                kern, plain = ((fq.qmm_gemv, fq.qmm_gemv_plain) if kid == "B1"
                               else (fq.qmm_gemm, fq.qmm_gemm_plain))
                x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                label = f"{kid} tp{tp} {name} [{k}, {n}] M={m}"
                compare(f"{label} fp32-out", kern(x, qt, torch.float32),
                        plain(x, qt, torch.float32), 1e-4)
                err = compare(f"{label} bf16-out", kern(x, qt, torch.bfloat16),
                              plain(x, qt, torch.bfloat16), 1e-2)
                results.setdefault(kid, {})[f"tp{tp} {name} M={m}"] = err
    for tp in PARALLEL_TPS:
        g = 8 // tp
        check_decode_forms(P, gen, results, g=g, ts=(512,), tag=f"tp{tp} G={g} ")
        check_fp_decode(P, gen, results, g=g, tag=f"tp{tp} G={g} ",
                        cases=((1, 512, "bf16", True), (8, 512, "bf16", False)))
    check_flash(P, gen, results, cases=tuple((1, 2048, 32 // tp, 8 // tp, 128)
                                             for tp in PARALLEL_TPS))


def build_rtn_cfg(P, cfg, seed):
    """RTN W4 g128 packed of seeded random-normal bf16 weights of `cfg`, on
    the card; also the fp tree it came from."""
    import torch

    fp = P.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    return fp, P.quantize_model_rtn(fp, cfg, P.QuantSpec(n_bits=4, group_size=GS), pack=True)


def drive_parallel(P, card):
    """Phase 14, parallelism (`parallel/`, `benchmarks/`, the sharded
    checkpoints, the CLI's --tp/--dp/--sp) at Llama-3-8B width on a world of
    one NCCL rank (a store on 127.0.0.1; one card cannot hold two NCCL
    ranks, so multi-rank collectives are proven over gloo on the CPU):

    a. a CUDA tensor's all-reduce runs on NCCL and a gloo group refuses it
       (no staging through the host), as a CPU tensor meets NCCL;
    b. `make_sharded_forward` on a (dp 1, tp 1) rank-local tree at [1, 128]:
       bit-equal to `forward_logits` (B2, B7);
    c. `shard_params` + `set_decode_mesh` + `ServingEngine(8 slots, 512,
       ljf)` on phase 5's 16 requests, `run_pipelined(16)`, on the int8 and
       the fp cache: streams identical to the one-replica engine under the
       same decode mesh (B1 at M = 8, B5 or B6 per step: no windows under a
       decode mesh but on the codes-direct route, as JAX);
    d. `make_tp_overlap_forward` [1, 128] (ring collective matmuls of one
       rank), `make_pipeline_forward` at pp 1 with 2 microbatches of [2, 128]
       and `make_sp_forward` [1, 2048] (ring attention, plain torch) against
       `forward_logits`, each within ARCH_ROW_TOL a row; `compute_ppl` with
       `sp_windowed_nll_fn` against the unsharded step, |d ln PPL| within
       EVAL_LN_PPL_TOL;
    e. `sharded_gptq_quantize_weight` of layer 0's down [14336, 4096] at tp
       1: codes, scales and zeros bit-equal to `gptq_quantize_weight`;
    f. the LWC train step at 2 layers, tokens [2, 2048 + 1], 2 steps on B7's
       gradient route (B7.stats, B7.dkv, B7.dq counted) against the same
       steps under `set_flash(False)`: losses within 1e-2 relative (B7
       rounds p and ds to bf16), the updated clipping logits reported;
    g. a 4-layer W4 g128 rank-local tree through `save_checkpoint_sharded`
       and `load_checkpoint_sharded`: every leaf and the forward bit-equal;
    h. `measure_scaling(device_counts=(1,))`: tok/s beside the card;
    i. `cli.main` at 4 layers, RTN W4 g128 `--eval_ppl` (1 window of 2048):
       with `--tp 1 --dp 1` and with `--sp 1` against the same run without,
       |d ln PPL| within EVAL_LN_PPL_TOL."""
    import dataclasses
    import gc
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from llama3_quantization_tpu_torch import parallel as PP
    from llama3_quantization_tpu_torch.benchmarks import measure_scaling
    from llama3_quantization_tpu_torch.eval.ppl import compute_ppl, sp_windowed_nll_fn
    from llama3_quantization_tpu_torch.models import configs as TCFG
    from llama3_quantization_tpu_torch.models.hf_loader import (
        load_checkpoint_sharded,
        save_checkpoint_sharded,
    )
    from llama3_quantization_tpu_torch.ops import collectives as C
    from llama3_quantization_tpu_torch.parallel import distributed, mesh as M, train
    from llama3_quantization_tpu_torch.parallel.pipeline import _layer_slice
    from llama3_quantization_tpu_torch.quant.gptq import (
        gptq_quantize_weight,
        hessian_init,
        hessian_update,
    )
    from llama3_quantization_tpu_torch.utils.pytree_io import _unflatten, tree_leaves

    counts, checks = {}, {}
    t_phase = time.time()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    distributed.init_distributed()
    try:
        # a. the backends
        backend = str(dist.get_backend())
        x = torch.arange(4.0, device="cuda")
        C.all_reduce_(x, dist.group.WORLD)
        gloo = dist.new_group(backend="gloo")
        refused = []
        for t, group in ((x, gloo), (x.cpu(), dist.group.WORLD)):
            try:
                C.all_reduce_(t, group)
            except RuntimeError as e:
                refused.append(str(e).split(":")[0])
        log(f"  world of {dist.get_world_size()} ({backend}); a CUDA all-reduce on NCCL "
            f"{x.tolist()}; refused: {refused}")
        if backend != "nccl" or len(refused) != 2:
            raise AssertionError(f"collectives: backend {backend}, refusals {refused}")

        cfg = dataclasses.replace(P.LLAMA3_8B, num_layers=PARALLEL_LAYERS)
        (fp, params), dt = timed(lambda: build_rtn_cfg(P, cfg, SEED + 14))
        down_fp = fp["layers"]["down"]["w"][0].clone()
        del fp
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  RTN W4 g128, {PARALLEL_LAYERS} layers at 8B width: {dt:.1f} s")
        mesh = PP.make_mesh(dp=1, tp=1)
        local = PP.shard_params(params, mesh, cfg)

        # b. the sharded forward
        toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")
        fwd = PP.make_sharded_forward(cfg, mesh)
        got = run_counted(counts, "make_sharded_forward (dp 1, tp 1) [1,128]",
                          lambda: fwd(local, toks), must=("B2", "B7"))
        ref = run_counted(checks, "forward_logits [1,128] (check)",
                          lambda: P.forward_logits(params, toks, cfg))
        log(f"  make_sharded_forward == forward_logits bit for bit: {torch.equal(got, ref)}")
        if not torch.equal(got, ref):
            raise AssertionError("the (dp 1, tp 1) sharded forward differs from forward_logits")

        # c. the sharded engines under the decode mesh
        reqs = serve_requests(16, cfg.vocab_size)
        P.set_decode_mesh(mesh)
        try:
            for quantized, must in ((8, ("B1", "B2", "B5")), (False, ("B1", "B2", "B6"))):
                kind = "int8" if quantized else "fp"
                eng = P.ServingEngine(local, cfg, max_slots=8, max_len=512, schedule="ljf",
                                      quantized_cache=quantized)
                (streams, secs) = run_counted(
                    counts, f"sharded ServingEngine {kind}, decode mesh, run_pipelined(16)",
                    lambda: timed(lambda: pipelined_streams(eng, reqs, 16)), must=must)
                one = P.ServingEngine(params, cfg, max_slots=8, max_len=512, schedule="ljf",
                                      quantized_cache=quantized)
                want = run_counted(checks, f"one-replica engine {kind} (check)",
                                   lambda: pipelined_streams(one, reqs, 16))
                check_streams(f"sharded engine {kind}", streams, reqs, cfg.vocab_size)
                n_tok = sum(map(len, streams))
                log(f"  sharded engine {kind}: {n_tok} tokens in {secs:.2f} s "
                    f"({n_tok / secs:.1f} tok/s), windows {eng.dispatches}, streams == "
                    f"one replica's: {streams == want}  [{card}]")
                if streams != want:
                    raise AssertionError(f"sharded engine {kind}: streams differ")
                del eng, one
        finally:
            P.set_decode_mesh(None)

        # d. the other forwards
        readings = {}
        got = run_counted(counts, "make_tp_overlap_forward (tp 1) [1,128]",
                          lambda: PP.make_tp_overlap_forward(cfg, mesh)(local, toks),
                          must=("B2", "B7"))
        readings["tp_overlap [1,128]"] = logit_rows(got, ref)
        toks4 = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen, device="cuda")
        pmesh = M.named_mesh((1,), ("pp",))
        stage = PP.shard_params_pipeline(params, pmesh, cfg)
        got = run_counted(counts, "make_pipeline_forward (pp 1, 2 microbatches of [2,128])",
                          lambda: PP.make_pipeline_forward(cfg, pmesh, 2)(stage, toks4),
                          must=("B2", "B7"))
        ref4 = run_counted(checks, "forward_logits [4,128] (check)",
                           lambda: P.forward_logits(params, toks4, cfg))
        readings["pipeline [4,128]"] = logit_rows(got, ref4)
        smesh = M.named_mesh((1,), ("sp",))
        toks_l = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
        got = run_counted(counts, "make_sp_forward (sp 1) [1,2048]",
                          lambda: PP.make_sp_forward(cfg, smesh)(params, toks_l), must=("B2",),
                          never=("B7",))
        ref_l = run_counted(checks, "forward_logits [1,2048] (check)",
                            lambda: P.forward_logits(params, toks_l, cfg))
        readings["sp forward [1,2048]"] = logit_rows(got, ref_l)
        del got, ref_l
        for name, r in readings.items():
            log(f"  {name} vs forward_logits: max over rows of max|d logit| / max|logit| "
                f"{r:.3e} (bound {ARCH_ROW_TOL:g})")
            if not r <= ARCH_ROW_TOL:
                raise AssertionError(f"{name}: {r} above {ARCH_ROW_TOL}")
        stream = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 2048 * 2))
        ppl_sp = run_counted(counts, "compute_ppl, sp_windowed_nll_fn (sp 1), 2 x 2048",
                             lambda: compute_ppl(params, cfg, stream, seqlen=2048,
                                                 step_fn=sp_windowed_nll_fn(cfg, smesh)),
                             must=("B2",))
        ppl = run_counted(checks, "compute_ppl, the unsharded step (check)",
                          lambda: compute_ppl(params, cfg, stream, seqlen=2048))
        d_sp = abs(math.log(ppl_sp) - math.log(ppl))
        log(f"  PPL 2 x 2048: sp step {ppl_sp:.4f}, unsharded {ppl:.4f}, |d ln PPL| {d_sp:.3e} "
            f"(limit {EVAL_LN_PPL_TOL:g})")
        if not d_sp <= EVAL_LN_PPL_TOL:
            raise AssertionError(f"sp PPL {ppl_sp} against {ppl}")

        # e. sharded GPTQ of layer 0's down
        hs = hessian_init(14336, device="cuda")
        for _ in range(2):
            hs = hessian_update(hs, torch.randn((1, 512, 14336), generator=gen, device="cuda"))
        spec = P.QuantSpec(n_bits=4, group_size=GS)
        tmesh = M.named_mesh((1,), ("tp",))
        (qt, err), secs = timed(lambda: PP.sharded_gptq_quantize_weight(
            down_fp.float(), hs.H, spec, tmesh, pack=True))
        qr, er = gptq_quantize_weight(down_fp.float(), hs.H, spec, pack=True)
        same = (torch.equal(qt.data, qr.data) and torch.equal(qt.scale, qr.scale)
                and torch.equal(qt.zero, qr.zero))
        log(f"  sharded GPTQ down [14336, 4096] (tp 1): {secs:.2f} s, codes/scales/zeros "
            f"bit-equal {same}, err {float(err):.6e} vs {float(er):.6e}")
        if not same:
            raise AssertionError("sharded GPTQ differs from gptq_quantize_weight")
        del down_fp, hs, qt, qr

        # f. the LWC train step, B7's gradient route against the eager one
        cfg2 = dataclasses.replace(P.LLAMA3_8B, num_layers=2)
        fp2 = P.init_params(cfg2, torch.Generator(device="cuda").manual_seed(SEED + 15))
        local2 = PP.shard_params(fp2, mesh, cfg2)
        wspec = P.QuantSpec(n_bits=4, group_size=GS, lwc=True)
        ttoks = torch.randint(0, cfg2.vocab_size, (2, 2049), generator=gen, device="cuda")

        def lwc_steps():
            lwc = train.init_model_lwc(local2, cfg2, wspec)
            opt, step = train.make_lwc_train_step(cfg2, mesh, wspec)
            state, losses = opt.init(lwc), []
            for _ in range(2):
                lwc, state, loss = step(lwc, state, local2, ttoks)
                losses.append(float(loss))
            return lwc, losses

        (lwc_k, loss_k), secs = timed(lambda: run_counted(
            counts, "LWC train step, 2 layers, [2,2048], 2 steps",
            lwc_steps, must=("B7.stats", "B7.dkv", "B7.dq")))
        c = counts["LWC train step, 2 layers, [2,2048], 2 steps"]
        P.set_flash(False)
        try:
            lwc_e, loss_e = run_counted(checks, "LWC train step, set_flash(False) (check)",
                                        lwc_steps, never=("B7", "B7.stats", "B7.dkv", "B7.dq"))
        finally:
            P.set_flash("auto")
        rel = max(abs(a - b) / abs(b) for a, b in zip(loss_k, loss_e))
        d = torch.cat([(a - b).abs().flatten() for a, b in zip(tree_leaves(lwc_k),
                                                               tree_leaves(lwc_e))])
        log(f"  LWC step: {secs / 2:.2f} s a step, launches B7.stats {c['B7.stats']}, "
            f"B7.dkv {c['B7.dkv']}, B7.dq {c['B7.dq']}; losses {loss_k} vs eager {loss_e} "
            f"(max rel {rel:.3e}, limit 1e-2); updated clipping logits vs eager: max |d| "
            f"{float(d.max()):.3e}, mean |d| {float(d.mean()):.3e}, share moved apart > 1e-3 "
            f"{float((d > 1e-3).float().mean()):.3e}  [{card}]")
        if not (all(map(math.isfinite, loss_k)) and rel <= 1e-2):
            raise AssertionError(f"LWC losses {loss_k} against eager {loss_e}")
        del fp2, local2, lwc_k, lwc_e
        gc.collect()
        torch.cuda.empty_cache()

        # g. a sharded checkpoint of 4 layers
        tree4 = dict(local, layers=_layer_slice(local["layers"], 0, 4))
        cfg4 = dataclasses.replace(P.LLAMA3_8B, num_layers=4)
        tmp = tempfile.mkdtemp(prefix="l3q_dcp_")
        try:
            _, t_save = timed(lambda: save_checkpoint_sharded(tree4, os.path.join(tmp, "ckpt")))
            body = {k: v for k, v in tree4.items() if k != "shard"}
            like = _unflatten(body, iter(torch.zeros_like(t) for t in tree_leaves(body)))
            like["shard"] = tree4["shard"]
            back, t_load = timed(lambda: load_checkpoint_sharded(os.path.join(tmp, "ckpt"), like))
            size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in
                       os.walk(os.path.join(tmp, "ckpt")) for f in fs)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                   zip(tree_leaves(body), tree_leaves({k: v for k, v in back.items()
                                                       if k != "shard"})))
        fwd_same = torch.equal(P.forward_logits(back, toks, cfg4), P.forward_logits(tree4, toks, cfg4))
        log(f"  sharded checkpoint, 4 layers: {size / 2**30:.2f} GiB, save {t_save:.2f} s, "
            f"load {t_load:.2f} s; leaves bit-equal {same}, forward bit-equal {fwd_same}")
        if not (same and fwd_same):
            raise AssertionError("the sharded checkpoint did not round-trip bit for bit")
        del back, like, tree4

        # h. scaling
        res = run_counted(counts, "measure_scaling (1,)",
                          lambda: measure_scaling(params, cfg, device_counts=(1,)), must=("B2",))
        log(f"  measure_scaling (1,), {PARALLEL_LAYERS} layers, [2, 128]: {json.dumps(res)}  "
            f"[{card}]")
        del params, local
        gc.collect()
        torch.cuda.empty_cache()

        # i. the CLI
        name = "llama3-8b-4layers"
        TCFG.NAMED_CONFIGS[name] = cfg4
        base = ["--net", name, "--quant_method", "rtn", "--wbits", "4", "--group_size", str(GS),
                "--eval_ppl", "--ppl_datasets", "wikitext2", "--seqlen", "2048", "--limit", "1"]
        try:
            ppls = {}
            for label, extra, must in (("one replica", [], ("B2", "B7")),
                                       ("--tp 1 --dp 1", ["--tp", "1", "--dp", "1"], ("B2", "B7")),
                                       ("--sp 1", ["--sp", "1"], ("B2",))):
                res, _, _ = cli_run(P, counts if extra else checks,
                                    f"cli.main --net llama3-8b (4 layers) rtn --eval_ppl {label}",
                                    base + extra, must=must)
                ppls[label] = res["wikitext2"]
        finally:
            del TCFG.NAMED_CONFIGS[name]
            P.set_decode_mesh(None)
        for label in ("--tp 1 --dp 1", "--sp 1"):
            d = abs(math.log(ppls[label]) - math.log(ppls["one replica"]))
            log(f"  cli {label}: PPL {ppls[label]:.4f} vs {ppls['one replica']:.4f}, "
                f"|d ln PPL| {d:.3e} (limit {EVAL_LN_PPL_TOL:g})")
            if not d <= EVAL_LN_PPL_TOL:
                raise AssertionError(f"cli {label}: PPL {ppls[label]}")
    finally:
        P.set_decode_mesh(None)
        if dist.is_initialized():
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 14 (parallelism) in {time.time() - t_phase:.1f} s  [{card}]")
    return sum_counts(counts)


#: the ranks of `--multi-rank` (one process per card)
MULTI_RANK_LAYERS = 8


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (the ranks' store)."""
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def all_ranks_equal(t) -> bool:
    """Does every rank hold the same tensor as rank 0, bit for bit?"""
    import torch
    import torch.distributed as dist

    first = t.clone()
    dist.broadcast(first, 0)
    same = torch.tensor([float(torch.equal(first, t))], device=t.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


def drive_multi_rank(P, card):
    """`--multi-rank`: the parallel paths across the cards of one host, one
    NCCL rank a card, each against the one-replica path on the rank's own
    card (Llama-3-8B width, MULTI_RANK_LAYERS layers, RTN W4 g128 of seeded
    random normals, the same on every card):

    - `make_sharded_forward` [4, 128] at (dp, tp) = (1, W), (2, W/2), (W, 1):
      every rank the same logits, within ARCH_ROW_TOL a row of
      `forward_logits` (the all-reduce sums bf16 partials in another order);
    - teacher-forced int8 decode (128-token prefill, 16 steps) on the tp W
      rank-local tree under a decode mesh against the one replica's, rows
      within ARCH_ROW_TOL; 32 greedy int8 steps, parting from the one
      replica's stream only at a near tie (top-2 gap within twice the
      step's distance on the same history); the tp W int8 engine on the 16
      requests: `run_pipelined(16)` equal to the sequential `step_n(16)`,
      every first token that differs from the one replica's at a near tie,
      the streams equal to the one replica's and where each first differs
      reported (random weights tie often in bf16, PR 17);
    - `ag_matmul` / `rs_matmul` at tp W (gate [4096, 14336] column shards,
      down [14336, 4096] row shards, 512 rows) against `qmatmul` on the
      whole weight, 1e-2 of max|ref| (bf16);
    - the tp-overlap forward [1, 512], the pipeline (pp W, 2 microbatches
      of [2, 128]) and ring attention (sp W, [1, 2048]) against
      `forward_logits`, within ARCH_ROW_TOL a row; the sp PPL within
      EVAL_LN_PPL_TOL;
    - the LWC step at tp W (2 layers, [2, 2048 + 1], B7.stats/dkv/dq)
      against the one-replica step: losses within 1e-2 relative;
    - sharded GPTQ of down at tp W: codes gathered against the one-rank
      solve (equal codes counted); a sharded checkpoint at tp W bit for bit;
    - `measure_scaling` at 1, 2, 4 (8) cards up to W (tp = n): tok/s and
      efficiency, beside the card."""
    import dataclasses
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from llama3_quantization_tpu_torch import parallel as PP
    from llama3_quantization_tpu_torch.benchmarks import measure_scaling
    from llama3_quantization_tpu_torch.eval.ppl import compute_ppl, sp_windowed_nll_fn
    from llama3_quantization_tpu_torch.models.hf_loader import (
        load_checkpoint_sharded,
        save_checkpoint_sharded,
    )
    from llama3_quantization_tpu_torch.ops import collectives as C
    from llama3_quantization_tpu_torch.parallel import mesh as M, train
    from llama3_quantization_tpu_torch.parallel.sharding import _col_qtensor, _Cut, _row_qtensor
    from llama3_quantization_tpu_torch.quant.gptq import (
        gptq_quantize_weight,
        hessian_init,
        hessian_update,
    )
    from llama3_quantization_tpu_torch.utils.pytree_io import _unflatten, tree_leaves

    rank, world = dist.get_rank(), dist.get_world_size()
    say = log if rank == 0 else (lambda msg: None)
    counts = {}
    t_phase = time.time()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    cfg = dataclasses.replace(P.LLAMA3_8B, num_layers=MULTI_RANK_LAYERS)
    fp, params = build_rtn_cfg(P, cfg, SEED + 20)
    down_fp = fp["layers"]["down"]["w"][0].float()
    del fp
    torch.cuda.empty_cache()
    say(f"  world of {world} ({dist.get_backend()}), {MULTI_RANK_LAYERS} layers at 8B width  "
        f"[{card}]")

    def check_rows(name, got, ref, bound=ARCH_ROW_TOL):
        r = logit_rows(got, ref)
        say(f"  {name}: max over rows of max|d logit| / max|logit| {r:.3e} (bound {bound:g})")
        if not r <= bound:
            raise AssertionError(f"{name}: {r} above {bound}")
        return r

    # forwards at every (dp, tp)
    toks = torch.randint(0, cfg.vocab_size, (4, 128), generator=gen, device="cuda")
    ref = P.forward_logits(params, toks, cfg)
    for dp, tp in ((1, world), (2, world // 2), (world, 1)):
        mesh = PP.make_mesh(dp=dp, tp=tp)
        local = PP.shard_params(params, mesh, cfg)
        got = run_counted(counts, f"make_sharded_forward dp {dp} tp {tp} [4,128]",
                          lambda: PP.make_sharded_forward(cfg, mesh)(local, toks),
                          must=("B2", "B7"))
        if not all_ranks_equal(got):
            raise AssertionError(f"dp {dp} tp {tp}: ranks returned different logits")
        check_rows(f"sharded forward dp {dp} x tp {tp} [4,128] vs forward_logits "
                   f"(every rank the same logits)", got, ref)
        del local, got

    mesh = PP.make_mesh(dp=1, tp=world)
    local = PP.shard_params(params, mesh, cfg)
    group = mesh.get_group("tp")

    # decode and serving under the decode mesh
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device="cuda")
    cont = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen, device="cuda")
    P.set_decode_mesh(mesh)
    try:
        got = run_counted(counts, f"teacher-forced int8 decode tp {world}",
                          lambda: teacher_forced(P, local, cfg, prompt, cont, 8), must=("B1", "B5"))
        want = teacher_forced(P, params, cfg, prompt, cont, 8)
        check_rows(f"int8 decode tp {world} (16 steps) vs one replica", got, want)

        def greedy(tree):
            cache = P.init_kv_cache(cfg, 1, 512, quantized=8)
            lg, cache = P.decode_step(tree, cache, prompt, 0, cfg)
            tok0 = lg[:, -1].argmax(dim=-1)[:, None]
            out, _ = P.greedy_generate(tree, cache, tok0, prompt.shape[1], 32, cfg)
            return torch.cat([tok0, out], dim=1)

        def rows_along(tree, stream):  # the logits that pick stream[0..n-1]
            cache = P.init_kv_cache(cfg, 1, 512, quantized=8)
            lg, _ = P.decode_step(tree, cache, prompt, 0, cfg)
            rows = [lg[0, -1]]
            for j in range(stream.shape[1] - 1):
                lg, _ = P.decode_step(tree, cache, stream[:, j:j + 1], prompt.shape[1] + j, cfg)
                rows.append(lg[0, 0])
            return torch.stack(rows).float()

        s_tp = run_counted(counts, f"greedy_generate int8 tp {world}, 32 steps",
                           lambda: greedy(local), must=("B1", "B5"))
        s_one = greedy(params)
        apart = (s_tp != s_one)[0].nonzero()
        if apart.numel():
            # a stream may part only where the one replica's top two are within
            # twice the tp model's distance from it on the same history
            i = int(apart[0, 0])
            r_one, r_tp = rows_along(params, s_one)[i], rows_along(local, s_one)[i]
            top2 = r_one.topk(2).values
            gap, dist_i = float(top2[0] - top2[1]), float((r_one - r_tp).abs().max())
            say(f"  greedy int8 tp {world}, 33 tokens: parts from the one replica at step {i}, "
                f"top-2 gap {gap:.4e} against twice the step's distance {2 * dist_i:.4e}")
            if not gap <= 2 * dist_i:
                raise AssertionError(f"greedy tp {world} parts at step {i} beyond a near tie")
        else:
            say(f"  greedy int8 tp {world}, 33 tokens: equal to the one replica's")
        reqs = serve_requests(16, cfg.vocab_size)
        eng = P.ServingEngine(local, cfg, max_slots=8, max_len=512, schedule="ljf",
                              quantized_cache=8)
        streams, secs = run_counted(counts, f"ServingEngine int8 tp {world}, run_pipelined(16)",
                                    lambda: timed(lambda: pipelined_streams(eng, reqs, 16)),
                                    must=("B1", "B5"))
        seq = P.ServingEngine(local, cfg, max_slots=8, max_len=512, schedule="ljf",
                              quantized_cache=8)
        if sequential_streams(seq, reqs, 16) != streams:
            raise AssertionError(f"engine tp {world}: run_pipelined differs from step_n")
        one = P.ServingEngine(params, cfg, max_slots=8, max_len=512, schedule="ljf",
                              quantized_cache=8)
        ones = pipelined_streams(one, reqs, 16)
        check_streams(f"engine tp {world}", streams, reqs, cfg.vocab_size)
        same = sum(a == b for a, b in zip(streams, ones))
        # a stream parting at its first token parts at the prefill: the one
        # replica's top two there must be within twice the tp model's distance
        ties = []
        for prompt_i, _ in sorted(reqs, key=lambda r: r[1]):
            t = torch.tensor([prompt_i], device="cuda")
            lo, lt = (P.decode_step(tree, P.init_kv_cache(cfg, 1, 512, quantized=8), t, 0,
                                    cfg)[0][0, -1].float() for tree in (params, local))
            if int(lo.argmax()) != int(lt.argmax()):
                top2 = lo.topk(2).values
                ties.append((float(top2[0] - top2[1]), 2 * float((lo - lt).abs().max())))
        say(f"  engine tp {world}: run_pipelined == step_n; first tokens differing from the "
            f"one replica's {len(ties)}, each at a near tie (top-2 gap, twice the distance): "
            f"{[(f'{g:.3e}', f'{d:.3e}') for g, d in ties]}")
        if not all(g <= d for g, d in ties):
            raise AssertionError(f"engine tp {world}: a first token parts beyond a near tie")
        parted = sorted(next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
                        for a, b in zip(streams, ones))
        n_tok = sum(map(len, streams))
        say(f"  engine int8 tp {world}: {n_tok} tokens in {secs:.2f} s ({n_tok / secs:.1f} tok/s), "
            f"{same} of 16 streams equal to the one replica's, first differing token of each "
            f"(sorted) {parted}  [{card}]")
        del eng, one
    finally:
        P.set_decode_mesh(None)

    # the ring collective matmuls
    cut = _Cut(world, rank)
    wg = rand_weights(P, 4096, 14336, 1, gen)[0]
    wd = rand_weights(P, 14336, 4096, 1, gen)[0]
    x = torch.randn((512, 4096), generator=gen, device="cuda").to(torch.bfloat16)
    xd = torch.randn((512, 14336), generator=gen, device="cuda").to(torch.bfloat16)
    s_loc, k_loc = 512 // world, 14336 // world
    ag = run_counted(counts, f"ag_matmul tp {world}", lambda: PP.ag_matmul(
        x[rank * s_loc:(rank + 1) * s_loc].contiguous(), _col_qtensor(wg, cut), group),
        must=("B2",))
    rs = run_counted(counts, f"rs_matmul tp {world}", lambda: PP.rs_matmul(
        xd[:, rank * k_loc:(rank + 1) * k_loc].contiguous(), _row_qtensor(wd, cut), group),
        must=("B2",))
    ref_ag = P.qmatmul(x, wg)[:, rank * (14336 // world):(rank + 1) * (14336 // world)]
    ref_rs = P.qmatmul(xd, wd)[rank * s_loc:(rank + 1) * s_loc]
    for name, g, r in (("ag_matmul gate col shards", ag, ref_ag),
                       ("rs_matmul down row shards", rs, ref_rs)):
        err = float((g.float() - r.float()).abs().max()) / float(r.float().abs().max())
        say(f"  {name} tp {world} [512 rows] vs qmatmul: max|d| / max|ref| {err:.3e} (bound 1e-2)")
        if not err <= 1e-2:
            raise AssertionError(f"{name}: {err}")

    # tp-overlap, pipeline, ring attention
    t512 = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen, device="cuda")
    got = run_counted(counts, f"tp_overlap tp {world} [1,512]",
                      lambda: PP.make_tp_overlap_forward(cfg, mesh)(local, t512), must=("B2", "B7"))
    check_rows(f"tp-overlap forward tp {world} [1,512] vs forward_logits", got,
               P.forward_logits(params, t512, cfg))
    pmesh = M.named_mesh((world,), ("pp",))
    stage = PP.shard_params_pipeline(params, pmesh, cfg)
    got = run_counted(counts, f"pipeline pp {world}",
                      lambda: PP.make_pipeline_forward(cfg, pmesh, 2)(stage, toks), must=("B2", "B7"))
    check_rows(f"pipeline pp {world}, 2 microbatches of [2,128] vs forward_logits", got, ref)
    smesh = M.named_mesh((world,), ("sp",))
    t2k = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device="cuda")
    got = run_counted(counts, f"sp forward sp {world}",
                      lambda: PP.make_sp_forward(cfg, smesh)(params, t2k), must=("B2",))
    check_rows(f"ring attention sp {world} [1,2048] vs forward_logits", got,
               P.forward_logits(params, t2k, cfg))
    stream = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 2048 * 2))
    a = compute_ppl(params, cfg, stream, seqlen=2048)
    b = run_counted(counts, f"sp PPL sp {world}", lambda: compute_ppl(
        params, cfg, stream, seqlen=2048, step_fn=sp_windowed_nll_fn(cfg, smesh)), must=("B2",))
    d = abs(math.log(a) - math.log(b))
    say(f"  sp PPL sp {world}, 2 x 2048: {b:.4f} vs {a:.4f}, |d ln PPL| {d:.3e} "
        f"(limit {EVAL_LN_PPL_TOL:g})")
    if not d <= EVAL_LN_PPL_TOL:
        raise AssertionError(f"sp PPL {b} vs {a}")
    del got, stage

    # the LWC step
    cfg2 = dataclasses.replace(P.LLAMA3_8B, num_layers=2)
    fp2 = P.init_params(cfg2, torch.Generator(device="cuda").manual_seed(SEED + 21))
    wspec = P.QuantSpec(n_bits=4, group_size=GS, lwc=True)
    ttoks = torch.randint(0, cfg2.vocab_size, (2, 2049), generator=gen, device="cuda")

    def lwc_loss(tree, m):
        lwc = train.init_model_lwc(tree, cfg2, wspec)
        opt, step = train.make_lwc_train_step(cfg2, m, wspec)
        state, losses = opt.init(lwc), []
        for _ in range(2):
            lwc, state, loss = step(lwc, state, tree, ttoks)
            losses.append(float(loss))
        return losses

    (loss_tp, secs) = run_counted(counts, f"LWC step tp {world}", lambda: timed(
        lambda: lwc_loss(PP.shard_params(fp2, mesh, cfg2), mesh)),
        must=("B7.stats", "B7.dkv", "B7.dq"))
    loss_one = None
    for r in range(world):  # every rank's one-replica mesh, made collectively
        m1 = PP.make_mesh(dp=1, tp=1, devices=[r])
        if r == rank:
            loss_one = lwc_loss(PP.shard_params(fp2, m1, cfg2), m1)
    rel = max(abs(x - y) / abs(y) for x, y in zip(loss_tp, loss_one))
    say(f"  LWC step tp {world}: {secs / 2:.2f} s a step, losses {loss_tp} vs one replica "
        f"{loss_one} (max rel {rel:.3e}, limit 1e-2)  [{card}]")
    if not rel <= 1e-2:
        raise AssertionError(f"LWC tp {world}: {loss_tp} vs {loss_one}")
    del fp2
    torch.cuda.empty_cache()

    # sharded GPTQ
    hs = hessian_init(14336, device="cuda")
    hs = hessian_update(hs, torch.randn((2, 512, 14336), generator=gen, device="cuda"))
    tmesh = M.named_mesh((world,), ("tp",))
    spec = P.QuantSpec(n_bits=4, group_size=GS)
    (qt, err), secs = timed(lambda: PP.sharded_gptq_quantize_weight(down_fp, hs.H, spec, tmesh,
                                                                    pack=True))
    parts = [torch.empty_like(qt.data) for _ in range(world)]
    dist.all_gather(parts, qt.data)
    codes = torch.cat(parts, dim=-1)
    (qr, er), secs1 = timed(lambda: gptq_quantize_weight(down_fp, hs.H, spec, pack=True))
    equal = float((codes == qr.data).float().mean())
    say(f"  sharded GPTQ down tp {world}: {secs:.2f} s ({secs1:.2f} s on one rank), packed code "
        f"bytes equal to the one-rank solve {equal:.6f}, err {float(err):.6e} vs {float(er):.6e}")

    # a sharded checkpoint
    tmp = tempfile.mkdtemp(prefix="l3q_dcp_mr_") if rank == 0 else None
    box = [tmp]
    dist.broadcast_object_list(box, 0)
    try:
        save_checkpoint_sharded(local, os.path.join(box[0], "ckpt"))
        body = {k: v for k, v in local.items() if k != "shard"}
        like = _unflatten(body, iter(torch.zeros_like(t) for t in tree_leaves(body)))
        like["shard"] = local["shard"]
        back = load_checkpoint_sharded(os.path.join(box[0], "ckpt"), like)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(body), tree_leaves({k: v for k, v in back.items() if k != "shard"})))
        flag = torch.tensor([float(same)], device="cuda")
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        say(f"  sharded checkpoint tp {world}: every rank's leaves bit-equal {bool(flag.item())}")
        if not flag.item():
            raise AssertionError("the sharded checkpoint did not round-trip")
    finally:
        dist.barrier()
        if rank == 0:
            shutil.rmtree(box[0], ignore_errors=True)

    # scaling
    res = measure_scaling(params, cfg, device_counts=tuple(n for n in (1, 2, 4, 8) if n <= world))
    say(f"  measure_scaling {MULTI_RANK_LAYERS} layers, [2n, 128] (tp n): {json.dumps(res)}  "
        f"[{card}]")
    say(f"--multi-rank ({world} ranks) in {time.time() - t_phase:.1f} s  [{card}]")
    return sum_counts(counts) if rank == 0 else None


def multi_rank_main(rank, world, port, card, q):
    """One rank of `--multi-rank`: NCCL on card `rank`."""
    import torch

    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    import llama3_quantization_tpu_torch as P
    from llama3_quantization_tpu_torch.parallel import distributed

    try:
        distributed.init_distributed(f"127.0.0.1:{port}", world, rank)
        total = drive_multi_rank(P, card)
        q.put((rank, True, total))
    except BaseException:  # reported by the parent, which fails with it
        import traceback

        q.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_multi_rank(card) -> dict:
    """Spawn one rank a card, wait for all, fail if any failed."""
    import multiprocessing as mp

    import torch

    world = torch.cuda.device_count()
    if world < 2:
        raise AssertionError(f"--multi-rank needs 2 or more cards, found {world}")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=multi_rank_main, args=(r, world, port, card, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, ok, val = q.get(timeout=1500)
            results[rank] = (ok, val)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    bad = {r: v for r, (ok, v) in results.items() if not ok}
    if bad or len(results) != world:
        raise AssertionError(f"--multi-rank failed on ranks {sorted(bad)}:\n" +
                             "\n".join(bad.values()))
    return results[0][1]


def clock_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


#: `--kernel-bench`'s groups, in the order they run
BENCH_GROUPS = ("b5", "b2", "b6", "b3", "b7", "b7grad", "gemv")


def kernel_bench(P, card, gen, groups=BENCH_GROUPS):
    """The benches of `groups`, in BENCH_GROUPS' order: the four B5 forms
    at T = 512 and 2048 and B5 under other cluster caps ("b5"); B2 W4/W3
    gate/up at M = 128, L2-warm and cold ("b2"); B6 beside SDPA ("b6");
    B3's tiled form beside bf16 `torch.matmul` ("b3"); B7 at S = 128, 512,
    2048 and 8192 beside SDPA ("b7"); B7.stats, B7.dkv and B7.dq at
    OmniQuant's shape beside SDPA's forward and backward ("b7grad"); the
    GEMVs ("gemv"). Only the checkout's own package is imported, so running
    this from two checkouts in one call compares their designs on one
    card."""
    benches = {
        "b5": lambda: bench_b5(P, card, gen), "b2": lambda: bench_b2(P, card, gen),
        "b6": lambda: bench_b6(card, gen), "b3": lambda: bench_b3_gemm(P, card, gen),
        "b7": lambda: bench_b7(card, gen), "b7grad": lambda: bench_b7_grad(card, gen),
        "gemv": lambda: bench_gemv(P, card, gen),
    }
    for group in BENCH_GROUPS:
        if group in groups:
            benches[group]()


def bench_b5(P, card, gen):
    """The four B5 forms at T = 512 and 2048 (`time_b5`) and B5 under other
    cluster caps (`bench_b5_clusters`)."""
    for key, b, t, ms, _, nbytes, ops, shape in time_b5(P, gen):
        b_ms, by = bound_ms(nbytes, ops, INT8_OPS)
        log(f"kernel bench: {key} {shape}: {ms:.4f} ms, bound {b_ms:.5f} ms ({by})  [{card}]")
    bench_b5_clusters(P, card, gen)


def bench_b2(P, card, gen):
    """B2 on W4 and W3 (bit planes) gate/up at M = 128 with one weight
    (L2-warm: 29 MB and 22 MB of codes fit the 50 MB L2) and with four
    copies cycling (cold), with the SM clock beside."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    k, n = LINEAR_SHAPES["gate/up"]
    for bits in (4, 3):
        qts = [P.quantize_rtn(torch.randn((k, n), generator=gen, device="cuda"),
                              P.QuantSpec(n_bits=bits, group_size=GS), pack=True)
               for _ in range(4)]
        x = torch.randn((128, k), generator=gen, device="cuda").to(torch.bfloat16)
        for copies in (1, 4, 1):
            ms = time_ms(lambda i: fq.qmm_gemm(x, qts[i % copies], torch.bfloat16), 50)
            log(f"kernel bench: B2 W{bits} gate/up M=128, {copies} weight "
                f"{'copy (L2-warm)' if copies == 1 else 'copies (cold)'}: {ms:.4f} ms device "
                f"time; sm clock, max, power, temperature: {clock_line()}  [{card}]")
        del qts


def bench_b6(card, gen):
    """B6 at its timed shapes (`time_b6`) beside SDPA."""
    for b, t, stacked, ms, _, lib_ms in time_b6(gen):
        log(f"kernel bench: B6 B={b} T={t} {'stacked' if stacked else 'per-layer'}: {ms:.4f} ms "
            f"(CUDA graph, events), SDPA {lib_ms:.4f} ms  [{card}]")


def bench_b5_clusters(P, card, gen):
    """B5 with stats at B = 8 (T = 512 and 2048) and B5 at B = 1 (T = 512),
    G=8, rep=4, D=128, with the split plan's cluster capped at 16, 8, 4, 2
    and 1 blocks (the plan's own cap is `S8_MAX_CLUSTER`): what the cap was
    chosen from. A checkout without the split plan skips it."""
    import torch
    from llama3_quantization_tpu_torch.ops import decode_attention as da

    if not hasattr(da, "S8_MAX_CLUSTER"):
        return
    cap = da.S8_MAX_CLUSTER
    try:
        for s in (16, 8, 4, 2, 1):
            da.S8_MAX_CLUSTER = s
            for b, t, stats in ((8, 512, True), (8, 2048, True), (1, 512, False)):
                layers, bt = 8, 1024 if t % 1024 == 0 else 512
                kq, ks, vq, vs = rand_cache(P, b, 8, t, 128, layers, gen)
                q = torch.randn((b, 1, 32, 128), generator=gen, device="cuda").to(torch.bfloat16)
                mask = decode_mask(b, t)
                ms = time_ms(lambda i: da.decode_s8(
                    q, kq[i % layers], ks[i % layers], vq[i % layers], vs[i % layers], mask,
                    torch.float32 if stats else torch.bfloat16, bt, stats), 200)
                log(f"kernel bench: {da.launch_key(False, stats)} B={b} T={t} int8, cluster "
                    f"{da.s8_split_plan(t, bt, 128, False).cluster} (cap {s}): {ms:.4f} ms  [{card}]")
                del kq, ks, vq, vs
    finally:
        da.S8_MAX_CLUSTER = cap


#: M of the GEMV bench: batch-1 decode, the speculative verify, the 8-slot
#: engine, a full 64-row tile
GEMV_BENCH_MS = (1, 5, 8, 64)


def bench_gemv(P, card, gen):
    """B1 (W4 g128) at GEMV_BENCH_MS on the four decoder linears, B3.v3 and
    B3.s4 at M = 1 and B3.s8 at M = 8 on the W·A8 paths' o, qkv, gate-up,
    down and the heads; four weight copies cycling through the L2 (two for
    the heads), beside the bound and one library call on the same inputs:
    `torch.matmul` on the pre-dequantized bf16 weight, `torch._int_mm` on
    the s8 codes where it takes the shape (M > 16)."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq
    from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa

    for label, (k, n) in LINEAR_SHAPES.items():
        qts = rand_weights(P, k, n, 4, gen)
        wd = [fq.dequant_bf16(qt) for qt in qts]
        for m in GEMV_BENCH_MS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            ms = time_ms(lambda i: fq.qmm_gemv(x, qts[i % 4], torch.bfloat16), 100)
            lib_ms = time_ms(lambda i: torch.matmul(x, wd[i % 4]), 100)
            b_ms, by = bound_ms(k * n // 2 + 2 * (k // GS) * n * 4 + m * k * 2 + m * n * 2,
                                2.0 * m * k * n, BF16_FLOPS)
            log(f"kernel bench: B1 {label} x[{m},{k}] W4g128[{k},{n}]: {ms:.4f} ms, "
                f"torch.matmul bf16 {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by})  [{card}]")
        del qts, wd
    for label, (k, n) in list(B3_SHAPES.items()) + [("head", HEAD_SHAPE)]:
        forms = head_forms(P, gen) if label == "head" else b3_forms(P, k, n, 4, gen)
        for key, m in (("B3.v3", 1), ("B3.s4", 1), ("B3.s8", 8)):
            if key not in forms:
                continue
            ws = forms[key] if isinstance(forms[key], list) else [forms[key]]
            wd = [b3_dequant_bf16(w, k) for w in ws[:2]]
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            xq, s_x = qa.quantize_activations_s8(x)
            ms = time_ms(lambda i: b3_call(key, ws[i % len(ws)], xq, s_x, torch.bfloat16), 100)
            lib_ms = time_ms(lambda i: torch.matmul(x, wd[i % len(wd)]), 100)
            b_ms, by = bound_ms(b3_bytes(ws[0], m, k), 2.0 * m * k * n, INT8_OPS)
            log(f"kernel bench: {key} {label} x[{m},{k}] {ws[0][1]}[{k},{n}]: {ms:.4f} ms, "
                f"torch.matmul bf16 {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by})  [{card}]")
            del wd
        del forms
        torch.cuda.empty_cache()


def serve_profile(P, card):
    """Device time by kernel of one 8-slot serving window: the pallas engine
    (synthetic W4 g128) on the int8 and the fp cache, and fused a8 serving
    (per-column s8, s8 head)."""
    import torch

    cfg = P.LLAMA3_8B
    reqs = serve_requests(16, cfg.vocab_size)
    params = build_params(P)
    profile_serving(P, params, cfg, reqs, 16, card, bits=(8, False))
    del params
    torch.cuda.empty_cache()
    params = P.init_quantized_params(cfg, P.QuantSpec(n_bits=4, group_size=GS), seed=SEED,
                                     pack=False, percol_s8=True, head_s8=True)
    with P.backend("a8"):
        profile_serving(P, params, cfg, reqs, 16, card, bits=(8,), fuse=True)


#: (label, K, N) and M of the B3 tiled-form bench: the W·A8 paths' fused
#: gate-up, o and down at a 128-token prefill, the engine's bucket-64
#: prefill (512 rows) and a 2,048-token prefill
B3_BENCH_SHAPES = (("gateup", 4096, 28672), ("o", 4096, 4096), ("down", 14336, 4096))
B3_BENCH_MS = (128, 512, 2048)


def bench_b3_gemm(P, card, gen):
    """B3's tiled form: s4 (W4 g128) and per-column s8 at B3_BENCH_SHAPES,
    two weight copies cycling, beside bf16 `torch.matmul` on the same
    weights pre-dequantized; device time by the profiler."""
    import torch
    from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa

    for label, k, n in B3_BENCH_SHAPES:
        forms = b3_forms(P, k, n, 2, gen)
        for key in ("B3.s4", "B3.s8"):
            ws = forms[key]
            wd = [b3_dequant_bf16(w, k) for w in ws]
            for m in B3_BENCH_MS:
                x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
                xq, s_x = qa.quantize_activations_s8(x)
                ms = time_ms(lambda i: qa.a8_gemm(xq, s_x, *ws[i % 2], torch.bfloat16), 50)
                lib_ms = time_ms(lambda i: torch.matmul(x, wd[i % 2]), 50)
                b_ms, by = bound_ms(b3_bytes(ws[0], m, k), 2.0 * m * k * n, INT8_OPS)
                log(f"kernel bench: B3.gemm {ws[0][1]} {label} x[{m},{k}] [{k},{n}]: {ms:.4f} ms, "
                    f"torch.matmul bf16 {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by})  [{card}]")
            del wd
        del forms
        torch.cuda.empty_cache()


#: S of the B7 bench (B = 1, H = 32, G = 8, D = 128: Llama-3-8B)
B7_BENCH_S = (128, 512, 2048, 8192)


def b7_inputs(gen, s, b=1, h=32, g=8, d=128):
    import torch

    return [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            for shape in ((b, s, h, d), (b, s, g, d), (b, s, g, d))]


def bench_b7(card, gen):
    """B7 at B7_BENCH_S beside SDPA (causal, `enable_gqa`, [B, H, S, D]
    operands made contiguous beforehand); device time by the profiler."""
    import torch.nn.functional as F
    from llama3_quantization_tpu_torch.ops import flash_attention as fa

    for s in B7_BENCH_S:
        q, k, v = b7_inputs(gen, s)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = time_ms(lambda i: fa.flash_attention_cuda(q, k, v), 20)
        lib_ms = time_ms(lambda i: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True), 20)
        b_ms, by = bound_ms(2 * s * 128 * (32 + 2 * 8 + 32), 4.0 * 32 * 128 * s * (s + 1) / 2,
                            BF16_FLOPS)
        log(f"kernel bench: B7 B=1 S={s} H=32 G=8 D=128: {ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({by})  [{card}]")


def prefill_bench(P, card):
    """`kernel_bench`, then B2's device time at M = 128, 512 and 2048 on
    every decoder linear shape, and `forward_logits` on [1, 512] and
    [1, 2048] tokens of the synthetic Llama-3-8B W4 g128 under the pallas
    backend (B2, B7) and under the W·A8 backends (B3's tiled form, B7): s4
    (fused, s4 head) and a8 (fused per-column s8, s8 head). Run it from two
    checkouts in one call to compare them."""
    import torch
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    kernel_bench(P, card, gen)
    for label, (k, n) in LINEAR_SHAPES.items():
        qts = rand_weights(P, k, n, 4, gen)
        for m in (128, 512, 2048):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            ms = time_ms(lambda i: fq.qmm_gemm(x, qts[i % 4], torch.bfloat16), 50)
            log(f"prefill bench: B2 {label} M={m}: {ms:.4f} ms device time  [{card}]")
        del qts
    cfg = P.LLAMA3_8B
    spec = P.QuantSpec(n_bits=4, group_size=GS)
    # the pallas model (B2 + B7), then the W·A8 prefills (B3's tiled form +
    # B7): the s4 model of the decode headline, fused per-column s8 under a8
    for label, backend, build in (
            ("pallas", "pallas", lambda: build_params(P)),
            ("s4, fused, s4 head", "s4", lambda: P.fuse_for_decode(P.init_quantized_params(
                cfg, spec, seed=SEED, head_s4=True), cfg)),
            ("a8, fused per-column s8, s8 head", "a8", lambda: P.fuse_for_decode(
                P.init_quantized_params(cfg, spec, seed=SEED, pack=False, percol_s8=True,
                                        head_s8=True), cfg))):
        params = build()
        with P.backend(backend):
            for s in (512, 2048):
                toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device="cuda")
                ms = time_ms(lambda i: P.forward_logits(params, toks, cfg), 3, warmup=1)
                _, dt = timed(lambda: P.forward_logits(params, toks, cfg))
                log(f"prefill bench: forward_logits [1, {s}] ({label}): {ms:.3f} ms device time "
                    f"({s / ms * 1e3:.0f} tok/s), {dt * 1e3:.3f} ms host clock  [{card}]")
        del params
        torch.cuda.empty_cache()


def add_row(card, launches_total):
    """The kernels line's row maker: one row, logged beside the card."""
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

    return add


def time_by_kernel(fn, iters: int, names, warmup: int = 2):
    """Mean device ms of one call of `fn` spent in the kernels whose names
    contain each of `names` (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out = {n: sum(e.device_time_total for e in evs if n in e.key) / iters / 1e3 for n in names}
    if not all(v > 0 for v in out.values()):
        raise RuntimeError(f"the profiler saw no device time for {names}: {[e.key for e in evs]}")
    return out


def b7_grad_times(gen):
    """B7.stats, B7.dkv and B7.dq at OmniQuant's shape (`OMNI_ATTN`: B = 2,
    S = 2048, H = 32, G = 8, D = 128, bf16 causal): each kernel's device
    time by name (torch.profiler), SDPA's (causal, `enable_gqa`) forward and
    its backward alone (autograd of a kept graph, the forward excluded), the
    inputs, and the bounds' bytes and FLOPs: each input read once and each
    output written once; 2 * D FLOPs per causal (q, k) pair for each
    product, 2 in the forward, 4 in B7.dkv (q k^T, do v^T, p^T do, ds^T q)
    and 3 in B7.dq (q k^T, do v^T, ds k)."""
    import torch
    import torch.nn.functional as F
    from llama3_quantization_tpu_torch.ops import flash_attention as fa

    b, s, h, g, d = OMNI_ATTN
    q, k, v = b7_inputs(gen, s, b, h, g, d)
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    o, m, l = fa.flash_attention_stats_cuda(q, k, v)
    pairs = b * h * s * (s + 1) / 2
    io = 2 * b * s * d * (2 * h + 2 * g)  # q, k, v, do (or o) in bf16
    out = {"inputs": (q, k, v, o, do, m, l)}
    out["stats"] = time_by_kernel(lambda: fa.flash_attention_stats_cuda(q, k, v), 20,
                                  ["flash_fwd_kernel"])["flash_fwd_kernel"]
    bwd = time_by_kernel(lambda: fa.flash_attention_bwd_cuda(q, k, v, o, do, m, l), 10,
                         ["flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"])
    out["dkv"], out["dq"] = bwd["flash_bwd_dkv_kernel"], bwd["flash_bwd_dq_kernel"]
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out["lib_fwd"] = time_ms(lambda i: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True), 20)
    leaves = [x.detach().clone().requires_grad_(True) for x in (qh, kh, vh)]
    res = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    doh = do.transpose(1, 2).contiguous()
    out["lib_bwd"] = time_ms(lambda i: torch.autograd.grad(res, leaves, doh, retain_graph=True), 10)
    out["bytes"] = {"stats": io + 8 * b * h * s, "dkv": io + 12 * b * h * s + 4 * b * s * g * d,
                    "dq": io + 12 * b * h * s + 2 * b * s * h * d}
    out["flops"] = {"stats": 4 * d * pairs, "dkv": 8 * d * pairs, "dq": 6 * d * pairs}
    return out


def bench_b7_grad(card, gen):
    """`b7_grad_times` logged beside the bounds and SDPA (the quick parent
    against tree comparison of B7's gradient kernels)."""
    t = b7_grad_times(gen)
    label = "B={} S={} H={} G={} D={}".format(*OMNI_ATTN)
    for key, name, lib in (("stats", "B7.stats", "lib_fwd"), ("dkv", "B7.dkv", "lib_bwd"),
                           ("dq", "B7.dq", "lib_bwd")):
        b_ms, by = bound_ms(t["bytes"][key], t["flops"][key], BF16_FLOPS)
        sdpa = "SDPA forward" if key == "stats" else "SDPA backward"
        log(f"kernel bench: {name} {label} bf16 causal: {t[key]:.4f} ms, bound {b_ms:.4f} ms "
            f"({by}, {b_ms / t[key]:.1%} of it), {sdpa} {t[lib]:.4f} ms  [{card}]")


def time_b7_grad(card, launches_total, errs, gen, add):
    """The kernels line's rows of B7.stats, B7.dkv and B7.dq: `b7_grad_times`
    and the plain versions' times (the plain backward computes dq, dk and dv
    in one call: its time stands in both rows); SDPA's forward is the
    library of B7.stats, its backward alone that of both backward rows."""
    from llama3_quantization_tpu_torch.ops import flash_attention as fa

    t = b7_grad_times(gen)
    q, k, v, o, do, m, l = t["inputs"]
    plain_fwd = time_ms(lambda i: fa.attention_stats_plain(q, k, v), 3, warmup=1)
    plain_bwd = time_ms(lambda i: fa.flash_attention_bwd_plain(q, k, v, o, do, m, l), 2, warmup=1)
    label = "B={} S={} H={} G={} D={}".format(*OMNI_ATTN)
    shape = f"{label} bf16 causal (OmniQuant's block training at Llama-3-8B width)"
    src = "llama3_quantization_tpu_torch/csrc/"
    lib = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    dkv_err = max(v_ for k_, v_ in errs.get("B7.dkv", {}).items() if k_.startswith(label))
    dq_err = max(v_ for k_, v_ in errs.get("B7.dq", {}).items() if k_.startswith(label))
    return [
        add("B7.stats", "flash_attn_fwd with m, l", src + "flash_attention.cu", lib + ":758",
            shape + " (library: SDPA forward)", t["stats"], plain_fwd, t["bytes"]["stats"],
            t["flops"]["stats"], BF16_FLOPS, t["lib_fwd"], errs["B7.stats"][label]),
        add("B7.dkv", "flash_attn_bwd_dkv", src + "flash_attention_bwd.cu", lib + ":796",
            shape + " (plain: the whole backward; library: SDPA backward)", t["dkv"], plain_bwd,
            t["bytes"]["dkv"], t["flops"]["dkv"], BF16_FLOPS, t["lib_bwd"], dkv_err),
        add("B7.dq", "flash_attn_bwd_dq", src + "flash_attention_bwd.cu", lib + ":1146",
            shape + " (plain: the whole backward; library: SDPA backward)", t["dq"], plain_bwd,
            t["bytes"]["dq"], t["flops"]["dq"], BF16_FLOPS, t["lib_bwd"], dq_err),
    ]


def time_kernels(P, card, launches_total, errs, probes_only=False):
    """Per-kernel ms beside plain ms, bound and library yardstick (only the
    weight-stream probes' with `probes_only`)."""
    import torch
    import torch.nn.functional as F
    from llama3_quantization_tpu_torch.ops import decode_attention as da
    from llama3_quantization_tpu_torch.ops import flash_attention as fa
    from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    add = add_row(card, launches_total)

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
            ("B1", 5, fq.qmm_gemv, fq.qmm_gemv_plain, "qmm_gemv M=5"),
            ("B1", 8, fq.qmm_gemv, fq.qmm_gemv_plain, "qmm_gemv M=8"),
            ("B1", 64, fq.qmm_gemv, fq.qmm_gemv_plain, "qmm_gemv M=64"),
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

    form_rows = {}
    for key, b, t, ms, plain_ms, nbytes, ops, shape in time_b5(P, gen, plain=True):
        form_rows.setdefault(key, []).append(add(
            key, "decode_s8" + key[2:].replace(".", "_"),
            "llama3_quantization_tpu_torch/csrc/decode_attention.cu",
            "llama3_quantization_tpu/ops/decode_attention.py:274", shape, ms, plain_ms, nbytes,
            ops, INT8_OPS, None, errs[key][f"B={b} T={t}"]))

    # B6 at the fp paths' shapes: stacked at B=1 (decode), T=512 and 2048,
    # per layer at B=8 (the engine), T=512; 32 / 8 layers of cache (64 MB
    # and up) cycle through so that each call reads its layer cold
    g, rep, d = 8, 4, 128
    b6_rows = []
    for b, t, stacked, ms, plain_ms, lib_ms in time_b6(gen, plain=True):
        nbytes = 2 * b * g * t * d * 2 + 2 * b * g * rep * d * 2 + b * t * 4
        b6_rows.append(add(
            "B6", "decode_fp" + ("" if stacked else " per-layer"),
            "llama3_quantization_tpu_torch/csrc/decode_fp.cu",
            "llama3_quantization_tpu/ops/decode_attention.py:" + ("379" if stacked else "37"),
            f"B={b} G={g} rep={rep} D={d} T={t} bf16 {'stacked' if stacked else 'per-layer'} "
            f"(library: SDPA, enable_gqa, float mask)", ms, plain_ms, nbytes,
            4.0 * b * g * rep * t * d, BF16_FLOPS, lib_ms, errs["B6"][f"B={b} T={t}"]))

    b7_rows = []
    for s in (128, 2048):
        q, k, v = b7_inputs(gen, s)
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
    b7_rows += time_b7_grad(card, launches_total, errs, gen, add)
    b3_rows = time_b3(P, gen, add, errs)
    w3_rows = time_b2_w3(P, gen, add, errs)
    # one row per kernel form in the summary line (B1 at both of its path
    # instantiations, M=1 and M=8; B6 stacked at B=1 and per layer at B=8),
    # at the main path's heaviest shape (B1/B2: gate/up; B3: fused gate-up)
    # or its own length (B5 forms and B6: T=512, B7: S=128); the lines above
    # hold the other shapes and M. The B1 rows share B1's one count, the B6
    # rows B6's.
    probe_rows = time_probes(P, card, launches_total, errs, add)
    qmm_rows = {name: rows_ for name, rows_ in qmm_rows.items()
                if name in ("qmm_gemv", "qmm_gemv M=8", "qmm_gemm")}
    return ([rows_[2] for rows_ in qmm_rows.values()] + [rows_[0] for rows_ in form_rows.values()]
            + [b6_rows[0], b6_rows[2], b7_rows[0]] + b7_rows[2:] + b3_rows + w3_rows
            + probe_rows)


def time_b5(P, gen, plain=False):
    """Every B5 form at its path's batch (B5: batch-1 decode; the others:
    the 8-slot engine), G=8, rep=4, D=128, T = 512 and 2048, the output
    dtype its path asks for; enough layers of cache (32 MB and up) cycle
    through that each call reads its layer cold. Yields (key, B, T, kernel
    ms, plain ms or None, bytes and operations of the bound, shape)."""
    import torch
    from llama3_quantization_tpu_torch.ops import decode_attention as da

    g, rep, d = 8, 4, 128
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
            plain_ms = time_ms(lambda i: call(da.decode_s8_plain, i), 10) if plain else None
            code_bytes = d // 2 if int4 else d
            nbytes = (2 * b * g * t * (code_bytes + 4) + b * g * rep * d * 2 + b * t * 4
                      + b * g * rep * d * (4 if stats else 2) + (2 * b * g * rep * 4 if stats else 0))
            shape = (f"B={b} G={g} rep={rep} D={d} T={t} {'int4' if int4 else 'int8'}"
                     f"{' stats' if stats else ''}")
            yield key, b, t, ms, plain_ms, nbytes, 4.0 * b * g * rep * t * d, shape
            del kq, ks, vq, vs


#: (B, T, layers of cache, stacked) of the B6 timings: batch-1 decode at T
#: = 512 and 2048, the 8-slot engine per layer at T = 512; 32 / 8 layers of
#: cache (64 MB and up) cycle through so that each call reads its layer cold
B6_TIMED = ((1, 512, 32, True), (1, 2048, 32, True), (8, 512, 8, False))


def graph_ms(fn, calls: int, steps: int = 10) -> float:
    """Milliseconds per call of `fn(i)`, i over `calls` inputs, `steps`
    rounds captured in one CUDA graph and replayed under CUDA events: the
    wall time of back-to-back calls on the card, gaps between launches
    included. B6 (three launches per call) and its yardstick are timed this
    way: their cost includes the gaps between launches, which the
    profiler's per-kernel durations leave out."""
    import torch
    from llama3_quantization_tpu_torch.microbench._timing import time_calls

    return time_calls(fn, [(i,) for i in range(calls)], steps, torch.device("cuda"),
                      replays=3) * 1e3


def time_b6(gen, plain=False):
    """(B, T, stacked, kernel ms, plain ms or None, SDPA ms) at B6_TIMED,
    G=8, rep=4, D=128, bf16, the decode path's mask; the kernel and SDPA
    by `graph_ms`, the plain version by the profiler."""
    import torch
    import torch.nn.functional as F
    from llama3_quantization_tpu_torch.ops import decode_attention as da

    g, rep, d, out = 8, 4, 128, []
    for b, t, layers, stacked in B6_TIMED:
        bt = 1024 if t % 1024 == 0 else 512
        k = torch.randn((layers, b, g, t, d), generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn((layers, b, g, t, d), generator=gen, device="cuda").to(torch.bfloat16)
        q = torch.randn((b, 1, g * rep, d), generator=gen, device="cuda").to(torch.bfloat16)
        mask = decode_mask(b, t)
        qh, amask = q.reshape(b, g * rep, 1, d), mask[:, None, None, :]
        ms = graph_ms(lambda i: da.decode_fp(q, k[i], v[i], mask, bt), layers)
        plain_ms = time_ms(lambda i: da.decode_fp_plain(q, k[i % layers], v[i % layers], mask,
                                                        bt), 10) if plain else None
        lib_ms = graph_ms(lambda i: F.scaled_dot_product_attention(
            qh, k[i], v[i], attn_mask=amask, enable_gqa=True), layers)
        out.append((b, t, stacked, ms, plain_ms, lib_ms))
        del k, v
    return out


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
                    help="only --kernel-bench, B2 at M = 128, 512, 2048 and forward_logits at "
                         "S = 512, 2048 under the pallas, s4 and a8 backends (run it from two "
                         "checkouts in one call to compare them)")
    ap.add_argument("--kernel-bench", nargs="*", choices=BENCH_GROUPS, metavar="GROUP",
                    help="only time the B5 forms at T = 512 and 2048 (b5), B2 W4/W3 gate/up at "
                         "M = 128, L2-warm and cold (b2), B6 beside SDPA (b6), B3's tiled form "
                         "(s4, per-column s8: gate-up, o, down at M = 128, 512, 2048) beside "
                         "torch.matmul (b3), B7 (S = 128 to 8192) beside SDPA (b7), B7.stats, "
                         "B7.dkv and B7.dq at OmniQuant's shape beside SDPA's forward and "
                         "backward (b7grad), and the GEMV forms (B1 at M = 1, 5, 8, 64; B3.v3 "
                         "and B3.s4 at M = 1, B3.s8 at M = 8) beside torch.matmul (gemv); the "
                         "GROUPs named, else all (run it from two checkouts in one call to "
                         "compare them)")
    ap.add_argument("--serve-profile", action="store_true",
                    help="only profile one 8-slot serving window by kernel: pallas on the int8 "
                         "and the fp cache, fused a8 (run it from two checkouts in one call to "
                         "compare them)")
    ap.add_argument("--decode-drift", action="store_true",
                    help="only run the full-depth decode through the B5 kernel forms, B6 and "
                         "through B3 (s4 backend) against their plain versions")
    ap.add_argument("--eval", action="store_true",
                    help="only build and check the kernels (the C2 shapes included), then the "
                         "study's golden rows and the full-width eval phase")
    ap.add_argument("--quantize", action="store_true",
                    help="only build and check the kernels, then the calibration quantizers at "
                         "Llama-3-8B width (GPTQ, OmniQuant through B7's gradient) and the "
                         "study's golden rows")
    ap.add_argument("--cli", action="store_true",
                    help="only build and check the kernels (HQQ weights on B1 and B2 among "
                         "them), then phase 10 (the CLI at full Llama-3-8B width and depth with "
                         "HQQ, a checkpoint round trip, HQQ on the decode paths, IR-QLoRA) and "
                         "the study's golden rows")
    ap.add_argument("--harness", action="store_true",
                    help="only build and check the kernels, then phase 11 (the rest of the "
                         "harness, decontamination, UPR, STS and hf-causal at full Llama-3-8B "
                         "width and depth)")
    ap.add_argument("--harness-seed", type=int, default=0, metavar="N",
                    help="with --harness: make phase 11's weights and documents from seed N "
                         "(default 0, the full run's)")
    ap.add_argument("--archs", action="store_true",
                    help="only build and check the kernels (phase 12's shapes among them), then "
                         "phase 12 (OPT-125M, Falcon-7B and Mixtral-8x7B at full width and "
                         "depth)")
    ap.add_argument("--moe", action="store_true",
                    help="only phase 12's Mixtral-8x7B and its MoE dispatches timed by rows "
                         "(no kernel checks)")
    ap.add_argument("--seq2seq", action="store_true",
                    help="only build and check the kernels (T0-3B's shapes among them), then "
                         "phase 13 (the T5 trunk at T0-3B width and depth, its GPTQ, LM, CLI "
                         "and profile)")
    ap.add_argument("--parallel", action="store_true",
                    help="only build and check the kernels (phase 14's shard shapes among "
                         "them), then phase 14 (parallelism on a world of one NCCL rank at "
                         "Llama-3-8B width)")
    ap.add_argument("--multi-rank", action="store_true",
                    help="only build the kernels, then the parallel paths across every card of "
                         "the machine, one NCCL rank a card, against one replica (needs 2 or "
                         "more cards)")
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
    if os.environ.get("L3Q_ABLATE"):
        log(f"L3Q_ABLATE={os.environ['L3Q_ABLATE']}: kernels built with phases removed, "
            "their results are wrong")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.time()
    reports = _build.build_all()
    log(f"kernels built in {time.time() - t0:.1f} s")
    for name, rep in reports.items():
        entry = ""
        for line in rep.splitlines():
            fn = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
            if fn:
                entry = fn.group(1)
            elif "Used" in line or "spill" in line:
                log(f"  ptxas {name} {entry}: {line.strip()}")
    if args.prefill_bench:
        prefill_bench(P, card)
        return 0
    if args.kernel_bench is not None:
        kernel_bench(P, card, torch.Generator(device="cuda").manual_seed(SEED + 6),
                     args.kernel_bench or BENCH_GROUPS)
        return 0
    if args.serve_profile:
        serve_profile(P, card)
        return 0
    if args.multi_rank:
        total = run_multi_rank(card)
        log(f"launches on rank 0: {json.dumps(total)}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if args.decode_drift:
        params = build_rtn_params(P)
        decode_drift(P, params, P.LLAMA3_8B, card)
        decode_drift_b3(P, params, P.LLAMA3_8B, card)
        return 0

    if args.moe:
        total = sum_counts(drive_mixtral(P, card, torch.Generator(device="cuda").manual_seed(
            SEED + 16), timing=True))
        log(f"launches: {json.dumps(total)}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
        }}), flush=True)
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
    check_qmatmul_hqq(P, gen, errs)
    check_b1_forms(P, gen)
    check_b1_batch_invariance(P, gen)
    check_b2_w3(P, gen, errs)
    check_b2_batch_invariance(P, gen)
    check_b3(P, gen, errs)
    check_decode_forms(P, gen, errs)
    check_b5_split(P, gen)
    check_fp_decode(P, gen, errs)
    check_flash(P, gen, errs)
    check_flash_bwd(P, gen, errs)
    check_window_merge(P, gen)
    check_xla_route(P, gen)
    check_probes(P, gen, errs)
    check_c2(P)
    check_arch_kernels(P, gen, errs)
    check_t5_kernels(P, gen, errs)
    check_parallel_kernels(P, gen, errs)
    torch.cuda.synchronize()
    if args.kernels_only:
        log("kernel checks passed")
        return 0
    if args.quantize:
        paths = [drive_quantize(P, card), drive_golden(P, card)]
        total = {key: sum(p[key] for p in paths) for key in paths[0]}
        log(f"launches: {json.dumps(total)}")
        rows = time_b7_grad(card, total, errs, torch.Generator(device="cuda").manual_seed(SEED + 2),
                            add_row(card, total))
        print(json.dumps({"kernels": rows}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
        }}), flush=True)
        return 0
    if args.cli:
        paths = [drive_cli(P, card), drive_golden(P, card)]
        total = {key: sum(p[key] for p in paths) for key in paths[0]}
        log(f"launches: {json.dumps(total)}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
        }}), flush=True)
        return 0
    if args.archs:
        total = drive_archs(P, card)
        log(f"launches: {json.dumps(total)}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
        }}), flush=True)
        return 0
    if args.seq2seq:
        total = drive_seq2seq(P, card)
        log(f"launches: {json.dumps(total)}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
        }}), flush=True)
        return 0
    if args.parallel:
        total = drive_parallel(P, card)
        log(f"launches: {json.dumps(total)}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
        }}), flush=True)
        return 0
    if args.harness:
        s = args.harness_seed
        total = drive_harness(P, build_rtn_params(P, s), card, s)
        log(f"launches: {json.dumps(total)}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
        }}), flush=True)
        return 0
    if args.eval:
        golden = drive_golden(P, card)
        params = build_rtn_params(P)
        total = drive_eval(P, params, card)
        log(f"launches: golden rows {json.dumps(golden)}, eval {json.dumps(total)}")
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
    paths.append(drive_golden(P, card))
    paths.append(drive_quantize(P, card))
    paths.append(drive_cli(P, card))
    params = build_rtn_params(P)
    paths.append(drive_rtn_checks(P, params, card))
    paths.append(drive_routes(P, params, card))
    paths.append(drive_rtn_fp(P, params, card))
    paths.append(drive_rtn_a8(P, params, card))
    paths.append(drive_eval(P, params, card))
    paths.append(drive_harness(P, params, card))
    del params
    torch.cuda.empty_cache()
    paths.append(drive_archs(P, card))
    paths.append(drive_seq2seq(P, card))
    paths.append(drive_parallel(P, card))
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
