"""Packed-W4 unpack formulations for the decode matvec on the card (port of
`scripts/microbench_unpack.py`):

  a8pc  per-column s8, one full-K dot (the a8 backend, B3.s8)
  v2    the port's B1 (`fused_dequant_matmul(version=2)`)
  v3    the port's B3 on packed u4 codes (`version=3`)
  u8_dot2, u8_cat, u8_bf16   the three u8-native formulations (B10)

First the numerics of the three u8 variants against the fake-quant oracle
(`quantize_rtn` codes dequantized, an fp32 matmul), then each path timed
over two weight copies (their bytes exceed the H100's 50 MB L2) inside one
CUDA graph of `reps` rounds, the best of five replays.

Usage: python -m llama3_quantization_tpu_torch.microbench.unpack
       [K] [N] [reps] [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from ..ops.a8_matmul import a8_matmul, quantize_activations_s8
from ..ops.fused_qmatmul import fused_dequant_matmul
from ..ops.qmm_u8 import BM, u8_qmm
from ..quant.qtensor import dequantize, quantize_rtn
from ..quant.quantizer import QuantSpec
from ..quant.serving import recode_s8_percol
from ._timing import GS, generator, header, parse, share, time_calls

COPIES = 2


def main(argv=None):
    a, _, dev, _ = parse(argv, "unpack", [("K", 4096), ("N", 14336), ("reps", 100)])
    k, n, reps = a["K"], a["N"], a["reps"]
    gen = generator(dev)
    spec = QuantSpec(n_bits=4, group_size=GS)
    x = torch.randn((1, k), generator=gen, device=dev).to(torch.bfloat16)
    xq1, sx1 = quantize_activations_s8(x)
    xq = xq1.expand(BM, k).contiguous()
    copies = []
    for _ in range(COPIES):
        w = torch.randn((k, n), generator=gen, device=dev) * 0.02
        qt, qt_packed = quantize_rtn(w, spec), quantize_rtn(w, spec, pack=True)
        copies.append((qt, qt_packed, recode_s8_percol(qt)))
        del w
    qt, qt_packed, _ = copies[0]
    pk_bytes = k // 2 * n

    header(dev)
    print(f"shapes: K={k} N={n} packed={pk_bytes / 1e6:.1f} MB gs={GS}")
    oracle = (xq1.float() @ dequantize(qt).float()) * sx1
    errs = {}
    for v in ("dot2", "cat", "bf16"):
        got = u8_qmm(xq, qt_packed.data, qt_packed.scale, qt_packed.zero, v)[0:1] * sx1
        errs[v] = float((got - oracle).abs().max() / (oracle.abs().max() + 1e-9))
        print(f"  numerics {v}: rel err {errs[v]:.2e}")

    paths = {
        "a8pc": (lambda pc: a8_matmul(x, pc), [(c[2],) for c in copies], k * n),
        "v2": (lambda q: fused_dequant_matmul(x, q, version=2), [(c[1],) for c in copies], pk_bytes),
        "v3": (lambda q: fused_dequant_matmul(x, q, version=3), [(c[1],) for c in copies], pk_bytes),
    }
    for v in ("dot2", "cat", "bf16"):
        paths[f"u8_{v}"] = (lambda q, v=v: u8_qmm(xq, q.data, q.scale, q.zero, v),
                            [(c[1],) for c in copies], pk_bytes)
    out = {}
    for name, (fn, sets, _) in paths.items():
        out[name] = time_calls(fn, sets, reps, dev, replays=5)
    print(f"\n{'path':>10} {'us':>9} {'GB/s packed':>12}")
    for name, (_, _, nbytes) in paths.items():
        t = out[name]
        print(f"{name:>10} {t * 1e6:9.1f} {nbytes / t / 1e9:12.1f}{share(nbytes, t, dev)}")
    out["rel_err"] = errs
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
