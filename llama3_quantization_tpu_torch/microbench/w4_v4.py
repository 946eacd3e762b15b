"""The v4 packed-W4 matvec on the card (port of `scripts/microbench_w4_v4.py`):
nibble-packed int4 weight bytes, block-diagonal s4 activations (x = 16 xh +
xl), group scales on the s32 partials (B9.v4), the zero-point correction a
small `[1, G] @ [G, N]` fp32 matmul outside the kernel. Checks the result
against the script's own oracle (an fp32 matmul on the dequantized weight),
then times L = 16 column-rolled weight copies inside one CUDA graph.

Usage: python -m llama3_quantization_tpu_torch.microbench.w4_v4
       [K] [N] [BK] [BN] [--device cpu] [--steps N]
"""

from __future__ import annotations

import sys

import torch

from ..ops.w4_bd import w4_bd
from ._timing import GS, generator, header, parse, rand_scales, share, time_calls

L = 16


def split_s8_to_s4(xq32: torch.Tensor):
    """x = 16 a + b with a, b in [-8, 7]; requires x in [-128, 119]."""
    b = ((xq32 & 15) ^ 8) - 8
    a = (xq32 - b) >> 4
    return a, b


def pack_nibbles(codes_signed: torch.Tensor) -> torch.Tensor:
    """int4 values `[K, N]` in [-8, 7] -> packed int8 `[K/2, N]`: byte r =
    (c[2r] & 15) | (c[2r+1] << 4), the TPU's int8 -> int4 bitcast."""
    c = codes_signed.to(torch.int16)
    return ((c[0::2] & 15) | ((c[1::2] & 15) << 4)).to(torch.uint8).view(torch.int8)


def v4_matvec(xq, packed, scale, zscale, bk: int, bn: int):
    """xq s8 `[1, K]`; packed `[K/2, N]`; scale, zscale f32 `[K/128, N]`."""
    g = xq.shape[1] // GS
    x32 = torch.clamp(xq.to(torch.int32), max=119)
    xh, xl = split_s8_to_s4(x32)
    xsum = x32.reshape(1, g, GS).sum(dim=2).float()
    corr = xsum @ zscale  # the zero-point correction, outside the kernel
    return w4_bd(xh.to(torch.int8), xl.to(torch.int8), scale, packed, bk) - corr


def main(argv=None):
    a, _, dev, steps = parse(argv, "w4_v4", [("K", 4096), ("N", 14336), ("BK", 2048),
                                            ("BN", 512)], steps=10)
    k, n, bk, bn = a["K"], a["N"], a["BK"], a["BN"]
    g = k // GS
    gen = generator(dev)
    codes = torch.randint(0, 16, (k, n), generator=gen, device=dev, dtype=torch.int16)
    zero = torch.randint(4, 12, (g, n), generator=gen, device=dev).float()
    scale = rand_scales(gen, (g, n), dev)
    xq = torch.randint(-120, 120, (1, k), generator=gen, device=dev, dtype=torch.int16).to(torch.int8)
    packed = pack_nibbles(codes - 8)
    zs = scale * (zero - 8.0)

    header(dev)
    grp = torch.arange(k, device=dev) // GS
    w = scale[grp] * (codes.float() - zero[grp])
    exp = xq.float() @ w
    got = v4_matvec(xq, packed, scale, zs, bk, bn)
    err = float((got - exp).abs().max() / (exp.abs().max() + 1e-9))
    print(f"correctness: max rel err {err:.2e}")
    del w, codes

    packs = [torch.roll(packed, i, dims=1) for i in range(L)]
    dt = time_calls(lambda p: v4_matvec(xq, p, scale, zs, bk, bn), [(p,) for p in packs], steps,
                    dev)
    pk, tot = k * n / 2, k * n / 2 + 2 * g * n * 4
    print(f"[{k}x{n}] bk={bk} bn={bn}: {dt * 1e6:.1f} us/call, {pk / dt / 1e9:.0f} GB/s packed bytes "
          f"({tot / dt / 1e9:.0f} incl scales){share(tot, dt, dev)}", flush=True)
    return {"v4": dt, "max_rel_err": err}


if __name__ == "__main__":
    main(sys.argv[1:])
