"""The weight-stream probes' plans (B9 `w4_bd.bd_plan`, B10
`qmm_u8.u8_plan`) and CPU walks of the order the kernels sum in.

The plans follow the shapes alone (B9: K, N, bk, streams; B10: K, N):
every call gives the same tiles, and the default shapes of the microbench
entry points get at least one block per H100 SM where the columns and the
split allow. B9's split covers every byte row of every K tile exactly once,
each stage inside one stream's share of the tile (and, for v4, inside one
group). The walks repeat the kernels' sums on the CPU at small seeded
shapes and with the default shapes' plans: B9's `bd_split_plain` (each
rank's stages of 16-byte-row units, the nibbles scaled by 16, the s32
partials added into the owner's P, the epilogue shifting the factor out)
equals `bd_plain` bit for bit for every form, and B10's `u8_split_plain`
(dot2 as two s32 chains, cat as one, the x sums by a ones operand, the
group terms in order) equals `u8_qmm_plain` bit for bit.
"""

import inspect

import numpy as np
import pytest
import torch

import llama3_quantization_tpu_torch as P
from llama3_quantization_tpu_torch.ops import qmm_u8, w4_bd

torch.set_num_threads(1)

GS = 128
#: (K, N, bk, form, streams, bn_t) of the microbench entry points' defaults
#: (bn_t: the tiled layout's tile width, 0 for row-major)
DEFAULTS = [(4096, 28672, 2048, "dot4", 1, 0), (4096, 28672, 2048, "noscale", 1, 0),
            (4096, 28672, 2048, "cast8", 1, 0), (4096, 28672, 2048, "multi", 1, 0),
            (4096, 28672, 2048, "multi", 2, 0), (4096, 28672, 2048, "multi", 4, 0),
            (4096, 28672, 2048, "v4", 1, 512), (4096, 14336, 2048, "v4", 1, 0)]
FORMS = [("v4", 1), ("dot4", 1), ("cast8", 1), ("noscale", 1), ("multi", 1), ("multi", 2),
         ("multi", 4)]


def _ints(rng, lo, hi, shape):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8))


def _operands(form, streams, k, n, bk, seed):
    """(rows, weights, scale) of a B9 form, made from a seed."""
    rng = np.random.default_rng(seed)
    g, gt = k // GS, bk // GS
    scale = torch.from_numpy((rng.random((g, n)) + 0.5).astype(np.float32) * 0.01)
    if form == "multi":
        ws = [_ints(rng, -128, 128, (k // 2 // streams, n)) for _ in range(streams)]
        rows = [_ints(rng, -8, 8, (2 * gt // streams, k // streams)) for _ in range(streams)]
        return rows, ws, None
    w = [_ints(rng, -128, 128, (k // 2, n))]
    if form == "v4":
        return [_ints(rng, -8, 8, (1, k)), _ints(rng, -8, 8, (1, k))], w, scale
    if form == "cast8":
        return [_ints(rng, -120, 120, (gt, k))], w, scale
    return [_ints(rng, -8, 8, (2 * gt, k))], w, (scale if form == "dot4" else None)


@pytest.mark.parametrize("k,n,bk,form,streams,bn_t", DEFAULTS)
def test_bd_plan_at_the_defaults(k, n, bk, form, streams, bn_t):
    """128-column blocks, 8 KB stages, a ring of 4; the K split only where
    the columns alone give fewer blocks than SMs (v4 at N = 14336)."""
    plan = w4_bd.bd_plan(k, n, bk, streams)
    assert plan == w4_bd.BdPlan(128, 2 if n == 14336 else 1, 64, 4)
    assert bn_t % plan.bn == 0  # a block's columns lie in one tile
    assert n // plan.bn * plan.ks >= w4_bd.MIN_BLOCKS


@pytest.mark.parametrize("form,streams", FORMS)
@pytest.mark.parametrize("k,n,bk", [(4096, 384, 256), (4096, 384, 2048), (1024, 256, 512),
                                    (4096, 28672, 2048), (14336, 4096, 2048)])
def test_bd_plan_covers_every_byte_row_once(form, streams, k, n, bk):
    plan = w4_bd.bd_plan(k, n, bk, streams)
    rows_s = bk // 2 // streams
    tr = bk // 2 // plan.ks
    assert plan.ks in (1, 2, 4, 8) and 16 <= plan.sr <= 64 and plan.ring >= 4
    assert plan.sr % 16 == 0 and tr % plan.sr == 0
    seen = np.zeros(bk // 2, dtype=np.int64)
    for q in range(plan.ks):
        for i in range(tr // plan.sr):
            v = q * tr + i * plan.sr
            assert v // rows_s == (v + plan.sr - 1) // rows_s  # one stream's rows
            if form == "v4":
                assert v // 64 == (v + plan.sr - 1) // 64  # one group's rows
            seen[v:v + plan.sr] += 1
    assert (seen == 1).all()
    blocks = n // plan.bn * plan.ks
    assert blocks >= w4_bd.MIN_BLOCKS or plan.ks == w4_bd.MAX_SPLIT or plan.sr == 16


def test_plans_depend_on_the_shapes_alone():
    """The plans take shapes only, and give the same answer whatever else
    changes (threads, default dtype)."""
    assert list(inspect.signature(w4_bd.bd_plan).parameters) == ["k", "n", "bk", "streams"]
    assert list(inspect.signature(qmm_u8.u8_plan).parameters) == ["k", "n"]
    first = [w4_bd.bd_plan(k, n, bk, s) for k, n, bk, _, s, _ in DEFAULTS]
    first.append(qmm_u8.u8_plan(4096, 14336))
    torch.set_num_threads(2)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        again = [w4_bd.bd_plan(k, n, bk, s) for k, n, bk, _, s, _ in DEFAULTS]
        again.append(qmm_u8.u8_plan(4096, 14336))
    finally:
        torch.set_default_dtype(old)
        torch.set_num_threads(1)
    assert first == again


@pytest.mark.parametrize("form,streams", FORMS)
@pytest.mark.parametrize("k,n,bk", [(1024, 256, 256), (1024, 256, 512), (4096, 384, 256)])
def test_bd_split_equals_plain(form, streams, k, n, bk):
    rows, ws, scale = _operands(form, streams, k, n, bk, seed=bk + streams)
    plan = w4_bd.bd_plan(k, n, bk, streams)
    got = w4_bd.bd_split_plain(form, rows, ws, scale, bk, plan)
    assert torch.equal(got, w4_bd.bd_plain(form, rows, ws, scale, bk))


@pytest.mark.parametrize("k,n,bk,form,streams,bn_t", DEFAULTS)
def test_bd_split_equals_plain_under_the_default_plans(k, n, bk, form, streams, bn_t):
    """The default shapes' plans (K and bk as the entry points, N cut to two
    blocks: the split runs along K, the columns only repeat it)."""
    plan = w4_bd.bd_plan(k, n, bk, streams)
    rows, ws, scale = _operands(form, streams, k, 256, bk, seed=7)
    got = w4_bd.bd_split_plain(form, rows, ws, scale, bk, plan)
    assert torch.equal(got, w4_bd.bd_plain(form, rows, ws, scale, bk))


def test_u8_plan_at_the_defaults():
    assert qmm_u8.u8_plan(4096, 14336) == qmm_u8.U8Plan(128, 8)
    assert qmm_u8.u8_plan(384, 448) == qmm_u8.U8Plan(128, 3)
    assert qmm_u8.u8_plan(128, 64).ring == 2


@pytest.mark.parametrize("variant", ["dot2", "cat"])
@pytest.mark.parametrize("k,n", [(1024, 448), (384, 448), (4096, 256)])
def test_u8_split_equals_plain(variant, k, n):
    """dot2 and cat in the kernel's order, bit-equal to the plain version
    (B3's `a8_plain` with s_x = 1) on RTN W4 g128 codes."""
    rng = np.random.default_rng(k + n)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    qt = P.quantize_rtn(w, P.QuantSpec(n_bits=4, group_size=GS), pack=True)
    xq = _ints(rng, -127, 128, (8, k))
    got = qmm_u8.u8_split_plain(xq, qt.data, qt.scale, qt.zero, variant)
    assert torch.equal(got, qmm_u8.u8_qmm_plain(xq, qt.data, qt.scale, qt.zero, variant))
