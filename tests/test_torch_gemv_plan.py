"""The GEMV forms' plans (B1 `fused_qmatmul.gemv_plan`, B3
`qmatmul_a8.gemv_plan`) and CPU walks of the order the kernels sum in.

The plans follow (K, N, gs, f) alone, never M: the wrappers pass the same
tiles, split, unit and run at every M <= 64. They cover every (byte row,
column) of the codes exactly once, each unit and run inside one group and
each split on whole runs, and give the card at least TARGET_BLOCKS blocks
where N allows. The walks repeat the kernels' order on the CPU at small
seeded shapes: B3's (no K split; exact s32 sums of each warp row's run
per round, folded stage by stage: s32 sums of a group added up, the fp32
group terms in group order) equals `a8_plain` bit for bit at every stage
size its launcher may pick; B1's (warp row r walks run r of
each round, one fp32 dot per group and its term after the row's last run
of the group, then warp rows and splits in order) stays within 1e-4 *
max|ref| of JAX's `_qmm_v2_kernel` in interpret mode (only the fp32
summation order differs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama3_quantization_tpu.ops.pallas_qmatmul import fused_dequant_matmul as j_fused
from llama3_quantization_tpu.quant import QuantSpec, quantize_rtn
import llama3_quantization_tpu_torch as tquant
from llama3_quantization_tpu_torch.convert import params_from_numpy
from llama3_quantization_tpu_torch.ops import _build
from llama3_quantization_tpu_torch.ops import fused_qmatmul as fq
from llama3_quantization_tpu_torch.ops import qmatmul_a8 as qa

torch.set_num_threads(1)

#: (K, N) of the Llama-3-8B decode linears, the W·A8 paths' fused q/k/v and
#: gate/up, and the lm_head
DECODE_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 6144),
                 (4096, 28672), (4096, 128256)]
#: values per byte of B1's layouts (2-bit, 4-bit, one code per byte)
B1_F = (4, 2, 1)
#: B3's layouts by values per byte
B3_F = {layout: spec[1] for layout, spec in qa.LAYOUTS.items()}


def _group_sizes(k):
    return (32, 64, 128, k)


def _units(k, f, unit):
    return k // f // unit


def _split(plan, k, f, q):
    """Units [u0, u1) of split q: whole runs."""
    runs = k // f // plan.unit // plan.uw
    return (q * runs // plan.ksplit * plan.uw, (q + 1) * runs // plan.ksplit * plan.uw)


def _check_cover(plan, k, n, gs, f):
    """Column tiles and splits cover every (byte row, column) once, each
    unit and run inside one group and each split on whole runs."""
    sub = gs // f
    assert sub % plan.unit == 0  # a unit never crosses a group
    ug = sub // plan.unit
    assert ug % plan.uw == 0  # nor does a run
    units = _units(k, f, plan.unit)
    assert units * plan.unit * f == k and units % plan.uw == 0
    seen = np.zeros(units, dtype=np.int64)
    for q in range(plan.ksplit):
        u0, u1 = _split(plan, k, f, q)
        assert plan.ksplit == 1 or (u1 - u0) // plan.uw >= plan.kw  # a run per warp row
        seen[u0:u1] += 1
    assert (seen == 1).all()
    cols = np.zeros(n, dtype=np.int64)
    for i in range(-(-n // plan.bn)):
        cols[i * plan.bn:(i + 1) * plan.bn] += 1
    assert (cols == 1).all()
    assert plan.bn in _build.GEMV_TILES and plan.kw * plan.bn == 128
    assert 1 <= plan.ksplit <= _build.GEMV_MAX_SPLIT
    assert plan.kw * plan.uw * plan.unit * plan.bn <= _build.GEMV_ROUND_CODES or plan.uw == 1
    assert plan.kw * plan.uw * plan.unit <= 256  # a round is one TMA box


def _check_blocks(plan, k, n, f, may_split):
    """With a K split (B1): TARGET_BLOCKS blocks, or the most the shape
    allows with tiles of 64 columns (64-byte code rows; narrower rows stream
    the codes at well under the HBM rate) and GEMV_MAX_SPLIT splits or as
    many as give each warp row of a 64-column tile a unit. Without one (B3):
    about a block per SM, tiles of 32 columns or more."""
    blocks = -(-n // plan.bn) * plan.ksplit
    if not may_split:
        assert plan.ksplit == 1 and plan.bn >= min(32, n)
        assert blocks >= min(qa.GEMV_MIN_TILES, -(-n // 32))
        return
    assert plan.bn >= 64 or n < 64
    splits = min(_build.GEMV_MAX_SPLIT, _units(k, f, plan.unit) // 2)
    most = -(-n // 64) * splits
    assert blocks >= min(_build.TARGET_BLOCKS, most), (plan, blocks, most)


@pytest.mark.parametrize("k,n", DECODE_SHAPES)
@pytest.mark.parametrize("f", B1_F)
def test_b1_plan_covers_and_fills(k, n, f):
    for gs in _group_sizes(k):
        if gs % 16 or (gs // f) % 8:
            with pytest.raises(ValueError):
                fq.gemv_plan(k, n, gs, f)
            continue
        plan = fq.gemv_plan(k, n, gs, f)
        assert plan.unit == (16 if (gs // f) % 16 == 0 else 8) and plan.unit * f % 16 == 0
        _check_cover(plan, k, n, gs, f)
        _check_blocks(plan, k, n, f, True)


@pytest.mark.parametrize("k,n", DECODE_SHAPES)
@pytest.mark.parametrize("layout", sorted(B3_F))
def test_b3_plan_covers_and_fills(k, n, layout):
    f = B3_F[layout]
    for gs in _group_sizes(k):
        plan = qa.gemv_plan(k, n, gs, f)
        assert plan.unit in (32, 16, 8) and plan.unit * f % 32 == 0
        _check_cover(plan, k, n, gs, f)
        _check_blocks(plan, k, n, f, False)  # one block folds every group of its columns


def test_plans_at_the_main_path_shapes():
    """The shapes the decode and serving steps run (W4 g128, per-column s8)."""
    assert fq.gemv_plan(4096, 14336, 128, 2) == (128, 3, 1, 16, 4)
    assert fq.gemv_plan(4096, 1024, 128, 2) == (64, 8, 2, 16, 4)
    assert fq.gemv_plan(14336, 4096, 128, 2) == (64, 5, 2, 16, 4)
    assert qa.gemv_plan(4096, 28672, 4096, 1) == (128, 1, 1, 32, 2)
    assert qa.gemv_plan(4096, 128256, 4096, 1) == (128, 1, 1, 32, 2)
    assert qa.gemv_plan(4096, 4096, 128, 2) == (32, 1, 4, 32, 2)


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers' launches recorded instead of run: (name, arguments)."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, args))
                return 0
            return call

    monkeypatch.setattr(fq, "_lib", Lib)
    monkeypatch.setattr(qa, "_lib", Lib)
    monkeypatch.setattr(qa, "_require_cuda", lambda xq: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    return calls


def test_wrappers_pass_one_plan_at_every_m(fake_launch):
    """B1 and B3's GEMV form launch once per call, with the same tiles, split
    and unit at M = 1 .. 64."""
    k, n, gs = 512, 192, 64
    qt = tquant.quantize_rtn(torch.randn(k, n), tquant.QuantSpec(n_bits=4, group_size=gs),
                             pack=True)
    s8 = tquant.recode_head_s8(torch.randn(k, n))
    for m in (1, 2, 5, 8, 16, 33, 64):
        fq.qmm_gemv(torch.randn(m, k), qt, torch.float32)
        xq, s_x = qa.quantize_activations_s8(torch.randn(m, k))
        qa.a8_gemv(xq, s_x, qt.data, "u4", qt.scale, qt.zero, gs, torch.float32, "B3.v3")
        qa.a8_gemv(xq, s_x, s8.data, "s8", s8.scale, None, k, torch.float32, "B3.s8")
    assert len(fake_launch) == 21
    b1 = {args[-5:-1] for name, args in fake_launch if name == "l3q_qmm_gemv"}
    p = fq.gemv_plan(k, n, gs, 2)
    assert b1 == {(p.bn, p.ksplit, p.unit, p.uw)}
    b3 = {args[-4:-1] for name, args in fake_launch if name == "l3q_a8_gemv"}
    p4, p8 = qa.gemv_plan(k, n, gs, 2), qa.gemv_plan(k, n, k, 1)
    assert b3 == {(p4.bn, p4.unit, p4.uw), (p8.bn, p8.unit, p8.uw)}


@pytest.mark.parametrize("change,match", [
    ({"gs": 8}, "group_size % 16"),          # B1 needs 16-row groups
    ({"n": 40}, "N % 16"),
    ({"m": 65}, "M <= 64"),
])
def test_b1_refuses_before_launch(fake_launch, change, match):
    args = {"k": 256, "n": 64, "gs": 64, "m": 4, **change}
    qt = tquant.quantize_rtn(torch.randn(args["k"], args["n"]),
                             tquant.QuantSpec(n_bits=4, group_size=args["gs"]), pack=True)
    with pytest.raises(ValueError, match=match):
        fq.qmm_gemv(torch.randn(args["m"], args["k"]), qt, torch.float32)
    assert fake_launch == []


# ------------------------------------------------------------- B3's walk ----
def _unit_ks(u, unit, gs, f):
    """The k values of unit u: its byte rows' every bit field."""
    sub = gs // f
    r = u * unit
    g, j0 = r // sub, r % sub
    return np.concatenate([g * gs + s * sub + j0 + np.arange(unit) for s in range(f)])


def _term(acc, g, d, xs, scale, zero, layout):
    """`group_term` (csrc/qmatmul_a8.cu) in float32, one rounding per op."""
    if layout == "u8":
        d = d + 128 * xs[:, None]
    t = d.astype(np.float32)
    if zero is not None:
        z = zero[g].astype(np.float32)
        t = t - xs[:, None].astype(np.float32) * z[None]
    return acc + t * scale[g][None]


def b3_walk(xq, s_x, data, layout, scale, zero, gs, rounds):
    """B3's GEMV form on the CPU in the kernel's order (see the note at the
    head of the GEMV section of csrc/qmatmul_a8.cu), `rounds` per stage."""
    m, k = xq.shape
    f = qa.LAYOUTS[layout][1]
    plan = qa.gemv_plan(k, data.shape[-1], gs, f)
    ug = gs // f // plan.unit
    units = k // f // plan.unit
    codes = qa.codes_of(data, layout, k, gs).numpy().astype(np.int64)
    if layout == "u8":  # the kernel's s8 operand c ^ 0x80 = c - 128; _term adds 128 * xsum back
        codes = codes - 128
    x = xq.numpy().astype(np.int64)
    scale = scale.numpy()
    zero = None if zero is None else zero.numpy()
    unit_ks = [_unit_ks(u, plan.unit, gs, f) for u in range(units)]
    dots = [x[:, ks] @ codes[ks] for ks in unit_ks]
    sums = [x[:, ks].sum(axis=1) for ks in unit_ks]
    ru = plan.kw * plan.uw
    us = ru * rounds
    acc = np.zeros((m, codes.shape[1]), dtype=np.float32)
    assert plan.ksplit == 1  # one block folds every group term of its columns
    nst = -(-units // us)
    cg, d, xs = -1, 0, 0  # the fold's state, carried from stage to stage
    for s in range(nst):
        ua, nu = s * us, min(us, units - s * us)
        slots = []  # (tag, s32 dot, x sum) by round, then warp row
        for j in range(-(-nu // ru)):
            for r in range(plan.kw):
                lr = j * ru + r * plan.uw
                if lr >= nu:
                    slots.append((-1, 0, 0))
                    continue
                run = range(ua + lr, ua + lr + plan.uw)
                assert len({u // ug for u in run}) == 1  # a run lies in one group
                slots.append(((ua + lr) // ug, sum(dots[u] for u in run),
                              sum(sums[u] for u in run)))
        for tag, sd, sx in slots:
            if tag < 0:
                continue
            if tag != cg:
                if cg >= 0:
                    acc = _term(acc, cg, d, xs, scale, zero, layout)
                cg, d, xs = tag, 0, 0
            d, xs = d + sd, xs + sx
        if (ua + nu) % ug == 0 or s + 1 == nst:
            acc = _term(acc, cg, d, xs, scale, zero, layout)
            cg, d, xs = -1, 0, 0
    return torch.from_numpy(acc * s_x.numpy())


def _b3_weight(kind, k, n, gs, gen):
    w = torch.randn((k, n), generator=gen)
    if kind == "s8_percol":
        qt = tquant.recode_head_s8(w)
        return qt.data, "s8", qt.scale, None, k
    bits = {"u4": 4, "u2": 2, "s4": 4, "s8": 8, "u8": 8}[kind]
    qt = tquant.quantize_rtn(w, tquant.QuantSpec(n_bits=bits, group_size=gs),
                             pack=kind not in ("s8",))
    if kind == "s4":
        s4 = tquant.prepare_s4(qt)
        return s4.data4, "s4", s4.scale, s4.zero8, gs
    return qt.data, kind, qt.scale, qt.zero, gs


@pytest.mark.parametrize("kind", ["u4", "u2", "s4", "s8", "u8", "s8_percol"])
@pytest.mark.parametrize("k,gs", [(256, 32), (512, 128), (2304, 64), (512, 512)])
def test_b3_walk_equals_plain(kind, k, gs):
    """Every stage size the launcher may pick gives `a8_plain`'s fp32 output
    bit for bit, at M = 1, 5 and 64."""
    gen = torch.Generator().manual_seed(k + gs)
    w = _b3_weight(kind, k, 48, gs, gen)
    for m in (1, 5, 64):
        xq, s_x = qa.quantize_activations_s8(torch.randn((m, k), generator=gen))
        ref = qa.a8_plain(xq, s_x, *w, torch.float32)
        for rounds in (1, 2, 4):
            got = b3_walk(xq, s_x, *w, rounds)
            assert torch.equal(got, ref), (m, rounds, float((got - ref).abs().max()))


def test_b3_walk_carries_one_long_group():
    """One group per column over a long K (the a8 route's per-column s8 down
    projection): the s32 sums carry from stage to stage into the one term."""
    gen = torch.Generator().manual_seed(5)
    k = 14336
    w = _b3_weight("s8_percol", k, 32, k, gen)
    xq, s_x = qa.quantize_activations_s8(torch.randn((3, k), generator=gen))
    for rounds in (1, 4):
        assert torch.equal(b3_walk(xq, s_x, *w, rounds), qa.a8_plain(xq, s_x, *w, torch.float32))


# ------------------------------------------------------------- B1's walk ----
def b1_walk(x, qt):
    """B1 on the CPU in the kernel's order: per split, warp row r walks run r
    of each round (uw units of one group); one fp32 dot and x sum per group,
    whose term dot*s - xsum*(z*s) follows the row's last run of the group;
    warp rows, then splits, added in order."""
    f = 1 if not qt.packed else {4: 2, 2: 4}[qt.bits]
    gs = qt.group_size or qt.k
    plan = fq.gemv_plan(qt.k, qt.n, gs, f)
    ug = gs // f // plan.unit
    ru = plan.kw * plan.uw
    xb = x.to(torch.bfloat16).float().numpy()
    codes = fq._codes(qt).float().numpy()
    scale, zero = qt.scale.numpy(), qt.zero.numpy()
    total = np.zeros((x.shape[0], qt.n), dtype=np.float32)
    for q in range(plan.ksplit):
        u0, u1 = _split(plan, qt.k, f, q)
        block = np.zeros_like(total)
        for r in range(plan.kw):
            acc = np.zeros_like(total)
            dot, xs = np.float32(0), np.float32(0)
            for a in range(u0 + r * plan.uw, u1, ru):
                for u in range(a, a + plan.uw):
                    ks = _unit_ks(u, plan.unit, gs, f)
                    dot = dot + xb[:, ks] @ codes[ks]
                    xs = xs + xb[:, ks].sum(axis=1)
                g = a // ug
                if a + ru >= u1 or (a + ru) // ug != g:
                    acc += dot * scale[g] - xs[:, None] * (zero[g] * scale[g])
                    dot, xs = np.float32(0), np.float32(0)
            block = block + acc
        total = total + block
    return total


@pytest.mark.parametrize("bits,pack,gs", [(4, True, 32), (4, True, 128), (2, True, 32),
                                          (2, True, 64), (8, False, 64), (4, True, 512)])
@pytest.mark.parametrize("m", [1, 5, 64])
def test_b1_walk_matches_pallas(bits, pack, gs, m):
    k, n = 512, 160
    rng = np.random.default_rng(bits * 100 + gs + m)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jq = quantize_rtn(jnp.asarray(w), QuantSpec(n_bits=bits, group_size=gs), pack=pack)
    tree = {"data": np.asarray(jq.data), "scale": np.asarray(jq.scale),
            "zero": np.asarray(jq.zero), "bits": jq.bits, "group_size": jq.group_size,
            "k": jq.k, "n": jq.n, "packed": jq.packed, "sym": jq.sym}
    tq = params_from_numpy({"w": tree}, device="cpu")["w"]
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(j_fused(jnp.asarray(x), jq, out_dtype=jnp.float32, interpret=True,
                             version=2))
    got = b1_walk(torch.from_numpy(x), tq)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    # and the plain version (the wrapper's CPU route) agrees with the walk
    plain = fq.qmm_gemv_plain(torch.from_numpy(x), tq, torch.float32).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-4 * np.abs(plain).max())


def test_b1_walk_is_batch_invariant():
    """The walk's order follows the plan alone: row i of an M = 8 call
    equals the M = 1 call on that row bit for bit, as on the card."""
    gen = torch.Generator().manual_seed(3)
    qt = tquant.quantize_rtn(torch.randn(512, 64, generator=gen),
                             tquant.QuantSpec(n_bits=4, group_size=64), pack=True)
    x = torch.randn((8, 512), generator=gen)
    full = b1_walk(x, qt)
    for i in range(8):
        np.testing.assert_array_equal(b1_walk(x[i:i + 1], qt)[0], full[i])
