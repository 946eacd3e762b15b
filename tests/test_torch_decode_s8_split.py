"""Port parity: the split form of the quantized-KV flash decode, B4/B5.

B4/B5's kernel splits each T block of `bt` tokens over a thread-block
cluster of S blocks (`s8_split_plan`). `decode_s8_split_plain` is that
algorithm in PyTorch: per-slice row maxima, amaxima of `p * v_s`, slice
sums of p and s32 PV partials, combined in rank order. Held here against
the sequential plain version (`decode_s8_plain`: m, every probability code
and every s32 PV sum bit-equal; o and l within 1e-6 relative, since only
the order of the fp32 sum l differs) and against the JAX Pallas kernels
`flash_decode_gqa_s8(_stacked)` in interpret mode at the tolerances of
`tests/test_torch_decode_attention.py` (o 2e-3 * max|o|, m 1e-6, l 1e-5), on
the int8 cache and the int4 T-pair pack, with and without the m/l
statistics, at every cluster size the plan gives (8, 4, 2, 1), over two
T blocks, with a row masked in its tail, an all-masked row and a row
masked after its first T block.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama3_quantization_tpu.ops.decode_attention import NEG as J_NEG
from llama3_quantization_tpu.ops.decode_attention import flash_decode_gqa_s8 as j_decode_layer
from llama3_quantization_tpu.ops.decode_attention import flash_decode_gqa_s8_stacked as j_decode
from llama3_quantization_tpu.ops.kvcache import kv4_quantize as j_kv4_quantize
from llama3_quantization_tpu.ops.kvcache import kv_quantize as j_kv_quantize
from llama3_quantization_tpu_torch.ops import decode_attention as da

torch.set_num_threads(1)

L, B, G, REP = 2, 3, 2, 2
#: (T block, D, cluster) giving each cluster size of the plan: S = 8 (32-
#: and 16-token slices), 4, 2 (16-token slices) and 1 (a 16-token block, and
#: a 24-token one: not a multiple of 16)
SPLITS = {"8": (256, 16, 8), "8-16": (128, 32, 8), "4": (64, 64, 4), "2": (32, 128, 2),
          "1": (16, 16, 1), "1-odd": (24, 32, 1)}


def _inputs(bt, d, int4, seed):
    """q, the stacked cache (JAX arrays and torch tensors) and the mask over
    T = 2 * bt: row 0 masked in its tail, row 1 all masked, row 2 masked
    after its first T block."""
    t = 2 * bt
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, G * REP, d)).astype(np.float32)
    kv = rng.standard_normal((2, L, B, G, t, d)).astype(np.float32)
    mask = rng.uniform(-2.0, 0.0, (B, t)).astype(np.float32)
    mask[0, t - 5:] = J_NEG
    mask[1, :] = J_NEG
    mask[2, bt:] = J_NEG
    quantize = j_kv4_quantize if int4 else j_kv_quantize
    kq, ks = quantize(jnp.asarray(kv[0]))
    vq, vs = quantize(jnp.asarray(kv[1]))
    jax_args = (kq, ks, vq, vs)
    torch_args = [torch.from_numpy(np.array(a)) for a in jax_args]
    return q, mask, jax_args, torch_args


@pytest.mark.parametrize("t,bt,d,int4", [
    (512, 512, 128, False), (2048, 1024, 128, True), (4096, 4096, 128, False),
    (256, 128, 64, True), (64, 64, 16, False), (96, 32, 32, True), (48, 16, 16, False),
    (48, 24, 64, True), (40, 40, 16, False), (1000, 1000, 128, False), (7, 7, 16, False),
])
def test_plan_invariants(t, bt, d, int4):
    """The slices tile the T block, are whole multiples of 16 tokens wherever
    the cluster has more than one block (so even: no int4 T-pair is split),
    and the cluster is a power of two of at most 8. The plan is made from
    (T, bt, D, int4) alone: no batch size enters it."""
    plan = da.s8_split_plan(t, bt, d, int4)
    assert plan.cluster * plan.slice == bt
    assert plan.cluster in (1, 2, 4, 8) and plan.cluster <= da.S8_MAX_CLUSTER
    if plan.cluster > 1:
        assert plan.slice % 16 == 0
    assert not int4 or plan.slice % 2 == 0
    # the largest such cluster: twice as many blocks would cut a slice below 16
    assert plan.cluster == da.S8_MAX_CLUSTER or bt % (2 * plan.cluster * 16)
    assert list(da.s8_split_plan.__code__.co_varnames[:4]) == ["t", "bt", "d", "int4"]


@pytest.mark.parametrize("t,bt,d,int4", [(64, 48, 16, False), (64, 64, 24, False),
                                         (62, 31, 16, True), (64, 0, 16, False)])
def test_plan_rejects_what_b4_cannot_take(t, bt, d, int4):
    with pytest.raises(ValueError):
        da.s8_split_plan(t, bt, d, int4)


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("int4", [False, True])
def test_split_plain_matches_plain(split, stats, int4):
    """m bit-equal, every block's probability codes and s32 PV sums equal
    exactly, o and l within 1e-6 relative (the rank-ordered sum of l)."""
    bt, d, cluster = SPLITS[split]
    q, mask, _, t = _inputs(bt, d, int4, seed=bt + d)
    args = (torch.from_numpy(q), *(x[1] for x in t), torch.from_numpy(mask))
    ref = da.decode_s8_plain(*args, torch.float32, bt, True, True)
    got = da.decode_s8_split_plain(*args, torch.float32, bt, True, True)
    plan = da.s8_split_plan(2 * bt, bt, d, int4)
    assert plan.cluster == cluster
    assert torch.equal(got[1], ref[1])
    assert got[3].dtype == torch.int8 and torch.equal(got[3], ref[3])
    assert got[4].dtype == torch.int32 and got[4].shape == (B, G, REP, 2, d)
    assert torch.equal(got[4], ref[4])
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-6 * float(ref[0].abs().max()))
    torch.testing.assert_close(got[2], ref[2], rtol=1e-6, atol=0)
    assert bool((got[1][1] == da.NEG).all()) and bool((got[2][1] == 2 * bt).all())
    plain = da.decode_s8_split_plain(*args, torch.float32, bt, stats)
    o = plain[0] if stats else plain
    assert torch.equal(o, got[0])
    if stats:
        assert torch.equal(plain[1], got[1]) and torch.equal(plain[2], got[2])


@pytest.mark.parametrize("int4", [False, True])
def test_split_plain_is_batch_invariant(int4):
    """Row b of a B=3 call equals, bit for bit, a B=1 call on that row."""
    q, mask, _, t = _inputs(256, 32, int4, seed=3)
    args = (torch.from_numpy(q), *(x[0] for x in t), torch.from_numpy(mask))
    full = da.decode_s8_split_plain(*args, torch.float32, 256, True)
    for b in range(B):
        one = da.decode_s8_split_plain(*(x[b : b + 1] for x in args), torch.float32, 256, True)
        for x, y in zip(full, one):
            assert torch.equal(x[b : b + 1], y)


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("int4", [False, True])
def test_split_plain_matches_pallas(split, stats, int4):
    """Against the TPU kernels in interpret mode: with stats the stacked
    call on layer 1 (o, m, l); without, the per-layer call on layer 0."""
    bt, d, _ = SPLITS[split]
    q, mask, j, t = _inputs(bt, d, int4, seed=7 * bt + d + int4)
    layer = 1 if stats else 0
    if stats:
        jo, jm, jl = j_decode(jnp.asarray(q), *j, jnp.asarray(mask), layer,
                              out_dtype=jnp.float32, block_t=bt, interpret=True,
                              return_stats=True)
    else:
        jo = j_decode_layer(jnp.asarray(q), *(x[layer] for x in j), jnp.asarray(mask),
                            out_dtype=jnp.float32, block_t=bt, interpret=True)
    got = da.decode_s8_split_plain(torch.from_numpy(q), *(x[layer] for x in t),
                                   torch.from_numpy(mask), torch.float32, bt, stats)
    o = got[0] if stats else got
    jo = np.asarray(jo)
    assert o.shape == (B, 1, G * REP, d)
    np.testing.assert_allclose(o.numpy(), jo, rtol=0, atol=2e-3 * np.abs(jo).max())
    if stats:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(jm), rtol=1e-6, atol=0)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(jl), rtol=1e-5, atol=0)
        assert np.all(got[1].numpy()[1] == np.float32(J_NEG)) and np.all(got[2].numpy()[1] == 2 * bt)
