"""Port parity: `tests/test_sharding.py`'s 19 mesh tests, the port over gloo
ranks against the JAX package on the 8-device CPU mesh.

Each test runs JAX's function as the JAX test does (`make_mesh(dp=2,
tp=4)`, `Mesh(devices, ("sp",))`, `("pp",)`, ...) and the port's over a
pool of 8 spawned gloo ranks (`torch_dist_pool`, what each rank runs is in
`torch_parallel_ranks`), from the same seeded JAX parameters, and holds
them at the JAX test's tolerance. Quantized trees run under JAX's default
backend ("xla"). Map (JAX test -> this file):

- test_sharded_forward_matches_single_device -> test_sharded_forward_matches_jax
- test_sharded_quantized_forward -> test_sharded_quantized_forward_matches_jax
- test_weight_shards_actually_distributed -> test_weight_shards_are_rank_local
- test_lwc_train_step_runs_sharded -> test_lwc_train_step_matches_jax
- test_graft_entry_dryrun -> test_dryrun_legs_over_eight_ranks
- test_scaling_benchmark_machinery -> test_scaling_benchmark_matches_jax_keys
- test_make_pod_mesh_single_host -> test_make_pod_mesh_single_host
- test_pipeline_parallel_matches_reference -> test_pipeline_matches_jax
- test_ring_attention_sp_forward -> test_ring_attention_sp_forward_matches_jax
- test_ring_attention_matches_eager_directly -> test_ring_attention_direct_matches_jax
- test_ring_attention_honors_attn_quant_hooks -> test_ring_attention_hooks_match_jax
- test_ring_attention_probs_quant_matches_eager -> test_ring_attention_probs_quant_matches_jax
- test_collective_matmuls -> test_collective_matmuls_match_jax
- test_pipeline_parallel_all_archs -> test_pipeline_all_archs_match_jax
- test_tp_overlap_forward -> test_tp_overlap_forward_matches_jax
- test_flash_decode_kernel_sharded_matches_single_replica -> test_sharded_decode_matches_jax
- test_flash_decode_mesh_fallback_when_shapes_dont_divide -> test_decode_mesh_fallback_is_eager
- test_ring_attention_grouped_probs_quant_matches_eager -> test_ring_grouped_probs_quant_matches_jax
- test_sharded_gptq_solve_matches_single_device -> test_sharded_gptq_matches_jax
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as JP

from llama3_quantization_tpu.models import TINY_LLAMA, forward_logits, init_params, quantize_model_rtn
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.models.configs import TINY_FALCON, TINY_MIXTRAL, TINY_OPT
from llama3_quantization_tpu.models.transformer import RuntimeQuantConfig
from llama3_quantization_tpu.parallel import (
    make_mesh,
    make_pipeline_forward,
    make_sharded_forward,
    make_sp_forward,
    make_tp_overlap_forward,
    ring_attention,
    shard_params,
    shard_params_pipeline,
)
from llama3_quantization_tpu.quant import QuantSpec

import torch_parallel_ranks as R
from test_torch_model import to_numpy_tree
from torch_dist_pool import Ranks

torch.set_num_threads(1)

CFG = ("TINY_LLAMA", {})
WORLD = 8


@pytest.fixture(scope="module")
def pool():
    ranks = Ranks(WORLD)
    yield ranks
    ranks.close()


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "tests expect the 8-device CPU mesh"
    return make_mesh(dp=2, tp=4)


@functools.lru_cache(maxsize=None)
def fp_params(cfg=TINY_LLAMA, seed=0):
    """JAX's fp32 init (made once a module: JAX trees are immutable)."""
    return init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def rtn(cfg, bits, group_size, pack):
    """JAX's RTN of `fp_params(cfg)` (made once a module)."""
    return quantize_model_rtn(fp_params(cfg), cfg, QuantSpec(n_bits=bits, group_size=group_size),
                              pack=pack)


def rand_toks(shape, seed=1, vocab=TINY_LLAMA.vocab_size):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0, vocab))


def same_on_ranks(outs):
    """The result every rank of the mesh returned (all equal), bit for bit."""
    got = [o for o in outs if o is not None]
    for o in got[1:]:
        np.testing.assert_array_equal(o, got[0])
    return got[0]


def jax_sharded(params, toks, mesh, cfg=TINY_LLAMA, **kw):
    return np.asarray(make_sharded_forward(cfg, mesh)(shard_params(params, mesh, cfg, **kw),
                                                      jnp.asarray(toks)))


def test_sharded_forward_matches_jax(pool, mesh):
    params = fp_params()
    toks = rand_toks((4, 16))
    ref = jax_sharded(params, toks, mesh)
    out = same_on_ranks(pool.run(R.sharded_forward, CFG, to_numpy_tree(params), toks, 2, 4))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_sharded_quantized_forward_matches_jax(pool, mesh):
    qp = rtn(TINY_LLAMA, 4, 16, True)
    toks = rand_toks((4, 16))
    ref = jax_sharded(qp, toks, mesh)
    out = same_on_ranks(pool.run(R.sharded_forward, CFG, to_numpy_tree(qp), toks, 2, 4,
                                 backend="xla"))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_weight_shards_are_rank_local(pool, mesh):
    params = init_params(TINY_LLAMA, jax.random.PRNGKey(0))
    w = shard_params(params, mesh, TINY_LLAMA)["layers"]["gate"]["w"]
    jax_shapes = {s.data.shape for s in w.addressable_shards}
    shapes = set(pool.run(R.shard_shapes, CFG, to_numpy_tree(params), 2, 4))
    assert shapes == jax_shapes == {(w.shape[0], w.shape[1], w.shape[2] // 4)}


def jax_lwc_losses(params, toks, mesh, wspec, steps=2):
    from llama3_quantization_tpu.parallel.train import init_model_lwc, make_lwc_train_step

    sharded = shard_params(params, mesh, TINY_LLAMA)
    lwc = init_model_lwc(sharded, TINY_LLAMA, wspec)
    opt, step = make_lwc_train_step(TINY_LLAMA, mesh, wspec)
    state = opt.init(lwc)
    losses = []
    for _ in range(steps):
        lwc, state, loss = step(lwc, state, sharded, jnp.asarray(toks))
        losses.append(float(loss))
    return losses


def test_lwc_train_step_matches_jax(pool, mesh):
    """Two sharded LWC steps (dp 2 x tp 4): finite losses, the clipping
    logits moved, and each loss JAX's on the same fp32 weights (the second
    after one AdamW update with optax's defaults)."""
    params = fp_params()
    wspec = dict(n_bits=4, group_size=32, lwc=True)
    toks = rand_toks((4, 17), seed=2)
    ref = jax_lwc_losses(params, toks, mesh, QuantSpec(**wspec))
    outs = pool.run(R.lwc_train, CFG, to_numpy_tree(params), toks, 2, 4, wspec)
    for losses, moved in outs:
        assert np.all(np.isfinite(losses)) and moved > 0
        np.testing.assert_allclose(losses, ref, rtol=2e-4)
    assert len({tuple(o[0]) for o in outs}) == 1


def test_dryrun_legs_over_eight_ranks(pool, mesh):
    """`__graft_entry__.dryrun_multichip(8)`'s legs on 8 ranks (its bf16
    weights), each held to that dryrun's own check: the LWC step (dp 2 x tp
    4) finite, every rank the same loss (its loss against JAX's:
    `test_lwc_train_step_matches_jax`); MoE expert-parallel forward, dense
    and at capacity 1.25, finite (dense within bf16 steps of the one
    replica); pp = 4 within 1e-3 of the single-device forward; sp = 8 within
    0.05; the int8 decode on a dp 2 x tp 2 decode mesh within 0.5 of the
    forward."""
    cfg = TINY_LLAMA
    params = init_params(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 33)).astype(np.int32)
    wspec = dict(n_bits=4, group_size=32, lwc=True)
    outs = pool.run(R.lwc_train, CFG, to_numpy_tree(params), toks, 2, 4, wspec, steps=1)
    assert np.isfinite(outs[0][0][0]) and len({o[0][0] for o in outs}) == 1

    mparams = init_params(TINY_MIXTRAL, jax.random.PRNGKey(1))
    mtoks = np.random.default_rng(1).integers(0, TINY_MIXTRAL.vocab_size, (4, 16)).astype(np.int32)
    mtree = to_numpy_tree(mparams)
    mspec = ("TINY_MIXTRAL", {})
    dense = same_on_ranks(pool.run(R.sharded_forward, mspec, mtree, mtoks, 2, 4, ep=True))
    cap = same_on_ranks(pool.run(R.sharded_forward, mspec, mtree, mtoks, 2, 4, ep=True,
                                 capacity=1.25))
    one = same_on_ranks(pool.run(R.sharded_forward, mspec, mtree, mtoks, 1, 1))
    assert np.isfinite(dense).all() and np.isfinite(cap).all()
    # bf16 logits, summed in other orders: a few bf16 steps apart
    np.testing.assert_allclose(dense, one, atol=1e-2)

    pcfg = dataclasses.replace(cfg, num_layers=4)
    pparams = init_params(pcfg, jax.random.PRNGKey(2))
    ptoks = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    pref = np.asarray(forward_logits(pparams, jnp.asarray(ptoks), pcfg)).astype(np.float32)
    pspec, ptree = ("TINY_LLAMA", {"num_layers": 4}), to_numpy_tree(pparams)
    pout = same_on_ranks(pool.run(R.pipeline, pspec, ptree, ptoks, 4, 2))
    single = same_on_ranks(pool.run(R.sharded_forward, pspec, ptree, ptoks, 1, 1))
    assert np.allclose(pout, single, atol=1e-3)  # the dryrun's check, on the port's own forward
    assert np.allclose(pout, pref, atol=2e-2)  # JAX's bf16 forward, a few bf16 steps apart

    sparams = init_params(cfg, jax.random.PRNGKey(3))
    stoks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    sref = np.asarray(forward_logits(sparams, jnp.asarray(stoks), cfg)).astype(np.float32)
    sout = same_on_ranks(pool.run(R.sp_forward, CFG, to_numpy_tree(sparams), stoks, 8))
    assert np.allclose(sout.astype(np.float32), sref, atol=0.05)

    dparams = fp_params(seed=4)
    dtoks = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 6)).astype(np.int32)
    dref = np.asarray(forward_logits(dparams, jnp.asarray(dtoks), cfg))
    steps, counts = pool.run(R.decode_steps, CFG, to_numpy_tree(dparams), dtoks, 2, 2, True)[0]
    assert float(np.max(np.abs(steps[-1] - dref[:, -1]))) < 0.5
    assert counts["B5.eager"] == 0  # the decode kernel's route (its plain version on the CPU)


def test_scaling_benchmark_matches_jax_keys(pool):
    """The scaling harness at 1, 2 and 4 ranks (tp 2 a group): every rank
    returns rank 0's readings, efficiency 1.0 at one device, positive
    rates, and JAX's keys and meshes."""
    from llama3_quantization_tpu.benchmarks import measure_scaling

    params = init_params(TINY_LLAMA, jax.random.PRNGKey(0))
    kw = dict(seq=32, batch_per_device=1, iters=2, tp_per_group=2)
    jres = measure_scaling(params, TINY_LLAMA, device_counts=(1, 2, 4), **kw)
    outs = pool.run(R.scaling, CFG, to_numpy_tree(params), (1, 2, 4), kw["seq"],
                    kw["batch_per_device"], kw["iters"], kw["tp_per_group"])
    assert all(o == outs[0] for o in outs)
    res = outs[0]
    assert set(res) == set(jres) and res[1]["efficiency"] == 1.0
    for n, r in res.items():
        assert set(r) == set(jres[n]) and r["tok_s"] > 0
        assert r["mesh"] == dict(jres[n]["mesh"])


def test_make_pod_mesh_single_host(pool):
    from llama3_quantization_tpu.parallel.distributed import make_pod_mesh

    want = dict(make_pod_mesh(tp=4).shape)
    assert want == {"dp": 2, "tp": 4}
    assert pool.run(R.pod_mesh, 8, 4) == [want] * WORLD
    # tp defaults to one host's ranks: two hosts of four
    assert pool.run(R.pod_mesh, 4) == [want] * WORLD


def test_pipeline_matches_jax(pool):
    cfg = dataclasses.replace(TINY_LLAMA, num_layers=4)
    spec = ("TINY_LLAMA", {"num_layers": 4})
    params = fp_params(cfg)
    toks = rand_toks((8, 16))
    pmesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("pp",))
    for tree, micro, backend in ((params, 4, None), (rtn(cfg, 8, 32, False), 2, "xla")):
        ref = np.asarray(make_pipeline_forward(cfg, pmesh, n_microbatches=micro)(
            shard_params_pipeline(tree, pmesh, cfg), jnp.asarray(toks)))
        out = same_on_ranks(pool.run(R.pipeline, spec, to_numpy_tree(tree), toks, 4, micro,
                                     backend=backend))
        np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.fixture(scope="module")
def sp_mesh():
    return Mesh(np.array(jax.devices()).reshape(8), ("sp",))


def jax_sp(params, toks, sp_mesh, rq=None):
    return np.asarray(make_sp_forward(TINY_LLAMA, sp_mesh, rq or RuntimeQuantConfig())(
        params, jnp.asarray(toks)))


def test_ring_attention_sp_forward_matches_jax(pool, sp_mesh):
    params = fp_params()
    toks = rand_toks((2, 64))
    for tree, backend in ((params, None), (rtn(TINY_LLAMA, 8, 32, False), "xla")):
        ref = jax_sp(tree, toks, sp_mesh)
        out = same_on_ranks(pool.run(R.sp_forward, CFG, to_numpy_tree(tree), toks, 8,
                                     backend=backend))
        np.testing.assert_allclose(out, ref, atol=1e-4)


def test_ring_attention_direct_matches_jax(pool, sp_mesh):
    """The port's ring over 8 ranks against JAX's ring on the 8-device mesh
    and the eager masked attention, GQA on random q/k/v."""
    b, s, h, g, d = 2, 64, 4, 2, 8
    q = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (b, s, h, d), jnp.float32))
    k = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (b, s, g, d), jnp.float32))
    v = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (b, s, g, d), jnp.float32))
    qg = q.reshape(b, s, g, h // g, d)
    scores = np.einsum("bsgrd,btgd->bgrst", qg, k) / math.sqrt(d)
    scores = scores + np.where(np.arange(s)[None, :] <= np.arange(s)[:, None], 0.0, -np.inf)
    probs = np.exp(scores - scores.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    eager = np.einsum("bgrst,btgd->bsgrd", probs, v).reshape(b, s, h, d)
    ring = jax.jit(shard_map(ring_attention, mesh=sp_mesh, in_specs=(JP(None, "sp", None, None),) * 3,
                             out_specs=JP(None, "sp", None, None), check_vma=False))
    jout = np.asarray(ring(q, k, v))
    out = same_on_ranks(pool.run(R.ring_direct, q, k, v, 8))
    np.testing.assert_allclose(out, jout, atol=1e-5)
    np.testing.assert_allclose(out, eager, atol=1e-5)


def test_ring_attention_hooks_match_jax(pool, sp_mesh):
    """k/v hooks move the sp forward as JAX's; an LWC p-spec is refused at
    construction and a group straddling ring blocks at the call."""
    params = fp_params()
    toks = rand_toks((2, 64))
    rq = {"k": dict(n_bits=4), "v": dict(n_bits=4)}
    ref = jax_sp(params, toks, sp_mesh, RuntimeQuantConfig(k=QuantSpec(n_bits=4),
                                                           v=QuantSpec(n_bits=4)))
    tree = to_numpy_tree(params)
    out = same_on_ranks(pool.run(R.sp_forward, CFG, tree, toks, 8, rq))
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert float(np.max(np.abs(out - jax_sp(params, toks, sp_mesh)))) > 1e-3
    msgs = same_on_ranks(pool.run(R.sp_refusals, CFG, tree, toks, 8))
    assert len(msgs) == 2 and "LWC" in msgs[0] and "multiple of group_size" in msgs[1]


def test_ring_attention_probs_quant_matches_jax(pool, sp_mesh):
    params = fp_params()
    toks = rand_toks((2, 64))
    tree = to_numpy_tree(params)
    base = jax_sp(params, toks, sp_mesh)
    for spec in (dict(n_bits=8), dict(n_bits=8, metric="fix0to1")):
        ref = jax_sp(params, toks, sp_mesh, RuntimeQuantConfig(p=QuantSpec(**spec)))
        out = same_on_ranks(pool.run(R.sp_forward, CFG, tree, toks, 8, {"p": spec}))
        np.testing.assert_allclose(out, ref, atol=2e-3)
        assert float(np.max(np.abs(out - base))) > 1e-3


def test_ring_grouped_probs_quant_matches_jax(pool, sp_mesh):
    params = fp_params()
    toks = rand_toks((2, 64))
    spec = dict(n_bits=4, group_size=4)
    ref = jax_sp(params, toks, sp_mesh, RuntimeQuantConfig(p=QuantSpec(**spec)))
    out = same_on_ranks(pool.run(R.sp_forward, CFG, to_numpy_tree(params), toks, 8, {"p": spec}))
    np.testing.assert_allclose(out, ref, atol=2e-3)
    assert float(np.max(np.abs(out - jax_sp(params, toks, sp_mesh)))) > 1e-3


def test_collective_matmuls_match_jax(pool):
    """Ring ag/rs matmuls over 8 ranks == dense x @ W (fp) and JAX's
    `qmatmul` (RTN W8 g8 column and group-aligned row shards)."""
    from llama3_quantization_tpu.ops.matmul import qmatmul
    from llama3_quantization_tpu.quant.qtensor import quantize_rtn

    S, K, N = 32, 64, 48
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (S, K), jnp.float32))
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (K, N), jnp.float32))
    wq = quantize_rtn(jnp.asarray(w), QuantSpec(n_bits=8, group_size=8))
    dense, refq = x @ w, np.asarray(qmatmul(jnp.asarray(x), wq))
    ag, rs, agq, rsq = same_on_ranks(pool.run(R.collective_matmuls, x, w, to_numpy_tree(wq), 8))
    for got, want in ((ag, dense), (rs, dense), (agq, refq), (rsq, refq)):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


def test_pipeline_all_archs_match_jax(pool):
    pmesh = Mesh(np.array(jax.devices()[:2]).reshape(2), ("pp",))
    for base in (TINY_OPT, TINY_FALCON, TINY_MIXTRAL):
        cfg = dataclasses.replace(base, num_layers=2)
        params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        toks = rand_toks((4, 16), vocab=cfg.vocab_size)
        ref = np.asarray(make_pipeline_forward(cfg, pmesh, n_microbatches=2)(
            shard_params_pipeline(params, pmesh, cfg), jnp.asarray(toks)))
        name = {TINY_OPT: "TINY_OPT", TINY_FALCON: "TINY_FALCON", TINY_MIXTRAL: "TINY_MIXTRAL"}
        out = same_on_ranks(pool.run(R.pipeline, (name[base], {"num_layers": 2}),
                                     to_numpy_tree(params), toks, 2, 2))
        np.testing.assert_allclose(out, ref, atol=2e-4, err_msg=f"pipeline mismatch for {base.arch}")


def test_tp_overlap_forward_matches_jax(pool):
    params = fp_params()
    toks = rand_toks((2, 32))
    jmesh = make_mesh(tp=2, devices=jax.devices()[:2])
    for tree, backend in ((params, None), (rtn(TINY_LLAMA, 8, 32, False), "xla")):
        ref = np.asarray(make_tp_overlap_forward(TINY_LLAMA, jmesh)(tree, jnp.asarray(toks)))
        out = same_on_ranks(pool.run(R.tp_overlap, CFG, to_numpy_tree(tree), toks, 2,
                                     backend=backend))
        np.testing.assert_allclose(out, ref, atol=1e-4)


def jax_decode(params, toks, mesh, quantized, kernel="interpret", shard=True):
    JT.set_decode_kernel(kernel)
    JT.set_decode_mesh(mesh)
    try:
        p = shard_params(params, mesh, TINY_LLAMA) if (shard and mesh is not None) else params
        cache = JT.init_kv_cache(TINY_LLAMA, toks.shape[0], 16, quantized=quantized)
        t = jnp.asarray(toks)
        lg, cache = JT.decode_step(p, cache, t[:, :4], jnp.int32(0), TINY_LLAMA)
        seq = [lg[:, -1]]
        for i in range(4, t.shape[1]):
            lg, cache = JT.decode_step(p, cache, t[:, i : i + 1], jnp.int32(i), TINY_LLAMA)
            seq.append(lg[:, 0])
        return np.asarray(jnp.stack(seq))
    finally:
        JT.set_decode_kernel("auto")
        JT.set_decode_mesh(None)


@pytest.mark.big_compile  # JAX compiles its interpret-mode decode kernels
def test_sharded_decode_matches_jax(pool):
    """dp 2 x tp 2 decode mesh, int8 and fp caches: the port's rank-local
    decode (B5 / B6 on each rank's rows and KV groups; the cache B/dp rows
    by `shard_kv_cache`, and a whole cache whose groups the first step
    keeps) against JAX's shard_mapped kernels, and against its own single
    replica."""
    dmesh = make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    params = fp_params()
    toks = rand_toks((2, 10))
    tree = to_numpy_tree(params)
    for quantized in (True, False):
        ref = jax_decode(params, toks, dmesh, quantized)
        single = pool.run(R.decode_steps, CFG, tree, toks, 2, 2, quantized, shard=False,
                          decode_mesh=False)[0][0]
        for row_local in (True, False):
            outs = pool.run(R.decode_steps, CFG, tree, toks, 2, 2, quantized,
                            row_local=row_local)
            got = [o for o in outs if o is not None]
            out = same_on_ranks([o[0] for o in got])
            # the kernel's route on every rank (its plain version on the CPU)
            assert all(o[1]["B5.eager" if quantized else "B6.eager"] == 0 for o in got)
            np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(out, single, rtol=2e-4, atol=2e-4)


@pytest.mark.big_compile  # JAX compiles its interpret-mode decode kernels
def test_decode_mesh_fallback_is_eager(pool, mesh):
    """KV heads (2) % tp (4) != 0 under a dp 2 x tp 4 decode mesh: the step
    takes the eager attention (counted `B5.eager`) and matches the
    kernel-off run, and JAX's mesh run."""
    params = fp_params()
    toks = rand_toks((2, 8))
    tree = to_numpy_tree(params)
    ref = jax_decode(params, toks, mesh, True, shard=False)
    off = pool.run(R.decode_steps, CFG, tree, toks, 2, 4, True, shard=False, decode_mesh=False,
                   kernel=False)[0][0]
    out, counts = pool.run(R.decode_steps, CFG, tree, toks, 2, 4, True, shard=False)[0]
    assert counts["B5.eager"] > 0
    np.testing.assert_allclose(out, off, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_sharded_gptq_matches_jax(pool):
    """The dp-sharded Hessian (4 ranks) equals JAX's; the tp-sharded solve
    (8 ranks) gives JAX's sharded codes bit for bit, its scales at 1e-6 and
    its error at 1e-4."""
    from llama3_quantization_tpu.parallel import (
        sharded_gptq_quantize_weight,
        sharded_hessian_update,
    )
    from llama3_quantization_tpu.quant.gptq import hessian_init

    rng = np.random.default_rng(0)
    K, N = 64, 48
    X = rng.standard_normal((4, 32, K)).astype(np.float32)
    W = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    mesh_dp = Mesh(np.array(jax.devices())[:4].reshape(4), ("dp",))
    mesh_tp = Mesh(np.array(jax.devices()).reshape(8), ("tp",))
    hs = sharded_hessian_update(hessian_init(K), jnp.asarray(X), mesh_dp, axis="dp")
    spec = dict(n_bits=4, group_size=16)
    qt, err = sharded_gptq_quantize_weight(jnp.asarray(W), hs.H, QuantSpec(**spec), mesh_tp,
                                           blocksize=16, pack=True)
    outs = pool.run(R.sharded_gptq, W, X, spec, 16, 8, 4)
    got = same_on_ranks([o["data"] for o in outs])
    res = outs[0]
    assert res["nsamples"] == hs.nsamples
    np.testing.assert_allclose(res["H"], np.asarray(hs.H), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, np.asarray(qt.data))
    np.testing.assert_allclose(res["scale"], np.asarray(qt.scale), rtol=1e-6)
    np.testing.assert_allclose(res["zero"], np.asarray(qt.zero), rtol=1e-6)
    np.testing.assert_allclose(res["err"], float(err), rtol=1e-4)
