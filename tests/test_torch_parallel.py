"""Port parity: the JAX package's mesh tests outside `tests/test_sharding.py`,
the port over 8 gloo ranks (`torch_dist_pool`, `torch_parallel_ranks`)
against the JAX package on the 8-device CPU mesh, from the same seeded
parameters, at each JAX test's tolerance (quantized trees under JAX's
default backend, "xla", unless the JAX test picks one). Map (JAX test ->
this file):

- test_moe.py::test_moe_sharded -> test_moe_sharded_matches_jax
- test_moe.py::test_moe_expert_parallel_sharding -> test_moe_expert_parallel_matches_jax
- test_moe.py::test_moe_capacity_expert_parallel -> test_moe_capacity_expert_parallel_matches_jax
- (the port's routed dispatch, no JAX test) -> test_moe_routed_sharded_matches_replica_and_jax
- test_s4.py::test_s4_sharded_forward_matches_single_device -> test_s4_sharded_forward_matches_jax
- test_s4.py::test_s4_sharded_generate_matches_single_device -> test_s4_sharded_generate_matches_jax
- test_serving.py::test_recode_head_shards -> test_recode_head_shards_match_jax
- test_serving.py::test_engine_with_tp_sharded_params -> test_engine_tp8_sharded_matches_jax
- test_serving.py::test_engine_tp_sharded_uses_flash_kernel -> test_engine_decode_mesh_matches_jax
- test_windowed.py::test_windowed_serve_under_tp_mesh -> test_windowed_serve_under_mesh_matches_jax
- test_ppl.py::test_sp_ppl_matches_single_device -> test_sp_ppl_matches_jax
- test_seq2seq.py::test_seq2seq_tp_sharded_matches_single_device -> test_seq2seq_tp_sharded_matches_jax
- test_io.py::test_orbax_checkpoint_roundtrip -> test_sharded_checkpoint_roundtrip
- test_distributed_smoke.py::test_two_process_pod_mesh_forward_and_calibration -> test_pod_mesh_forward_and_calibration
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from llama3_quantization_tpu.models import TINY_LLAMA, forward_logits, init_params, quantize_model_rtn
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.models.configs import TINY_MIXTRAL
from llama3_quantization_tpu.ops import matmul as jmm
from llama3_quantization_tpu.parallel import make_mesh, make_sharded_forward, shard_params
from llama3_quantization_tpu.quant import QuantSpec
from llama3_quantization_tpu.serving.engine import ServingEngine as JEngine

import torch_parallel_ranks as R
from test_torch_model import to_numpy_tree
from torch_dist_pool import Ranks

torch.set_num_threads(1)

CFG = ("TINY_LLAMA", {})
MOE = ("TINY_MIXTRAL", {})


@pytest.fixture(scope="module")
def pool():
    ranks = Ranks(8)
    yield ranks
    ranks.close()


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "tests expect the 8-device CPU mesh"
    return make_mesh(dp=2, tp=4)


def same_on_ranks(outs):
    got = [o for o in outs if o is not None]
    for o in got[1:]:
        np.testing.assert_array_equal(o, got[0])
    return got[0]


@functools.lru_cache(maxsize=None)
def fp_params(cfg=TINY_LLAMA, seed=0):
    """JAX's fp32 init (made once a module: JAX trees are immutable)."""
    return init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def rtn(cfg, bits, group_size, pack):
    """JAX's RTN of `fp_params(cfg)` (made once a module)."""
    return quantize_model_rtn(fp_params(cfg), cfg, QuantSpec(n_bits=bits, group_size=group_size),
                              pack=pack)


def jax_sharded(params, toks, mesh, cfg, **kw):
    return np.asarray(make_sharded_forward(cfg, mesh)(shard_params(params, mesh, cfg, **kw),
                                                      jnp.asarray(toks)))


@pytest.fixture(scope="module")
def moe():
    params = fp_params(TINY_MIXTRAL)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                         TINY_MIXTRAL.vocab_size))
    return params, to_numpy_tree(params), toks


def test_moe_sharded_matches_jax(pool, mesh, moe):
    params, tree, toks = moe
    ref = jax_sharded(params, toks, mesh, TINY_MIXTRAL)
    out = same_on_ranks(pool.run(R.sharded_forward, MOE, tree, toks, 2, 4))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_moe_expert_parallel_matches_jax(pool, mesh, moe):
    params, tree, toks = moe
    ref = jax_sharded(params, toks, mesh, TINY_MIXTRAL, expert_parallel=True)
    shapes = set(pool.run(R.shard_shapes, MOE, tree, 2, 4, ep=True))
    assert all(sh[1] == TINY_MIXTRAL.num_experts // 4 for sh in shapes), shapes
    out = same_on_ranks(pool.run(R.sharded_forward, MOE, tree, toks, 2, 4, ep=True))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("ep", [False, True], ids=["tp", "ep"])
def test_moe_routed_sharded_matches_replica_and_jax(pool, mesh, moe, monkeypatch, ep):
    """[2, 80] tokens on dp 2 x tp 4 with the MoE's switch set at 64 rows:
    80 rows a rank, so each rank runs the routed dispatch (the replica's
    160 rows run it too) on tp 4 feature shards of every expert,
    or on its one whole expert (ep, expert `rank % 4`): it serves its own
    experts' picks alone, and computes each such expert's picks, padded to
    the 65 rows of the call's kernel route where 64 or fewer; within 2e-4
    of one replica of the port and of JAX."""
    params, tree, _ = moe
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 80), 0,
                                         TINY_MIXTRAL.vocab_size))
    ref = jax_sharded(params, toks, mesh, TINY_MIXTRAL, expert_parallel=ep)
    monkeypatch.setattr(R.T, "MOE_ROUTED_ABOVE", 64)
    one = R.T.forward_logits(R.tree_of(tree), torch.tensor(toks), R.cfg_of(MOE)).numpy()
    got = [g for g in pool.run(R.sharded_moe_rows, MOE, tree, toks, 2, 4, ep=ep) if g is not None]
    assert len(got) == 8
    for rank, (_, computed, routed, per_call) in enumerate(got):
        local = [rank % 4] if ep else range(TINY_MIXTRAL.num_experts)
        assert len(per_call) == TINY_MIXTRAL.num_layers
        assert routed == sum(n[e] for n in per_call for e in local) > 0
        assert computed == sum(max(n[e], 65) for n in per_call for e in local if n[e])
    out = same_on_ranks([o for o, _, _, _ in got])
    np.testing.assert_allclose(out, one, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_moe_capacity_expert_parallel_matches_jax(pool, mesh, moe):
    params, tree, toks = moe
    cap = float(TINY_MIXTRAL.num_experts)  # C >= T: nothing drops
    JT.set_moe_capacity(cap)
    try:
        ref = jax_sharded(params, toks, mesh, TINY_MIXTRAL, expert_parallel=True)
    finally:
        JT.set_moe_capacity(None)
    out = same_on_ranks(pool.run(R.sharded_forward, MOE, tree, toks, 2, 4, ep=True, capacity=cap))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_s4_sharded_forward_matches_jax(pool, mesh):
    qp = rtn(TINY_LLAMA, 4, 16, True)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, TINY_LLAMA.vocab_size))
    with jmm.backend("s4"):
        ref = jax_sharded(qp, toks, mesh, TINY_LLAMA)
    out = same_on_ranks(pool.run(R.sharded_forward, CFG, to_numpy_tree(qp), toks, 2, 4,
                                 backend="s4"))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_s4_sharded_generate_matches_jax(pool):
    """Greedy decode under "s4" on a dp 2 x tp 4 rank-local tree of JAX's
    synthetic packed W4 g16 (S4Weight leaves prepared per shard) emits
    JAX's single-device s4 tokens."""
    from llama3_quantization_tpu.models.synthetic import init_quantized_params

    params = init_quantized_params(TINY_LLAMA, QuantSpec(n_bits=4, group_size=16), pack=True,
                                   dtype=jnp.float32)
    first = np.zeros((2, 1), np.int32)
    cache = JT.init_kv_cache(TINY_LLAMA, 2, 32)
    with jmm.backend("s4"):
        ref, _ = JT.greedy_generate(params, cache, jnp.asarray(first), jnp.int32(0), 8, TINY_LLAMA)
    out = same_on_ranks(pool.run(R.generate, CFG, to_numpy_tree(params), first, 8, 2, 4,
                                 backend="s4"))
    np.testing.assert_array_equal(out, np.asarray(ref))


def test_recode_head_shards_match_jax(pool, mesh):
    """A recoded per-column s8 head (and body) shards column-parallel and
    reproduces JAX's sharded forward."""
    from llama3_quantization_tpu.quant.serving import recode_model_s8

    cfg = dataclasses.replace(TINY_LLAMA, tie_word_embeddings=False)
    qp = quantize_model_rtn(fp_params(cfg), cfg, QuantSpec(n_bits=8, group_size=None))
    rp = recode_model_s8(qp, cfg, include_head=True)
    toks = np.zeros((1, 8), np.int32)
    ref = jax_sharded(rp, toks, mesh, cfg)
    out = same_on_ranks(pool.run(R.sharded_forward, ("TINY_LLAMA", {"tie_word_embeddings": False}),
                                 to_numpy_tree(rp), toks, 2, 4, backend="xla"))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def jax_engine(params, prompts, quantized=False, kernel="auto", attn="auto", step_tokens=0):
    JT.set_decode_kernel(kernel)
    JT.set_decode_attn(attn)
    try:
        eng = JEngine(params, TINY_LLAMA, max_slots=2, max_len=64, quantized_cache=quantized)
        if step_tokens:
            for prompt, n in prompts:
                eng.submit(prompt, n, None)
            eng.run_pipelined(step_tokens)
            return [list(r.generated) for _, r in sorted(eng.requests.items())]
        rids = [eng.add_request(p, max_new_tokens=n) for p, n in prompts]
        eng.run()
        return [eng.result(r) for r in rids]
    finally:
        JT.set_decode_kernel("auto")
        JT.set_decode_attn("auto")


def test_engine_tp8_sharded_matches_jax(pool):
    """The default engine (fp cache) on a tp 8 rank-local tree (4 query
    heads and 2 KV heads replicated over 8 ranks) emits JAX's tokens."""
    params = fp_params()
    reqs = [([1, 2, 3, 4], 6)]
    want = jax_engine(params, reqs)
    outs = pool.run(R.serve, CFG, to_numpy_tree(params), 1, 8, reqs)
    assert all(o[0] == want for o in outs)


@pytest.mark.big_compile  # JAX compiles its interpret-mode decode kernels
def test_engine_decode_mesh_matches_jax(pool):
    """The int8 engine on a tp 2 rank-local tree under a decode mesh (B5 on
    each rank's KV group) emits JAX's kernel-route tokens."""
    params = fp_params()
    reqs = [([1, 2, 3, 4], 6)]
    want = jax_engine(params, reqs, quantized=True, kernel="interpret")
    outs = pool.run(R.serve, CFG, to_numpy_tree(params), 1, 2, reqs, quantized=True,
                    decode_mesh=True)
    got = [o for o in outs if o is not None]
    assert len(got) == 2 and all(o[0] == want for o in got)


@pytest.mark.big_compile  # JAX compiles its interpret-mode decode kernels
def test_windowed_serve_under_mesh_matches_jax(pool):
    """The windowed fast path engages under a dp 2 x tp 2 decode mesh (int8
    cache on the codes-direct route), each dp rank's pool holding its slot,
    and `run_pipelined(4)` emits JAX's single-replica tokens."""
    params = fp_params()
    reqs = [([1, 2, 3, 4], 6), ([9, 8, 7], 8)]
    want = jax_engine(params, reqs, quantized=True, kernel="interpret", attn="xla", step_tokens=4)
    outs = pool.run(R.serve, CFG, to_numpy_tree(params), 2, 2, reqs, quantized=True,
                    decode_mesh=True, decode_attn="xla", step_tokens=4)
    got = [o for o in outs if o is not None]
    assert len(got) == 4
    for streams, win, dispatches, pool_shape in got:
        assert win and dispatches["windowed"] > 0
        assert pool_shape[1:3] == (1, 1)  # one slot, one KV group a rank
        assert sorted(map(tuple, streams)) == sorted(map(tuple, want))


def test_sp_ppl_matches_jax(pool):
    from llama3_quantization_tpu.eval.ppl import compute_ppl, sp_windowed_nll_fn

    params = fp_params()
    stream = np.random.default_rng(0).integers(0, TINY_LLAMA.vocab_size, (1, 64 * 3))
    ref = compute_ppl(params, TINY_LLAMA, stream, seqlen=64)
    smesh = Mesh(np.array(jax.devices()).reshape(8), ("sp",))
    jsp = compute_ppl(params, TINY_LLAMA, stream, seqlen=64,
                      step_fn=sp_windowed_nll_fn(TINY_LLAMA, smesh))
    sp = same_on_ranks(pool.run(R.sp_ppl, CFG, to_numpy_tree(params), stream, 64, 8))
    assert abs(sp - ref) / ref < 1e-4 and abs(sp - jsp) / jsp < 1e-4, (sp, ref, jsp)


def test_seq2seq_tp_sharded_matches_jax(pool):
    """Megatron-sharded T5 (dp 2 x tp 4: col q/k/v/c*/wi*, row o/co/wo, the
    relative-position tables' columns of each rank's heads) reproduces JAX's
    sharded teacher-forced logits, fp and RTN W8 g8 leaves."""
    from llama3_quantization_tpu.models import seq2seq as JS
    from llama3_quantization_tpu.parallel import shard_params_seq2seq

    kw = dict(vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2,
              num_heads=4, rel_buckets=8, rel_max_distance=32)
    cfg = JS.Seq2SeqConfig(**kw)
    params = JS.init_seq2seq_params(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    enc = rng.integers(2, cfg.vocab_size, (4, 10)).astype(np.int32)
    dec = rng.integers(2, cfg.vocab_size, (4, 6)).astype(np.int32)
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "tp"))
    for qp in (params, JS.quantize_seq2seq_rtn(params, cfg, QuantSpec(n_bits=8, group_size=8))):
        sharded = shard_params_seq2seq(qp, jmesh)
        enc_s = jax.device_put(jnp.asarray(enc), NamedSharding(jmesh, JP("dp", None)))
        dec_s = jax.device_put(jnp.asarray(dec), NamedSharding(jmesh, JP("dp", None)))
        with jmesh:
            ref = np.asarray(jax.jit(lambda p, e, d: JS.forward_logits_seq2seq(p, e, d, cfg))(
                sharded, enc_s, dec_s))
        out = same_on_ranks(pool.run(R.seq2seq_forward, kw, to_numpy_tree(qp), enc, dec, 2, 4,
                                     backend="xla"))
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_sharded_checkpoint_roundtrip(pool, tmp_path):
    """A dp 2 x tp 4 rank-local RTN W4 g16 packed tree saved with
    `save_checkpoint_sharded` by all 8 ranks restores bit for bit into a
    zeroed tree of its shapes; its sharded forward is unchanged and within
    JAX's 1e-5 of JAX's forward."""
    qp = rtn(TINY_LLAMA, 4, 16, True)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0, TINY_LLAMA.vocab_size))
    ref = np.asarray(forward_logits(qp, jnp.asarray(toks), TINY_LLAMA))
    outs = pool.run(R.checkpoint_roundtrip, CFG, to_numpy_tree(qp), str(tmp_path / "ckpt"), toks,
                    2, 4, backend="xla")
    for same, fwd_same, out in outs:
        assert same and fwd_same
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_pod_mesh_forward_and_calibration(pool, mesh):
    """`tools/dcn_smoke.py` on the port: two hosts of four ranks
    (`LOCAL_WORLD_SIZE=4`) give the pod mesh dp 2 x tp 4; a sharded
    quantized forward (JAX's within 2e-4) and one sharded LWC step on it
    (the one replica's loss within 2e-4; against JAX's:
    `test_torch_sharding.py::test_lwc_train_step_matches_jax`)."""
    params = fp_params()
    qp = rtn(TINY_LLAMA, 4, 16, True)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (4, 16), 0, TINY_LLAMA.vocab_size))
    train = np.asarray(jax.random.randint(jax.random.PRNGKey(6), (4, 17), 0, TINY_LLAMA.vocab_size))
    ref = jax_sharded(qp, toks, mesh, TINY_LLAMA)
    (ref_loss,), _ = pool.run(R.lwc_train, CFG, to_numpy_tree(params), train, 1, 1,
                              dict(n_bits=4, group_size=32, lwc=True), steps=1)[0]
    outs = pool.run(R.pod_smoke, CFG, to_numpy_tree(qp), to_numpy_tree(params), toks, train, 4,
                    backend="xla")
    for shape, out, loss in outs:
        assert shape == {"dp": 2, "tp": 4}
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(loss, ref_loss, rtol=2e-4)
