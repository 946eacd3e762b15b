"""What each gloo rank runs for the port's parallel tests
(`tests/test_torch_sharding.py`, `tests/test_torch_parallel.py`,
`tests/test_torch_cli.py`), through `torch_dist_pool`.

Every function takes `(rank, world, ...)`, builds the port's tree from the
numpy tree it is given (JAX's parameters carried by
`convert.params_from_numpy`), runs the port's parallel path on a mesh over
the first ranks of the pool, and returns numpy arrays (None on a rank
outside the mesh). This module imports torch and the port only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as C
from llama3_quantization_tpu_torch.models import transformer as T
from llama3_quantization_tpu_torch.ops import launches
from llama3_quantization_tpu_torch.ops import matmul as mm
from llama3_quantization_tpu_torch.parallel import (
    ag_matmul,
    make_mesh,
    make_pipeline_forward,
    make_sharded_forward,
    make_sp_forward,
    make_tp_overlap_forward,
    ring_attention,
    rs_matmul,
    shard_kv_cache,
    shard_params,
    shard_params_pipeline,
)
from llama3_quantization_tpu_torch.parallel.mesh import in_mesh, mesh_shape, named_mesh
from llama3_quantization_tpu_torch.quant.quantizer import QuantSpec
from llama3_quantization_tpu_torch.utils import profiling


def cfg_of(spec):
    """(config name, overrides) -> the port's ModelConfig."""
    name, over = spec
    return dataclasses.replace(getattr(C, name), **over)


def tree_of(tree_np):
    return convert.params_from_numpy(tree_np, device="cpu")


def rq_of(specs):
    """{"k": {QuantSpec kwargs}, ...} -> RuntimeQuantConfig."""
    return T.RuntimeQuantConfig(**{k: QuantSpec(**v) for k, v in (specs or {}).items()})


@contextlib.contextmanager
def switches(backend=None, capacity=None):
    prev = mm.get_backend()
    if backend:
        mm.set_backend(backend)
    if capacity is not None:
        T.set_moe_capacity(capacity)
    try:
        yield
    finally:
        mm.set_backend(prev)
        T.set_moe_capacity(None)
        T.set_decode_kernel("auto")
        T.set_decode_attn("auto")
        T.set_decode_mesh(None)


def dp_tp_mesh(dp, tp):
    return make_mesh(dp=dp, tp=tp, devices=list(range(dp * tp)))


def gather_cols(t, group):
    """Every rank's column shard of `t` concatenated (rank order)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# tensor and data parallel forwards


def sharded_forward(rank, world, cfg_spec, tree, toks, dp, tp, ep=False, capacity=None,
                    backend=None):
    cfg = cfg_of(cfg_spec)
    mesh = dp_tp_mesh(dp, tp)
    if not in_mesh(mesh):
        return None
    with switches(backend, capacity):
        sharded = shard_params(tree_of(tree), mesh, cfg, expert_parallel=ep)
        return make_sharded_forward(cfg, mesh)(sharded, torch.from_numpy(toks)).float().numpy()


def sharded_moe_rows(rank, world, cfg_spec, tree, toks, dp, tp, ep=False, routed_above=64):
    """`sharded_forward` under the recorder, the MoE's switch set at
    `routed_above` rows: (logits, the rank's MoE rows computed, the picks
    they serve, each MoE call's picks by expert `[E]`)."""
    per_call, topk, above = [], T._moe_topk, T.MOE_ROUTED_ABOVE

    def recording_topk(p, x, cfg):
        out = topk(p, x, cfg)
        per_call.append(torch.bincount(out[1].reshape(-1), minlength=cfg.num_experts).tolist())
        return out

    T._moe_topk, T.MOE_ROUTED_ABOVE = recording_topk, routed_above
    try:
        with profiling.recording():
            out = sharded_forward(rank, world, cfg_spec, tree, toks, dp, tp, ep=ep)
            counts = profiling.recorded()["counts"]
    finally:
        T._moe_topk, T.MOE_ROUTED_ABOVE = topk, above
    if out is None:
        return None
    return out, int(counts["moe.rows_computed"]), int(counts["moe.rows_routed"]), per_call


def shard_shapes(rank, world, cfg_spec, tree, dp, tp, ep=False):
    cfg = cfg_of(cfg_spec)
    mesh = dp_tp_mesh(dp, tp)
    if not in_mesh(mesh):
        return None
    sharded = shard_params(tree_of(tree), mesh, cfg, expert_parallel=ep)
    layers = sharded["layers"]
    w = layers["experts"]["gate"]["w"] if "experts" in layers else layers["gate"]["w"]
    return tuple((w.data if hasattr(w, "data") else w).shape)


def lwc_train(rank, world, cfg_spec, tree, toks, dp, tp, spec_kw, steps=2):
    from llama3_quantization_tpu_torch.parallel.train import init_model_lwc, make_lwc_train_step

    cfg = cfg_of(cfg_spec)
    mesh = dp_tp_mesh(dp, tp)
    if not in_mesh(mesh):
        return None
    params = shard_params(tree_of(tree), mesh, cfg)
    wspec = QuantSpec(**spec_kw)
    lwc = init_model_lwc(params, cfg, wspec)
    opt, step = make_lwc_train_step(cfg, mesh, wspec)
    state = opt.init(lwc)
    cur, losses = lwc, []
    for _ in range(steps):
        cur, state, loss = step(cur, state, params, torch.from_numpy(toks))
        losses.append(float(loss))
    moved = sum(float((a - b).abs().sum()) for name in lwc for a, b in
                zip(lwc[name].values(), cur[name].values()))
    return losses, moved


def tp_overlap(rank, world, cfg_spec, tree, toks, tp, backend=None):
    cfg = cfg_of(cfg_spec)
    mesh = dp_tp_mesh(1, tp)
    if not in_mesh(mesh):
        return None
    with switches(backend):
        return make_tp_overlap_forward(cfg, mesh)(tree_of(tree), torch.from_numpy(toks)).float().numpy()


def pipeline(rank, world, cfg_spec, tree, toks, pp, n_micro, backend=None):
    cfg = cfg_of(cfg_spec)
    mesh = named_mesh((pp,), ("pp",), ranks=range(pp), device="cpu")
    if not in_mesh(mesh):
        return None
    with switches(backend):
        stage = shard_params_pipeline(tree_of(tree), mesh, cfg)
        return make_pipeline_forward(cfg, mesh, n_micro)(stage, torch.from_numpy(toks)).float().numpy()


# ---------------------------------------------------------------------------
# sequence parallel


def sp_mesh(sp):
    return named_mesh((sp,), ("sp",), ranks=range(sp), device="cpu")


def sp_forward(rank, world, cfg_spec, tree, toks, sp, rq_specs=None, backend=None):
    cfg = cfg_of(cfg_spec)
    mesh = sp_mesh(sp)
    if not in_mesh(mesh):
        return None
    with switches(backend):
        fwd = make_sp_forward(cfg, mesh, rq_of(rq_specs))
        return fwd(tree_of(tree), torch.from_numpy(toks)).float().numpy()


def sp_refusals(rank, world, cfg_spec, tree, toks, sp):
    """The ring's refusals: an LWC p-spec at construction, a group that
    straddles ring blocks at the call. Returns the two messages."""
    cfg = cfg_of(cfg_spec)
    mesh = sp_mesh(sp)
    if not in_mesh(mesh):
        return None
    out = []
    try:
        make_sp_forward(cfg, mesh, rq_of({"p": dict(n_bits=8, lwc=True)}))
    except NotImplementedError as e:
        out.append(str(e))
    bad = make_sp_forward(cfg, mesh, rq_of({"p": dict(n_bits=8, group_size=3)}))
    try:
        bad(tree_of(tree), torch.from_numpy(toks))
    except NotImplementedError as e:
        out.append(str(e))
    return out


def ring_direct(rank, world, q, k, v, sp):
    mesh = sp_mesh(sp)
    if not in_mesh(mesh):
        return None
    s_loc = q.shape[1] // sp
    me = slice(rank * s_loc, (rank + 1) * s_loc)
    local = [torch.from_numpy(np.ascontiguousarray(a[:, me])) for a in (q, k, v)]
    group = mesh.get_group("sp")
    out = ring_attention(*local, group)
    parts = [torch.empty_like(out) for _ in range(sp)]
    dist.all_gather(parts, out.contiguous(), group=group)
    return torch.cat(parts, dim=1).float().numpy()


def sp_ppl(rank, world, cfg_spec, tree, stream, seqlen, sp):
    from llama3_quantization_tpu_torch.eval.ppl import compute_ppl, sp_windowed_nll_fn

    cfg = cfg_of(cfg_spec)
    mesh = sp_mesh(sp)
    if not in_mesh(mesh):
        return None
    return compute_ppl(tree_of(tree), cfg, stream, seqlen=seqlen,
                       step_fn=sp_windowed_nll_fn(cfg, mesh))


# ---------------------------------------------------------------------------
# collective matmuls and sharded GPTQ


def collective_matmuls(rank, world, x, w, wq_tree, tp):
    from llama3_quantization_tpu_torch.parallel.sharding import _col_qtensor, _Cut, _row_qtensor

    mesh = dp_tp_mesh(1, tp)
    if not in_mesh(mesh):
        return None
    group = mesh.get_group("tp")
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    wq = tree_of({"w": wq_tree})["w"]
    cut = _Cut(tp, rank)
    s_loc, k_loc = x.shape[0] // tp, x.shape[1] // tp
    x_rows = xt[rank * s_loc : (rank + 1) * s_loc]
    x_cols = xt[:, rank * k_loc : (rank + 1) * k_loc].contiguous()
    w_rows = wt[rank * k_loc : (rank + 1) * k_loc]
    outs = []
    with switches("xla"):  # JAX's default backend, the reference's route
        pairs = [(cut.cols(wt), w_rows), (_col_qtensor(wq, cut), _row_qtensor(wq, cut))]
    for w_col, w_row in pairs:
        with switches("xla"):
            ag = ag_matmul(x_rows, w_col, group)  # [S, N/P]
            rs = rs_matmul(x_cols, w_row, group)  # [S/P, N]
        parts = [torch.empty_like(rs) for _ in range(tp)]
        dist.all_gather(parts, rs, group=group)
        outs += [gather_cols(ag, group).float().numpy(), torch.cat(parts).float().numpy()]
    return outs


def sharded_gptq(rank, world, W, X, spec_kw, blocksize, tp, dp):
    from llama3_quantization_tpu_torch.parallel import (
        sharded_gptq_quantize_weight,
        sharded_hessian_update,
    )
    from llama3_quantization_tpu_torch.quant.gptq import hessian_init

    dmesh = named_mesh((dp,), ("dp",), ranks=range(dp), device="cpu")
    tmesh = named_mesh((tp,), ("tp",), ranks=range(tp), device="cpu")
    K = W.shape[0]
    H = torch.zeros((K, K))
    nsamples = 0
    if in_mesh(dmesh):
        hs = sharded_hessian_update(hessian_init(K), torch.from_numpy(X), dmesh, axis="dp")
        H, nsamples = hs.H, hs.nsamples
    dist.broadcast(H, 0)  # the replicated Hessian every tp rank solves against
    if not in_mesh(tmesh):
        return None
    qt, err = sharded_gptq_quantize_weight(torch.from_numpy(W), H, QuantSpec(**spec_kw), tmesh,
                                           blocksize=blocksize, pack=True)
    group = tmesh.get_group("tp")
    return {"data": gather_cols(qt.data, group).numpy(),
            "scale": gather_cols(qt.scale, group).float().numpy(),
            "zero": gather_cols(qt.zero, group).float().numpy(),
            "err": float(err), "H": H.numpy(), "nsamples": nsamples}


# ---------------------------------------------------------------------------
# decode, generate and serving on rank-local trees


def decode_steps(rank, world, cfg_spec, tree, toks, dp, tp, quantized, shard=True,
                 decode_mesh=True, kernel=True, row_local=False):
    """A 4-token prefill and single-token steps through `decode_step`; the
    logits of each step and the launch counts."""
    cfg = cfg_of(cfg_spec)
    mesh = dp_tp_mesh(dp, tp)
    if not in_mesh(mesh):
        return None
    with switches():
        T.set_decode_kernel(kernel)
        T.set_decode_mesh(mesh if decode_mesh else None)
        launches.reset()
        params = tree_of(tree)
        p = shard_params(params, mesh, cfg) if shard else params
        b = toks.shape[0]
        cache = T.init_kv_cache(cfg, b, 16, quantized=quantized, device="cpu")
        if row_local:
            cache = shard_kv_cache(cache, p, cfg)
        t = torch.from_numpy(toks)
        lg, cache = T.decode_step(p, cache, t[:, :4], 0, cfg)
        seq = [lg[:, -1]]
        for i in range(4, t.shape[1]):
            lg, cache = T.decode_step(p, cache, t[:, i : i + 1], i, cfg)
            seq.append(lg[:, 0])
        return torch.stack(seq).float().numpy(), launches.snapshot()


def generate(rank, world, cfg_spec, tree, first, n_steps, dp, tp, backend=None):
    cfg = cfg_of(cfg_spec)
    mesh = dp_tp_mesh(dp, tp)
    if not in_mesh(mesh):
        return None
    with switches(backend):
        p = shard_params(tree_of(tree), mesh, cfg)
        cache = T.init_kv_cache(cfg, first.shape[0], 32, device="cpu")
        toks, _ = T.greedy_generate(p, cache, torch.from_numpy(first), 0, n_steps, cfg)
        return toks.numpy()


def serve(rank, world, cfg_spec, tree, dp, tp, requests, quantized=False, decode_mesh=False,
          decode_attn="auto", step_tokens=0):
    """`ServingEngine(2 slots, 64)` on a rank-local tree: `run()` on
    `add_request`s (step_tokens 0) or `run_pipelined(step_tokens)` on
    submitted ones. Returns the streams in request order and the windows."""
    from llama3_quantization_tpu_torch.models.windowed import windowed_ok
    from llama3_quantization_tpu_torch.serving import ServingEngine

    cfg = cfg_of(cfg_spec)
    mesh = dp_tp_mesh(dp, tp)
    if not in_mesh(mesh):
        return None
    with switches():
        T.set_decode_attn(decode_attn)
        T.set_decode_mesh(mesh if decode_mesh else None)
        p = shard_params(tree_of(tree), mesh, cfg)
        eng = ServingEngine(p, cfg, max_slots=2, max_len=64, quantized_cache=quantized,
                            device="cpu")
        win = windowed_ok(cfg, eng.cache, eng._rq, eng._sink_tokens)
        if step_tokens:
            for prompt, n in requests:
                eng.submit(prompt, n, None)
            eng.run_pipelined(step_tokens)
            streams = [list(r.generated) for _, r in sorted(eng.requests.items())]
        else:
            rids = [eng.add_request(prompt, n) for prompt, n in requests]
            eng.run()
            streams = [eng.result(r) for r in rids]
        return streams, win, dict(eng.dispatches), tuple(eng.cache[next(iter(eng.cache))].shape)


# ---------------------------------------------------------------------------
# seq2seq, checkpoints, the pod mesh, scaling, the CLI


def seq2seq_forward(rank, world, cfg_kw, tree, enc, dec, dp, tp, backend=None):
    from llama3_quantization_tpu_torch.models.seq2seq import Seq2SeqConfig, forward_logits_seq2seq
    from llama3_quantization_tpu_torch.parallel import shard_params_seq2seq

    cfg = Seq2SeqConfig(**cfg_kw)
    mesh = dp_tp_mesh(dp, tp)
    if not in_mesh(mesh):
        return None
    sharded = shard_params_seq2seq(tree_of(tree), mesh)
    with torch.inference_mode(), switches(backend):
        return forward_logits_seq2seq(sharded, torch.from_numpy(enc), torch.from_numpy(dec),
                                      cfg).float().numpy()


def checkpoint_roundtrip(rank, world, cfg_spec, tree, path, toks, dp, tp, backend=None):
    """Save a rank-local tree with `save_checkpoint_sharded` from every rank
    and restore it into a zeroed tree of the same shapes: every leaf and the
    sharded forward bit for bit."""
    from llama3_quantization_tpu_torch.models.hf_loader import (
        load_checkpoint_sharded,
        save_checkpoint_sharded,
    )
    from llama3_quantization_tpu_torch.utils.pytree_io import _unflatten, tree_leaves

    cfg = cfg_of(cfg_spec)
    mesh = dp_tp_mesh(dp, tp)
    sharded = shard_params(tree_of(tree), mesh, cfg)
    save_checkpoint_sharded(sharded, path)
    body = {k: v for k, v in sharded.items() if k != "shard"}
    like = _unflatten(body, iter(torch.zeros_like(t) for t in tree_leaves(body)))
    like["shard"] = sharded["shard"]
    got = load_checkpoint_sharded(path, like)
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(tree_leaves(body), tree_leaves({k: v for k, v in got.items()
                                                               if k != "shard"})))
    fwd = make_sharded_forward(cfg, mesh)
    t = torch.from_numpy(toks)
    with switches(backend):
        out = fwd(got, t)
        return same, bool(torch.equal(out, fwd(sharded, t))), out.float().numpy()


def pod_mesh(rank, world, local_world, tp=None):
    from llama3_quantization_tpu_torch.parallel.distributed import make_pod_mesh

    os.environ["LOCAL_WORLD_SIZE"] = str(local_world)
    try:
        return mesh_shape(make_pod_mesh(tp=tp))
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]


def pod_smoke(rank, world, cfg_spec, qtree, tree, toks, train_toks, local_world, backend=None):
    """`tools/dcn_smoke.py`'s legs on a pod mesh (dp over hosts of
    `local_world` ranks, tp inside one): a sharded quantized forward and one
    sharded LWC calibration step."""
    from llama3_quantization_tpu_torch.parallel.distributed import make_pod_mesh
    from llama3_quantization_tpu_torch.parallel.train import init_model_lwc, make_lwc_train_step

    cfg = cfg_of(cfg_spec)
    os.environ["LOCAL_WORLD_SIZE"] = str(local_world)
    try:
        mesh = make_pod_mesh()
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    with switches(backend):
        out = make_sharded_forward(cfg, mesh)(shard_params(tree_of(qtree), mesh, cfg),
                                              torch.from_numpy(toks))
    params = shard_params(tree_of(tree), mesh, cfg)
    wspec = QuantSpec(n_bits=4, group_size=32, lwc=True)
    lwc = init_model_lwc(params, cfg, wspec)
    opt, step = make_lwc_train_step(cfg, mesh, wspec)
    _, _, loss = step(lwc, opt.init(lwc), params, torch.from_numpy(train_toks))
    return mesh_shape(mesh), out.float().numpy(), float(loss)


def scaling(rank, world, cfg_spec, tree, counts, seq, batch_per_device, iters, tp_per_group):
    from llama3_quantization_tpu_torch.benchmarks import measure_scaling

    return measure_scaling(tree_of(tree), cfg_of(cfg_spec), device_counts=counts, seq=seq,
                           batch_per_device=batch_per_device, iters=iters,
                           tp_per_group=tp_per_group)


def cli_main(rank, world, tree, argv):
    """`cli.main(argv)` on this rank under JAX's default backend ("xla"),
    `--net`'s parameters JAX's (`tree`), as `test_torch_cli` gives them."""
    from llama3_quantization_tpu_torch import cli
    from llama3_quantization_tpu_torch.models import params as TP

    real = TP.init_params
    TP.init_params = lambda cfg, gen, dtype, device: tree_of(tree)
    try:
        with switches("xla"):
            return cli.main(argv)
    except (ValueError, SystemExit) as e:
        return f"{type(e).__name__}: {e}"
    finally:
        TP.init_params = real
