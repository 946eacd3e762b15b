"""Megatron tensor and data parallelism: shard specs, rank-local trees and
the sharded forward (port of `llama3_quantization_tpu/parallel/sharding.py`).

The same split as JAX's: column-parallel (output features on `tp`) q/k/v,
gate/up and fc1; row-parallel (input features on `tp`) o, down and fc2; so
each attention and MLP block ends in exactly one all-reduce. JAX states it
as PartitionSpecs and lets GSPMD place the shards and the collectives; the
port states it the same way (`model_pspecs`, `PartitionSpec`) and
`shard_params` cuts each rank's own shards out of a full tree. The model's
entry points run a rank-local tree tensor parallel with no further call: it
carries its mesh (`ops/collectives.SHARD_KEY`), and `models/transformer.py`
all-reduces after o / down / fc2 and gathers a column-parallel head's
vocab shards. Under dp each rank runs its own rows of a batch.

Rank-local shapes: heads fewer than tp are replicated (rank r holds query
head r * H // tp and KV head r * Hkv // tp, as Megatron replicates KV
heads; GSPMD would split a head's columns), and of the ranks sharing a
query head only the first holds its rows of `o` (the others zeros), so the
all-reduce counts each head once; so each head count and tp divide one
another. A row shard keeps
whole groups where K / tp % group_size == 0 (JAX's `rs_matmul` requires
it; every Llama-3-8B shard at tp 2, 4, 8 does), else its rows are one
group of their own under the scale of the group they belong to;
per-column scales (one group along K) are replicated on row shards
(`sharding.py:51-57`); row-parallel biases are replicated and added
once after the all-reduce (`_bias_spec`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..models.configs import ModelConfig
from ..ops.collectives import SHARD_KEY, Shard, gather_rows, local_rows, shard_of
from ..quant.pack import pack_factor, pack_subbyte, unpack_subbyte
from ..quant.qtensor import QuantizedTensor
from .mesh import axis_index, axis_size

#: per-linear shard axis: "col" shards the output (N) axis, "row" the input
#: (K) axis of the [K, N] weight
_LINEAR_KIND = {
    "q": "col",
    "k": "col",
    "v": "col",
    "o": "row",
    "gate": "col",
    "up": "col",
    "down": "row",
    "fc1": "col",
    "fc2": "row",
}


class PartitionSpec(tuple):
    """JAX's `PartitionSpec`: one mesh axis name (or None) per array axis."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


P = PartitionSpec


def _weight_spec(value, kind: str, stacked: bool, n_lead: int = None):
    """Spec for one linear weight (array or QuantizedTensor), with leading
    stack axes (layer / expert, never sharded) (`sharding.py:37-71`)."""
    if n_lead is None:
        n_lead = 1 if stacked else 0
    lead = (None,) * n_lead
    if isinstance(value, QuantizedTensor):
        if kind == "col":
            data = scale = P(*lead, None, "tp")
        else:  # row: the packed data axis and the group axis shard
            data = P(*lead, "tp", None)
            scale = (P(*lead, None, None) if value.scale.shape[n_lead] == 1
                     else P(*lead, "tp", None))
        return dataclasses.replace(value, data=data, scale=scale,
                                   zero=None if value.zero is None else scale, g_idx=None)
    return P(*lead, None, "tp") if kind == "col" else P(*lead, "tp", None)


def _bias_spec(kind: str, stacked: bool):
    lead = (None,) if stacked else ()
    return P(*lead, "tp") if kind == "col" else P(*lead, None)


def model_pspecs(params: Dict[str, Any], cfg: ModelConfig,
                 expert_parallel: bool = False) -> Dict[str, Any]:
    """Same-structure tree of `PartitionSpec`s for a model tree
    (`sharding.py:79-150`); `expert_parallel` shards MoE expert stacks on
    their expert axis over tp instead of each expert's features."""
    specs: Dict[str, Any] = {"embed": P(None, None)}
    if "pos_embed" in params:
        specs["pos_embed"] = P(None, None)
    if "lm_head" in params:
        specs["lm_head"] = _weight_spec(params["lm_head"], "col", stacked=False)
    specs["norm"] = {k: P(None) for k in params["norm"]}
    layer_specs: Dict[str, Any] = {}
    for name, entry in params["layers"].items():
        if name == "router":
            layer_specs[name] = {"w": P(None, None, None)}
        elif name == "experts":
            if expert_parallel:
                def espec(w):
                    s = P(None, "tp", None, None)
                    if isinstance(w, QuantizedTensor):
                        return dataclasses.replace(w, data=s, scale=s,
                                                   zero=None if w.zero is None else s)
                    return s

                layer_specs[name] = {e: {"w": espec(v["w"])} for e, v in entry.items()}
            else:
                layer_specs[name] = {
                    e: {"w": _weight_spec(v["w"], _LINEAR_KIND[e], stacked=True, n_lead=2)}
                    for e, v in entry.items()
                }
        elif name in _LINEAR_KIND:
            kind = _LINEAR_KIND[name]
            e_spec: Dict[str, Any] = {"w": _weight_spec(entry["w"], kind, stacked=True)}
            if "b" in entry:
                e_spec["b"] = _bias_spec(kind, stacked=True)
            layer_specs[name] = e_spec
        else:  # norms [L, D] (+ bias)
            layer_specs[name] = {k: P(None, None) for k in entry}
    specs["layers"] = layer_specs
    return specs


def kv_cache_pspecs(cache):
    """KV cache [L, B, Hkv, T, *] (heads-major): batch on dp, KV heads on tp."""
    return {k: P(None, "dp", "tp", None, None) for k in cache}


# ---------------------------------------------------------------------------
# rank-local shards


def _narrow(x: torch.Tensor, axis: int, n_parts: int, part: int) -> torch.Tensor:
    """Part `part` of `n_parts` equal parts of `x` along `axis` (a copy);
    `x` itself when there is one part."""
    if n_parts == 1:
        return x
    size = x.shape[axis]
    if size % n_parts:
        raise ValueError(f"axis of {size} does not split into {n_parts} shards")
    w = size // n_parts
    return x.narrow(axis, part * w, w).contiguous()


@dataclasses.dataclass(frozen=True)
class _Cut:
    """Which slice a rank takes along a weight's sharded axis: `parts`
    equal parts and the rank's `part`, or one head of `head` columns (of
    `heads`) where the heads are replicated over tp."""

    parts: int
    part: int
    head: int = 0
    heads: int = 0

    def cols(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        if self.head:
            g = self.part * self.heads // self.parts
            return x.narrow(axis, g * self.head, self.head).contiguous()
        return _narrow(x, axis, self.parts, self.part)


def _head_rows(w, cut: _Cut):
    """`o`'s rows of the rank's replicated query head (`cut.head` rows of
    head r * H // tp), zero on every rank but the head's first."""
    h = cut.part * cut.heads // cut.parts
    first = cut.part == -(-h * cut.parts // cut.heads)
    if isinstance(w, QuantizedTensor):
        if w.k % cut.heads or w.g_idx is not None:
            raise ValueError("row shards of a replicated head need whole heads of K")
        if not w.group_size or cut.head % w.group_size or w.scale.shape[-2] == 1:
            raise ValueError(f"a replicated head's {cut.head} rows must keep whole groups")
        local = _row_qtensor(w, _Cut(cut.heads, h))
        return local if first else dataclasses.replace(local, scale=torch.zeros_like(local.scale))
    rows = w.narrow(-2, h * cut.head, cut.head).contiguous()
    return rows if first else torch.zeros_like(rows)


def _col_qtensor(w: QuantizedTensor, cut: _Cut) -> QuantizedTensor:
    data = cut.cols(w.data)
    scale = cut.cols(w.scale)
    zero = None if w.zero is None else cut.cols(w.zero)
    return dataclasses.replace(w, data=data, scale=scale, zero=zero, n=scale.shape[-1])


def _row_codes(w: QuantizedTensor, cut: _Cut, regroup: bool) -> torch.Tensor:
    """The rank's K rows of `w`'s data, in `w`'s storage layout; `regroup`
    where they are packed as one group of their own (the rank's rows are
    not whole groups of `w`)."""
    packed_rows = w.packed and w.bits != 3 and pack_factor(w.bits) > 1
    if not packed_rows or (w.group_size and not regroup):
        # unpacked, 8-bit, group-local packing of whole groups, or 3-bit
        # planes (8 consecutive rows a byte): the rows are a slice
        if w.bits == 3 and w.packed and (w.k // cut.parts) % 8:
            raise ValueError("3-bit planes need K/tp % 8 == 0")
        return _narrow(w.data, -2, cut.parts, cut.part)
    # byte rows mix rows a group's width apart: repack the rank's rows
    k_local = w.k // cut.parts
    lead = w.data.shape[:-2]
    out = []
    for d in w.data.reshape(-1, *w.data.shape[-2:]):
        codes = _narrow(unpack_subbyte(d, w.bits, w.k, w.group_size), 0, cut.parts, cut.part)
        out.append(pack_subbyte(codes, w.bits, k_local if w.group_size else None))
    return torch.stack(out).reshape(*lead, *out[0].shape)


def _row_qtensor(w: QuantizedTensor, cut: _Cut) -> QuantizedTensor:
    """A row (K) shard. Per-column scales are replicated; whole groups
    shard with their scales; a group split over ranks (its size a
    multiple of the shard's) becomes one group of the rank's rows with the
    group's scale, the codes repacked if packed (GSPMD splits it too)."""
    if cut.parts == 1:
        return w
    if w.g_idx is not None:
        raise NotImplementedError("act-order (g_idx) weights do not shard by rows")
    if w.k % cut.parts:
        raise ValueError(f"K={w.k} does not split into {cut.parts} row shards")
    k_local = w.k // cut.parts
    gs = w.group_size or w.k
    if w.scale.shape[-2] == 1:  # per-column
        return dataclasses.replace(
            w, data=_row_codes(w, cut, False), k=k_local,
            group_size=None if w.group_size is None else k_local)
    if k_local % gs == 0:
        def shard(t):
            return _narrow(t, -2, cut.parts, cut.part)
        regroup = False
    elif gs % k_local == 0:
        g = cut.part * k_local // gs

        def shard(t):
            return t.narrow(-2, g, 1).contiguous()
        regroup, gs = True, k_local
    else:
        raise ValueError(f"row shards of K={k_local} and groups of {gs}: neither divides the other")
    return dataclasses.replace(
        w, data=_row_codes(w, cut, regroup), scale=shard(w.scale),
        zero=None if w.zero is None else shard(w.zero), k=k_local, group_size=gs)


def _shard_weight(w, kind: str, cut: _Cut):
    """A linear weight's rank-local shard (array or QuantizedTensor)."""
    if isinstance(w, QuantizedTensor):
        return _col_qtensor(w, cut) if kind == "col" else _row_qtensor(w, cut)
    if not torch.is_tensor(w):
        raise TypeError(f"shard a tree of tensors and QuantizedTensors, not {type(w).__name__}")
    return cut.cols(w) if kind == "col" else _narrow(w, -2, cut.parts, cut.part)


def _expert_axis(w, cut: _Cut):
    """Expert parallel: the rank's E / tp whole experts of a [L, E, K, N] stack."""
    if isinstance(w, QuantizedTensor):
        return dataclasses.replace(
            w, data=_narrow(w.data, 1, cut.parts, cut.part),
            scale=_narrow(w.scale, 1, cut.parts, cut.part),
            zero=None if w.zero is None else _narrow(w.zero, 1, cut.parts, cut.part))
    return _narrow(w, 1, cut.parts, cut.part)


def mesh_shard(mesh) -> Shard:
    """This rank's `Shard` of a (dp, tp) mesh."""
    names = mesh.mesh_dim_names or ()

    def group(name):
        return mesh.get_group(name) if name in names else None

    def index(name):
        return axis_index(mesh, name) if name in names else 0

    return Shard(mesh=mesh, dp=axis_size(mesh, "dp"), dp_rank=index("dp"),
                 dp_group=group("dp"), tp=axis_size(mesh, "tp"), tp_rank=index("tp"),
                 tp_group=group("tp"))


def _check_heads(cfg: ModelConfig, tp: int) -> None:
    if cfg.num_heads % tp and tp % cfg.num_heads:
        raise ValueError(f"num_heads={cfg.num_heads} and tp={tp}: neither divides the other")
    if cfg.num_kv_heads % tp and tp % cfg.num_kv_heads:
        raise ValueError(f"num_kv_heads={cfg.num_kv_heads} and tp={tp}: neither divides "
                         "the other")


def shard_params(params, mesh, cfg: ModelConfig, expert_parallel: bool = False):
    """This rank's shards of a parameter tree per `model_pspecs`
    (`sharding.py:153-163`), carrying its `Shard`: the rank-local tree the
    model's entry points run tensor parallel. QuantizedTensor shards have
    `k` / `n` rewritten to the shard (JAX `_localize`); tensors a rank
    holds whole (embeddings, norms, the router, tp = 1) are the tree's own."""
    if shard_of(params) is not None:
        raise ValueError("the tree is already rank-local")
    shard = mesh_shard(mesh)
    tp, r = shard.tp, shard.tp_rank
    _check_heads(cfg, tp)
    even = _Cut(tp, r)
    hd = cfg.head_dim_
    kv = even if cfg.num_kv_heads % tp == 0 else _Cut(tp, r, hd, cfg.num_kv_heads)
    q = even if cfg.num_heads % tp == 0 else _Cut(tp, r, hd, cfg.num_heads)
    out = {k: v for k, v in params.items() if k not in ("layers", "lm_head")}
    if "lm_head" in params:
        out["lm_head"] = _shard_weight(params["lm_head"], "col", even)
    layers: Dict[str, Any] = {}
    for name, entry in params["layers"].items():
        if name == "experts":
            if expert_parallel:
                layers[name] = {e: {"w": _expert_axis(v["w"], even)} for e, v in entry.items()}
            else:
                layers[name] = {e: {"w": _shard_weight(v["w"], _LINEAR_KIND[e], even)}
                                for e, v in entry.items()}
        elif name in _LINEAR_KIND:
            kind = _LINEAR_KIND[name]
            cut = kv if name in ("k", "v") else q if name in ("q", "o") else even
            if name == "o" and cut.head:
                e_out = {"w": _head_rows(entry["w"], cut)}
            else:
                e_out = {"w": _shard_weight(entry["w"], kind, cut)}
            if "b" in entry:
                e_out["b"] = cut.cols(entry["b"]) if kind == "col" else entry["b"]
            layers[name] = e_out
        elif name in ("qkv", "gateup"):
            raise ValueError(f"fused {name!r} does not shard: shard before fuse_for_decode")
        else:
            layers[name] = entry
    out["layers"] = layers
    out[SHARD_KEY] = shard
    return out


def shard_kv_cache(cache: Dict[str, torch.Tensor], params, cfg: ModelConfig):
    """The rank-local cache for a rank-local tree (JAX `kv_cache_pspecs`:
    batch on dp, KV heads on tp): new tensors holding this rank's B / dp
    rows (every row where B % dp) and KV groups; `cache` itself for a
    one-replica tree."""
    from ..models.transformer import localize_kv_groups

    shard = shard_of(params)
    if shard is None:
        return cache
    out = localize_kv_groups(dict(cache), cfg, shard)
    b = next(iter(out.values())).shape[1]
    return {k: local_rows(v.transpose(0, 1), shard, b).transpose(0, 1).contiguous()
            for k, v in out.items()}


def make_sharded_forward(cfg: ModelConfig, mesh, rq=None):
    """`fn(params, tokens) -> logits` on a rank-local tree of `mesh`
    (`sharding.py:171-188`): each dp rank runs its rows tensor parallel;
    every rank returns the full logits [B, S, V]."""
    from ..models.transformer import NO_QUANT, forward_local, lm_head

    rq = rq or NO_QUANT

    def fwd(params, tokens):
        shard = shard_of(params)
        if shard is None or shard.mesh is not mesh:
            raise ValueError("make_sharded_forward runs a tree from shard_params on its mesh")
        with torch.inference_mode():
            h = forward_local(params, local_rows(tokens, shard), cfg, rq)
            return gather_rows(lm_head(params, h, cfg), shard, tokens.shape[0])

    return fwd


#: seq2seq (T5) linear kinds: the Megatron recipe of `_LINEAR_KIND`, one
#: all-reduce per attention, cross-attention and MLP block
_SEQ2SEQ_KIND = {
    "q": "col", "k": "col", "v": "col", "o": "row",
    "cq": "col", "ck": "col", "cv": "col", "co": "row",
    "wi": "col", "wi0": "col", "wi1": "col", "wo": "row",
}


def seq2seq_pspecs(params: Dict[str, Any]) -> Dict[str, Any]:
    """PartitionSpecs for a `models/seq2seq.py` tree (`sharding.py:
    191-214`): every encoder and decoder linear tensor parallel over tp,
    everything else replicated. Needs num_heads % tp == 0 and d_ff % tp == 0."""
    def side(layers):
        return {"layers": {
            name: (P(None, None) if name.startswith("ln")
                   else _weight_spec(w, _SEQ2SEQ_KIND[name], stacked=True))
            for name, w in layers.items()
        }}

    specs: Dict[str, Any] = {
        "shared": P(None, None),
        "enc": side(params["enc"]["layers"]),
        "dec": side(params["dec"]["layers"]),
        "enc_ln": P(None),
        "dec_ln": P(None),
        "enc_rel": P(None, None),
        "dec_rel": P(None, None),
    }
    if "lm_head" in params:
        specs["lm_head"] = P(None, "tp")
    return specs


def shard_params_seq2seq(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's shards of a seq2seq tree per `seq2seq_pspecs`
    (`sharding.py:217-222`), carrying its `Shard`: every seq2seq entry point
    runs it tensor parallel (the rank's heads, with their columns of the
    relative-position tables; o, co and wo all-reduced; the head gathered)."""
    if shard_of(params) is not None:
        raise ValueError("the tree is already rank-local")
    shard = mesh_shard(mesh)
    cut = _Cut(shard.tp, shard.tp_rank)

    def side(layers):
        return {"layers": {
            name: (w if name.startswith("ln") else _shard_weight(w, _SEQ2SEQ_KIND[name], cut))
            for name, w in layers.items()
        }}

    out = {k: v for k, v in params.items() if k not in ("enc", "dec", "lm_head")}
    out["enc"] = side(params["enc"]["layers"])
    out["dec"] = side(params["dec"]["layers"])
    if "lm_head" in params:
        out["lm_head"] = _shard_weight(params["lm_head"], "col", cut)
    out[SHARD_KEY] = shard
    return out
