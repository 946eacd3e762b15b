"""T5-family encoder-decoder trunk (T0, T5, FLAN): port of
`llama3_quantization_tpu/models/seq2seq.py`.

The reference reaches T0-3B through `AutoModelForSeq2SeqLM`
(`models/LMClass.py:35-39`); this is the functional trunk in the JAX
package's parameter tree: linears stacked `[L, in, out]` (a tensor or a
layer-stacked `QuantizedTensor`), each a `qlinear` call, so a quantized
tree runs its linears through B2 (M > 64: the encoder, the teacher-forced
decoder and the cross K/V) and B1 (M <= 64: each cached decode step) on
the card. The layer stacks are Python loops over layer views.

HF `modeling_t5.py` semantics, as in JAX:

- T5LayerNorm is RMSNorm with fp32 statistics, the normalized value rounded
  to the input dtype before the weight;
- attention has no 1/sqrt(d_kv) scaling; `q·k` is taken in the activation
  dtype and cast to fp32 before the additive bias and mask (padding and the
  causal mask are -1e9, not -inf); the softmax is fp32, cast back before
  `p·v`. It stays eager: the relative-position bias is an additive input
  that the flash kernels do not take, and JAX's T5 attention is eager too;
- the relative-position bias is a learned `[buckets, H]` table of the first
  block, shared by the stack; bidirectional buckets in the encoder, causal
  in the decoder, none on cross-attention. Bucket ids are computed on the
  host (they depend only on positions), so the card and the CPU give the
  same ids: CUDA divides a tensor by a Python scalar through its reciprocal;
- v1.1 "gated-gelu" MLP `wo(gelu_tanh(wi0 x) * wi1 x)`, v1.0 `wo(relu(wi x))`;
- a tied head scales the decoder output by `d_model ** -0.5` and multiplies
  by `shared`; an untied one (T0, v1.1) is `lm_head` through `qlinear`.

Generation: `greedy_generate_seq2seq` re-runs the decoder over a fixed
`[B, n_steps + 1]` buffer each step (O(T^2), the simple reference);
`greedy_generate_seq2seq_cached` computes the encoder and the cross K/V
once and appends each step's self K/V into a preallocated cache, which
`decode_step_seq2seq` updates in place.

A rank-local tree (`parallel.shard_params_seq2seq`) runs tensor parallel
with no further call: each rank's heads (the columns of q/k/v/cq/ck/cv and
wi*) with their columns of the relative-position bias, o, co and wo
all-reduced, an untied head's vocab shards gathered; the cached state holds
the rank's heads. `forward_logits_seq2seq` splits its batch over dp.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.collectives import (
    copy_tp,
    gather_rows,
    gather_tp,
    local_rows,
    reduce_tp,
    row_parallel_input,
    shard_of,
)
from ..ops.matmul import qlinear
from ..quant.qtensor import quantize_rtn
from .params import stack_qtensors
from .transformer import NO_QUANT, RuntimeQuantConfig, _layer_params

Params = Dict[str, Any]

#: the additive mask value of padding and of the causal mask
NEG = -1e9


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_heads: int = 8
    num_layers: int = 6  # encoder
    num_decoder_layers: int = 6
    rel_buckets: int = 32
    rel_max_distance: int = 128
    gated_act: bool = True  # v1.1 gated-gelu vs v1.0 relu
    tie_word_embeddings: bool = False
    layer_norm_eps: float = 1e-6
    decoder_start_token_id: int = 0
    pad_token_id: int = 0
    eos_token_id: int = 1


def _rms(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (w * (xf * torch.rsqrt(var + eps)).to(x.dtype)).to(x.dtype)


def _relative_position_bucket(
    rel: torch.Tensor, bidirectional: bool, num_buckets: int, max_distance: int
) -> torch.Tensor:
    """HF `T5Attention._relative_position_bucket` (`rel = memory_position -
    query_position`), int32 ids on `rel`'s device, computed on the host."""
    n = rel.to("cpu", torch.int32)
    ret = torch.zeros_like(n)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n > 0).to(torch.int32) * num_buckets
        n = n.abs()
    else:
        n = -torch.clamp(n, max=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return (ret + torch.where(is_small, n, val_large)).to(rel.device)


def _position_bias(
    emb: torch.Tensor,  # [buckets, H]
    qlen: int,
    klen: int,
    bidirectional: bool,
    cfg: Seq2SeqConfig,
    dtype,
) -> torch.Tensor:  # [1, H, qlen, klen]
    ctx = torch.arange(qlen)[:, None]
    mem = torch.arange(klen)[None, :]
    buckets = _relative_position_bucket(mem - ctx, bidirectional, cfg.rel_buckets,
                                        cfg.rel_max_distance)
    bias = emb[buckets.to(emb.device).long()]  # [q, k, H]
    return bias.permute(2, 0, 1)[None].to(dtype)


def _attend(q, k, v, bias_mask, dtype):
    """`softmax(fp32(q·k) + bias_mask) · v`: q [B, S, H, dk], k and v
    [B, T, H, dk] -> [B, S, H * dk]."""
    b, s, h, dk = q.shape
    scores = torch.einsum("bshd,bthd->bhst", q, k).float()
    if bias_mask is not None:
        scores = scores + bias_mask
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, h * dk)


def _row(x: torch.Tensor, w, rq: RuntimeQuantConfig, tp) -> torch.Tensor:
    """A row-parallel linear (o, co, wo): the rank's partial product,
    all-reduced over tp."""
    with row_parallel_input(tp):
        return reduce_tp(qlinear(x, w, None, rq.act), tp)


def _rank_heads(bias: torch.Tensor, cfg: Seq2SeqConfig, tp) -> torch.Tensor:
    """The columns of a `[*, H, ...]` bias (axis 1) of a tp rank's heads."""
    if tp is None or tp.tp == 1 or bias is None or bias.shape[1] != cfg.num_heads:
        return bias
    n = cfg.num_heads // tp.tp
    return bias[:, tp.tp_rank * n : (tp.tp_rank + 1) * n]


def _t5_attention(
    p: Params,
    x: torch.Tensor,  # [B, S, D] queries
    kv: torch.Tensor,  # [B, T, D] keys/values source
    bias_mask: Optional[torch.Tensor],  # [*, H or 1, S, T] additive (fp32)
    cfg: Seq2SeqConfig,
    rq: RuntimeQuantConfig,
    prefix: str = "",
    tp=None,
) -> torch.Tensor:
    b, s, _ = x.shape
    t = kv.shape[1]
    dk = cfg.d_kv
    x, kv = copy_tp(x, tp), copy_tp(kv, tp)
    q = qlinear(x, p[prefix + "q"], None, rq.act).reshape(b, s, -1, dk)
    k = qlinear(kv, p[prefix + "k"], None, rq.act).reshape(b, t, -1, dk)
    v = qlinear(kv, p[prefix + "v"], None, rq.act).reshape(b, t, -1, dk)
    return _row(_attend(q, k, v, _rank_heads(bias_mask, cfg, tp), x.dtype), p[prefix + "o"], rq, tp)


def _t5_mlp(p: Params, x: torch.Tensor, cfg: Seq2SeqConfig, rq: RuntimeQuantConfig, tp=None):
    x = copy_tp(x, tp)
    if cfg.gated_act:
        g = F.gelu(qlinear(x, p["wi0"], None, rq.act), approximate="tanh")
        u = qlinear(x, p["wi1"], None, rq.act)
        return _row(g * u, p["wo"], rq, tp)
    return _row(F.relu(qlinear(x, p["wi"], None, rq.act)), p["wo"], rq, tp)


def _pad_mask(toks: torch.Tensor, pad_id: int) -> torch.Tensor:
    """[B, T] token ids -> [B, 1, 1, T] additive fp32 (pad = -1e9)."""
    return torch.where(toks == pad_id, NEG, 0.0).float()[:, None, None, :]


def _causal(t: int, device) -> torch.Tensor:
    """[1, 1, t, t] additive fp32: 0 on and below the diagonal, -1e9 above."""
    ar = torch.arange(t, device=device)
    return torch.where(ar[:, None] >= ar[None, :], 0.0, NEG).float()[None, None]


def _embed(params: Params, toks: torch.Tensor) -> torch.Tensor:
    emb = params["shared"]
    if not isinstance(emb, torch.Tensor):
        raise ValueError("shared embedding must stay a dense array")
    return emb[toks.long()]


def _head(params: Params, h: torch.Tensor, cfg: Seq2SeqConfig, rq: RuntimeQuantConfig):
    if cfg.tie_word_embeddings:
        h = h * (cfg.d_model ** -0.5)
        return torch.einsum("btd,vd->btv", h, params["shared"].to(h.dtype))
    tp = shard_of(params)
    return gather_tp(qlinear(copy_tp(h, tp), params["lm_head"], None, rq.act), tp)


def encode(
    params: Params,
    enc_toks: torch.Tensor,  # [B, S]
    cfg: Seq2SeqConfig,
    rq: RuntimeQuantConfig = NO_QUANT,
    enc_mask: Optional[torch.Tensor] = None,  # [B, 1, 1, S] additive
) -> torch.Tensor:
    h = _embed(params, enc_toks)
    s = enc_toks.shape[1]
    bias = _position_bias(params["enc_rel"], s, s, True, cfg, torch.float32)
    bm = bias if enc_mask is None else bias + enc_mask
    eps = cfg.layer_norm_eps
    tp = shard_of(params)
    layers = params["enc"]["layers"]
    for l in range(cfg.num_layers):
        lp = _layer_params(layers, l)
        x = _rms(lp["ln1"], h, eps)
        h = h + _t5_attention(lp, x, x, bm, cfg, rq, tp=tp)
        x = _rms(lp["ln2"], h, eps)
        h = h + _t5_mlp(lp, x, cfg, rq, tp)
    return _rms(params["enc_ln"], h, eps)


def decode_logits(
    params: Params,
    dec_toks: torch.Tensor,  # [B, T] decoder input ids (start-shifted)
    enc_hidden: torch.Tensor,  # [B, S, D]
    cfg: Seq2SeqConfig,
    rq: RuntimeQuantConfig = NO_QUANT,
    enc_mask: Optional[torch.Tensor] = None,  # [B, 1, 1, S] additive
) -> torch.Tensor:
    h = _embed(params, dec_toks)
    t = dec_toks.shape[1]
    bias = _position_bias(params["dec_rel"], t, t, False, cfg, torch.float32)
    self_bm = bias + _causal(t, h.device)
    eps = cfg.layer_norm_eps
    tp = shard_of(params)
    layers = params["dec"]["layers"]
    for l in range(cfg.num_decoder_layers):
        lp = _layer_params(layers, l)
        x = _rms(lp["ln1"], h, eps)
        h = h + _t5_attention(lp, x, x, self_bm, cfg, rq, tp=tp)
        x = _rms(lp["ln2"], h, eps)
        h = h + _t5_attention(lp, x, enc_hidden, enc_mask, cfg, rq, prefix="c", tp=tp)
        x = _rms(lp["ln3"], h, eps)
        h = h + _t5_mlp(lp, x, cfg, rq, tp)
    return _head(params, _rms(params["dec_ln"], h, eps), cfg, rq)


def forward_logits_seq2seq(
    params: Params,
    enc_toks: torch.Tensor,
    dec_toks: torch.Tensor,
    cfg: Seq2SeqConfig,
    rq: RuntimeQuantConfig = NO_QUANT,
) -> torch.Tensor:
    """Teacher-forced encoder + decoder forward (the harness scoring mode);
    on a rank-local tree each dp rank runs its rows and every rank returns
    all of them."""
    tp = shard_of(params)
    b = enc_toks.shape[0]
    enc_toks, dec_toks = local_rows(enc_toks, tp), local_rows(dec_toks, tp)
    enc_mask = _pad_mask(enc_toks, cfg.pad_token_id)
    enc_h = encode(params, enc_toks, cfg, rq, enc_mask)
    return gather_rows(decode_logits(params, dec_toks, enc_h, cfg, rq, enc_mask), tp, b)


def greedy_generate_seq2seq(
    params: Params,
    enc_toks: torch.Tensor,  # [B, S]
    n_steps: int,
    cfg: Seq2SeqConfig,
    rq: RuntimeQuantConfig = NO_QUANT,
) -> torch.Tensor:  # [B, n_steps]
    """Greedy decode by re-running the decoder over a fixed `[B, n_steps +
    1]` buffer each step, filled with pad ids after the start token
    (O(T^2), the simple reference)."""
    b = enc_toks.shape[0]
    enc_mask = _pad_mask(enc_toks, cfg.pad_token_id)
    enc_h = encode(params, enc_toks, cfg, rq, enc_mask)
    buf = torch.full((b, n_steps + 1), cfg.pad_token_id, dtype=torch.long,
                     device=enc_toks.device)
    buf[:, 0] = cfg.decoder_start_token_id
    for i in range(n_steps):
        logits = decode_logits(params, buf, enc_h, cfg, rq, enc_mask)
        buf[:, i + 1] = logits[:, i, :].argmax(dim=-1)
    return buf[:, 1:]


# ----------------------------------------------------------------------
# HF checkpoint loading (T5/T0/FLAN family)


def config_from_hf_seq2seq(path: str) -> Seq2SeqConfig:
    with open(os.path.join(path, "config.json")) as f:
        c = json.load(f)
    if c.get("model_type") not in ("t5", "mt5", "longt5"):
        raise ValueError(f"not a T5-family checkpoint: {c.get('model_type')}")
    ff = c.get("feed_forward_proj", "relu")
    return Seq2SeqConfig(
        vocab_size=c["vocab_size"],
        d_model=c["d_model"],
        d_kv=c["d_kv"],
        d_ff=c["d_ff"],
        num_heads=c["num_heads"],
        num_layers=c["num_layers"],
        num_decoder_layers=c.get("num_decoder_layers", c["num_layers"]),
        rel_buckets=c.get("relative_attention_num_buckets", 32),
        rel_max_distance=c.get("relative_attention_max_distance", 128),
        gated_act=ff.startswith("gated"),
        tie_word_embeddings=c.get("tie_word_embeddings", True),
        layer_norm_eps=c.get("layer_norm_epsilon", 1e-6),
        decoder_start_token_id=c.get("decoder_start_token_id", 0) or 0,
        pad_token_id=c.get("pad_token_id", 0) or 0,
        eos_token_id=c.get("eos_token_id", 1) or 1,
    )


#: HF names of a block's tensors: ours -> theirs under `{side}.block.{i}.`
T5_ENC_NAMES = {
    "q": "layer.0.SelfAttention.q.weight",
    "k": "layer.0.SelfAttention.k.weight",
    "v": "layer.0.SelfAttention.v.weight",
    "o": "layer.0.SelfAttention.o.weight",
    "ln1": "layer.0.layer_norm.weight",
    "ln2": "layer.1.layer_norm.weight",
}
T5_DEC_NAMES = {
    **T5_ENC_NAMES,
    "cq": "layer.1.EncDecAttention.q.weight",
    "ck": "layer.1.EncDecAttention.k.weight",
    "cv": "layer.1.EncDecAttention.v.weight",
    "co": "layer.1.EncDecAttention.o.weight",
    "ln3": "layer.2.layer_norm.weight",
}


def t5_mlp_names(gated: bool, sub: int) -> Dict[str, str]:
    """The MLP's HF names in sublayer `sub` (1 in the encoder, 2 in the
    decoder)."""
    ff = f"layer.{sub}.DenseReluDense"
    if gated:
        return {"wi0": f"{ff}.wi_0.weight", "wi1": f"{ff}.wi_1.weight", "wo": f"{ff}.wo.weight"}
    return {"wi": f"{ff}.wi.weight", "wo": f"{ff}.wo.weight"}


def from_hf_seq2seq(path: str, dtype=torch.float32, device="cuda") -> Tuple[Params, Seq2SeqConfig]:
    """Load a T5-family HF checkpoint into the stacked tree on `device`,
    each weight through float32 into `dtype`. Linears transpose to `[in,
    out]` (`y = x @ W`) and stack along a leading layer axis."""
    from .hf_loader import _load_tensors

    cfg = config_from_hf_seq2seq(path)
    dev = resolve_device(device)
    raw = _load_tensors(path)

    def get(name, transpose=False):
        t = raw[name].float()
        return (t.T if transpose else t).contiguous().to(device=dev, dtype=dtype)

    def stack(prefix, n, names):
        return {ours: torch.stack([
            get(prefix.format(i=i) + theirs, not ours.startswith("ln")) for i in range(n)])
            for ours, theirs in names.items()}

    params: Params = {
        "shared": get("shared.weight"),
        "enc": {"layers": stack("encoder.block.{i}.", cfg.num_layers,
                                {**T5_ENC_NAMES, **t5_mlp_names(cfg.gated_act, 1)})},
        "dec": {"layers": stack("decoder.block.{i}.", cfg.num_decoder_layers,
                                {**T5_DEC_NAMES, **t5_mlp_names(cfg.gated_act, 2)})},
        "enc_ln": get("encoder.final_layer_norm.weight"),
        "dec_ln": get("decoder.final_layer_norm.weight"),
        "enc_rel": get("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "dec_rel": get("decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight", transpose=True)
    return params, cfg


def init_seq2seq_params(
    cfg: Seq2SeqConfig, generator: torch.Generator, dtype=torch.float32, device="cuda"
) -> Params:
    """Seeded random parameters in `from_hf_seq2seq`'s tree (JAX's
    `init_seq2seq_params`, `seq2seq.py:378-424`): normal linears scaled by
    0.4 / sqrt(in), unit norms, a 0.5-scaled `shared`, 0.1-scaled
    relative-bias tables, drawn in JAX's leaf order. `generator` must live
    on `device`; its draws are not JAX's."""
    dev = resolve_device(device)
    d, dk, ff, h = cfg.d_model, cfg.d_kv, cfg.d_ff, cfg.num_heads

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return (x * std).to(dtype)

    def lin(n, i, o):
        return normal((n, i, o), 0.4 / math.sqrt(i))

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def side(n, cross):
        p = {"q": lin(n, d, h * dk), "k": lin(n, d, h * dk), "v": lin(n, d, h * dk),
             "o": lin(n, h * dk, d), "ln1": ones(n, d), "ln2": ones(n, d)}
        if cross:
            p.update(cq=lin(n, d, h * dk), ck=lin(n, d, h * dk), cv=lin(n, d, h * dk),
                     co=lin(n, h * dk, d), ln3=ones(n, d))
        if cfg.gated_act:
            p.update(wi0=lin(n, d, ff), wi1=lin(n, d, ff), wo=lin(n, ff, d))
        else:
            p.update(wi=lin(n, d, ff), wo=lin(n, ff, d))
        return {"layers": p}

    params: Params = {
        "shared": normal((cfg.vocab_size, d), 0.5),
        "enc": side(cfg.num_layers, cross=False),
        "dec": side(cfg.num_decoder_layers, cross=True),
        "enc_ln": ones(d),
        "dec_ln": ones(d),
        "enc_rel": normal((cfg.rel_buckets, h), 0.1),
        "dec_rel": normal((cfg.rel_buckets, h), 0.1),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), 0.4 / math.sqrt(d))
    return params


def quantize_seq2seq_rtn(params: Params, cfg: Seq2SeqConfig, spec, pack=True) -> Params:
    """RTN-quantize every stacked linear, layer by layer, into layer-stacked
    `QuantizedTensor`s; embeddings, norms, the relative-bias tables and
    `lm_head` stay dense (the reference keeps the head unquantized)."""
    out = dict(params)
    for side in ("enc", "dec"):
        out[side] = {"layers": {
            name: w if name.startswith("ln")
            else stack_qtensors([quantize_rtn(w[i], spec, pack=pack) for i in range(w.shape[0])])
            for name, w in params[side]["layers"].items()}}
    return out


# ----------------------------------------------------------------------
# Incremental (KV-cached) decoding: the encoder and the cross K/V once,
# each step's self K/V appended into a preallocated cache


def init_seq2seq_state(
    params: Params,
    enc_toks: torch.Tensor,  # [B, S]
    max_new: int,
    cfg: Seq2SeqConfig,
    rq: RuntimeQuantConfig = NO_QUANT,
) -> Dict[str, torch.Tensor]:
    """Encode, project the cross K/V of every decoder layer (`[L, B, S, H,
    dk]`), and allocate the self cache `[L, B, max_new + 1, H, dk]` in the
    activation dtype."""
    b, s = enc_toks.shape
    tp = shard_of(params)
    h, dk = cfg.num_heads // (1 if tp is None else tp.tp), cfg.d_kv
    enc_mask = _pad_mask(enc_toks, cfg.pad_token_id)
    enc_h = encode(params, enc_toks, cfg, rq, enc_mask)
    layers = params["dec"]["layers"]
    ck, cv = [], []
    for l in range(cfg.num_decoder_layers):
        lp = _layer_params(layers, l)
        ck.append(qlinear(enc_h, lp["ck"], None, rq.act).reshape(b, s, h, dk))
        cv.append(qlinear(enc_h, lp["cv"], None, rq.act).reshape(b, s, h, dk))
    L = cfg.num_decoder_layers
    cache = (L, b, max_new + 1, h, dk)
    return {
        "enc_h": enc_h,
        "enc_mask": enc_mask,
        "cross_k": torch.stack(ck),
        "cross_v": torch.stack(cv),
        "self_k": torch.zeros(cache, dtype=enc_h.dtype, device=enc_h.device),
        "self_v": torch.zeros(cache, dtype=enc_h.dtype, device=enc_h.device),
    }


def decode_step_seq2seq(
    params: Params,
    state: Dict[str, torch.Tensor],
    tok: torch.Tensor,  # [B, 1]
    pos: int,  # decoder position of `tok`
    cfg: Seq2SeqConfig,
    rq: RuntimeQuantConfig = NO_QUANT,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder step over the cached state -> (logits [B, 1, V], state).
    The step's self K/V are written into `state` in place; its attention
    covers all `t_max` cached positions, those after `pos` masked (-1e9)."""
    b = tok.shape[0]
    tp = shard_of(params)
    h, dk = state["self_k"].shape[3], cfg.d_kv
    t_max = state["self_k"].shape[2]
    x = _embed(params, tok)  # [B, 1, D]
    eps = cfg.layer_norm_eps
    # the relative bias of a query at `pos` against keys 0..t_max-1
    mem = torch.arange(t_max)
    buckets = _relative_position_bucket(mem - pos, False, cfg.rel_buckets, cfg.rel_max_distance)
    bias = params["dec_rel"][buckets.to(x.device).long()].T[None, :, None, :]
    causal = torch.where(mem <= pos, 0.0, NEG).float().to(x.device)
    self_bm = _rank_heads(bias.float() + causal, cfg, tp)  # [1, H, 1, T]
    layers = params["dec"]["layers"]
    for l in range(cfg.num_decoder_layers):
        lp = _layer_params(layers, l)
        sk, sv = state["self_k"][l], state["self_v"][l]
        xa = _rms(lp["ln1"], x, eps)
        q = qlinear(xa, lp["q"], None, rq.act).reshape(b, 1, h, dk)
        sk[:, pos] = qlinear(xa, lp["k"], None, rq.act).reshape(b, h, dk)
        sv[:, pos] = qlinear(xa, lp["v"], None, rq.act).reshape(b, h, dk)
        x = x + _row(_attend(q, sk, sv, self_bm, x.dtype), lp["o"], rq, tp)

        xc = _rms(lp["ln2"], x, eps)
        qc = qlinear(xc, lp["cq"], None, rq.act).reshape(b, 1, h, dk)
        oc = _attend(qc, state["cross_k"][l], state["cross_v"][l], state["enc_mask"], x.dtype)
        x = x + _row(oc, lp["co"], rq, tp)

        xm = _rms(lp["ln3"], x, eps)
        x = x + _t5_mlp(lp, xm, cfg, rq, tp)
    return _head(params, _rms(params["dec_ln"], x, eps), cfg, rq), state


def greedy_generate_seq2seq_cached(
    params: Params,
    enc_toks: torch.Tensor,  # [B, S]
    n_steps: int,
    cfg: Seq2SeqConfig,
    rq: RuntimeQuantConfig = NO_QUANT,
) -> torch.Tensor:  # [B, n_steps]
    """O(T) greedy decode over the cached state: one encoder pass, one
    cross-K/V projection, a self-cache append per step."""
    b = enc_toks.shape[0]
    state = init_seq2seq_state(params, enc_toks, n_steps, cfg, rq)
    tok = torch.full((b, 1), cfg.decoder_start_token_id, dtype=torch.long,
                     device=enc_toks.device)
    out = []
    for i in range(n_steps):
        logits, state = decode_step_seq2seq(params, state, tok, i, cfg, rq)
        tok = logits[:, 0, :].argmax(dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
