"""Ring attention: sequence parallelism over an `sp` mesh axis (port of
`llama3_quantization_tpu/parallel/ring_attention.py`).

Each rank holds S / sp tokens, attends its queries to K/V blocks that travel
the ring once (each step's `batch_isend_irecv` issued before the block on
hand is used), and merges the partial results with the online-softmax
recurrence in fp32, so the score matrix never exceeds [S/sp, S/sp] a rank.
Block j attends block i fully iff i < j, causally iff i == j, not at all iff
i > j (`_NEG`, finite, keeps the recurrence NaN-free). As JAX's ring is
plain `einsum`, this one is plain torch: no kernel of its own.

`make_sp_forward` runs the pre-norm decoder trunk this way (activations
sequence-sharded throughout, attention the only exchange) and gathers the
output; `eval/ppl.sp_windowed_nll_fn` is its PPL step.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..models.configs import ModelConfig
from ..models.transformer import (
    NO_QUANT,
    RuntimeQuantConfig,
    _layer_params,
    _maybe_fq,
    _norm,
    decoder_layer,
    embed,
    lm_head,
    model_rope,
)
from ..ops.collectives import all_gather_cat
from ..ops.kvcache import true_div
from ..ops.padding import pad_for_kernels
from ..quant.quantizer import fake_quant, fake_quant_dynamic, scale_zp_from_minmax
from .collective_matmul import _wait, ring_shift
from .mesh import axis_index

_NEG = -1e30  # finite mask: keeps the online-softmax recurrence NaN-free


def _masks(s: int, device):
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(s, device=device)[None, :]
    intra = torch.where(kj <= qi, 0.0, _NEG).float()
    return intra, torch.zeros_like(intra), torch.full_like(intra, _NEG)


def _block_mask(blk: int, my: int, masks):
    intra, zeros_m, neg_m = masks
    return intra if blk == my else (zeros_m if blk < my else neg_m)


def _scores(qg, kb, scale, blk, my, masks):
    sc = torch.einsum("bsgrd,btgd->bgrst", qg, kb.float()) * scale
    return sc + _block_mask(blk, my, masks)


def ring_attention(
    q: torch.Tensor,  # [B, S_loc, H, D] this rank's queries, RoPE'd
    k: torch.Tensor,  # [B, S_loc, Hkv, D]
    v: torch.Tensor,  # [B, S_loc, Hkv, D]
    group,
    rq: RuntimeQuantConfig = NO_QUANT,
) -> torch.Tensor:
    """Causal blockwise attention with K/V blocks rotating around `group`'s
    ring (`ring_attention.py:47-140`), GQA by head groups, fp32 accumulation.
    The q/k/v hooks quantize each rank's shard (their reduction axis is
    token-local); the probabilities' hook (`rq.p`) runs the two-pass ring
    (`_two_pass_pv`). LWC p-specs raise, as do grouped ones whose group
    straddles ring blocks."""
    q = _maybe_fq(q, rq.q)
    k = _maybe_fq(k, rq.k)
    v = _maybe_fq(v, rq.v)
    b, s, h, d = q.shape
    g = k.shape[2]
    rep = h // g
    sp = dist.get_world_size(group)
    my = dist.get_rank(group)
    qg = q.reshape(b, s, g, rep, d).float()
    scale = 1.0 / math.sqrt(d)
    masks = _masks(s, q.device)

    if rq.p is not None and rq.p.enabled:
        if rq.p.lwc:
            raise NotImplementedError("LWC on the p-spec is not supported under ring attention")
        if rq.p.group_size and s % rq.p.group_size:
            raise NotImplementedError(
                f"grouped rq.p needs the ring block width ({s}) to be a "
                f"multiple of group_size ({rq.p.group_size}) so groups do "
                "not straddle ring blocks"
            )
        out = _two_pass_pv(qg, k, v, masks, my, sp, scale, group, rq.p)
    else:
        acc = torch.zeros((b, g, rep, s, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, g, rep, s), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, g, rep, s), dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for r in range(sp):
            (k_next, v_next), reqs = ring_shift((kb, vb), group) if r < sp - 1 else ((kb, vb), [])
            scores = _scores(qg, kb, scale, (my - r) % sp, my, masks)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bgrst,btgd->bgrsd", p, vb.float())
            m = m_new
            _wait(reqs)
            kb, vb = k_next, v_next
        out = acc / l[..., None]
    # [b, g, rep, s, d] -> [b, s, h, d]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _two_pass_pv(qg, k, v, masks, my, sp, scale, group, p_spec):
    """Ring attention with the softmax-probabilities hook
    (`ring_attention.py:143-223`): pass 1 rotates K collecting each row's
    exact max, min and denominator; pass 2 rotates K and V, forms each
    block's normalized probabilities, quantizes them with the row's scale
    (max prob 1/l, min prob exp(mn - m)/l; grouped specs whole-group within
    a block; fix0to1 on its fixed grid) and accumulates PV with no final
    renormalization, as the eager path."""
    b, s, g, rep, d = qg.shape
    dev = qg.device
    m = torch.full((b, g, rep, s), _NEG, dtype=torch.float32, device=dev)
    mn = torch.full((b, g, rep, s), -_NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, g, rep, s), dtype=torch.float32, device=dev)
    kb = k
    for r in range(sp):
        (k_next,), reqs = ring_shift((kb,), group) if r < sp - 1 else ((kb,), [])
        sc = _scores(qg, kb, scale, (my - r) % sp, my, masks)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(sc - m_new[..., None]).sum(dim=-1)
        mn = torch.minimum(mn, sc.amin(dim=-1))
        m = m_new
        _wait(reqs)
        kb = k_next

    if p_spec.metric == "fix0to1":
        levels = 2**p_spec.n_bits - 1

        def quantize(p):
            return true_div(torch.round(p * levels), float(levels))
    elif p_spec.group_size:
        def quantize(p):
            return fake_quant_dynamic(p, p_spec)
    else:
        pmin = (torch.exp(mn - m) / l)[..., None]
        pmax = (1.0 / l)[..., None]
        p_scale, p_zp = scale_zp_from_minmax(pmin, pmax, p_spec)

        def quantize(p):
            return fake_quant(p, p_scale, p_zp, p_spec)

    acc = torch.zeros((b, g, rep, s, d), dtype=torch.float32, device=dev)
    kb, vb = k, v
    for r in range(sp):
        (k_next, v_next), reqs = ring_shift((kb, vb), group) if r < sp - 1 else ((kb, vb), [])
        p = torch.exp(_scores(qg, kb, scale, (my - r) % sp, my, masks) - m[..., None]) / l[..., None]
        acc = acc + torch.einsum("bgrst,btgd->bgrsd", quantize(p), vb.float())
        _wait(reqs)
        kb, vb = k_next, v_next
    return acc


def make_sp_forward(
    cfg: ModelConfig,
    mesh,
    rq: RuntimeQuantConfig = NO_QUANT,
    return_hidden: bool = False,
):
    """`fn(params, tokens) -> logits` (or the final hidden states with
    `return_hidden`, for the PPL loop's chunked head) with the sequence
    split over the mesh's `sp` axis (`ring_attention.py:226-279`): each
    rank runs its S / sp tokens at their absolute positions (`my * s_loc +
    arange`) through the trunk with ring attention, and the output is
    gathered along the sequence, so every rank returns [B, S, *]. Params
    are replicated; pre-norm RoPE archs; S % sp == 0."""
    if cfg.parallel_block or not cfg.uses_rope:
        raise NotImplementedError("sp forward supports pre-norm RoPE archs")
    if rq.p is not None and rq.p.enabled and rq.p.lwc:
        raise NotImplementedError("LWC on the p-spec is not supported under ring attention")
    group = mesh.get_group("sp")

    def ring(q, k, v):
        return ring_attention(q, k, v, group, rq)

    def fwd(params, tokens):
        sp = dist.get_world_size(group)
        my = axis_index(mesh, "sp")
        b, s = tokens.shape
        if s % sp:
            raise ValueError(f"S={s} does not split over sp={sp}")
        s_loc = s // sp
        with torch.inference_mode():
            params_k = pad_for_kernels(params)
            toks = tokens[:, my * s_loc : (my + 1) * s_loc]
            positions = my * s_loc + torch.arange(s_loc, device=tokens.device)[None, :]
            h = embed(params_k, toks, cfg, positions)
            cos_sin = model_rope(positions, cfg, h.dtype)
            for i in range(cfg.num_layers):
                h = decoder_layer(_layer_params(params_k["layers"], i), h, cfg, rq, cos_sin,
                                  None, attn_impl=ring)
            h = _norm(params_k["norm"], h, cfg)
            out = h if return_hidden else lm_head(params_k, h, cfg)
            return all_gather_cat(out.contiguous(), group, 1)

    return fwd
