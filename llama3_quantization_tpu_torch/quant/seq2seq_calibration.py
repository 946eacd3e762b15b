"""Seq2seq (T5-family) GPTQ calibration, encoder and decoder streamed:
port of `llama3_quantization_tpu/quant/seq2seq_calibration.py`.

The decoder-only layer-streaming schedule (`quant/calibration.py`) on the
encoder-decoder trunk, so that `api.quantize(method="gptq")` covers
seq2seq models too:

1. stream the encoder: per block, capture every linear's input (self
   q/k/v share one buffer, wi0/wi1 one), accumulate Hessians, GPTQ-solve,
   then run the quantized block to make the next block's stream;
2. the quantized encoder's final hidden state feeds the decoder phase:
   cross-attention k/v read that same tensor in every decoder block, so
   their shared Hessian is accumulated once and reused by every block's
   ck/cv solve;
3. stream the decoder blocks the same way (self q/k/v, o, cq, co, wi*/wo),
   teacher-forced on the decoder tokens given.

Capture and propagation run under the "xla" backend (dequantize, then
matmul), as JAX pins them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.seq2seq import (
    NO_QUANT,
    Seq2SeqConfig,
    _attend,
    _causal,
    _pad_mask,
    _position_bias,
    _rms,
    _t5_attention,
    _t5_mlp,
)
from ..ops.matmul import backend, qlinear
from .calibration import _layer_slice, _stack_layers
from .gptq import HessianState, gptq_quantize_weight, hessian_init, hessian_update
from .quantizer import QuantSpec


def _attn_capture(lp, x, kv, bm, cfg, rq, prefix=""):
    """`_t5_attention` with the o-projection's input exposed."""
    b, s, _ = x.shape
    t = kv.shape[1]
    h, dk = cfg.num_heads, cfg.d_kv
    q = qlinear(x, lp[prefix + "q"], None, rq.act).reshape(b, s, h, dk)
    k = qlinear(kv, lp[prefix + "k"], None, rq.act).reshape(b, t, h, dk)
    v = qlinear(kv, lp[prefix + "v"], None, rq.act).reshape(b, t, h, dk)
    o_in = _attend(q, k, v, bm, x.dtype)
    return qlinear(o_in, lp[prefix + "o"], None, rq.act), o_in


def _mlp_capture(lp, x, cfg, rq):
    """`_t5_mlp` with the wo-projection's input exposed."""
    if cfg.gated_act:
        g = F.gelu(qlinear(x, lp["wi0"], None, rq.act), approximate="tanh")
        wo_in = g * qlinear(x, lp["wi1"], None, rq.act)
    else:
        wo_in = F.relu(qlinear(x, lp["wi"], None, rq.act))
    return qlinear(wo_in, lp["wo"], None, rq.act), wo_in


def _enc_names(cfg: Seq2SeqConfig) -> List[str]:
    mlp = ["wi0", "wi1"] if cfg.gated_act else ["wi"]
    return ["q", "k", "v", "o"] + mlp + ["wo"]


def _dec_names(cfg: Seq2SeqConfig) -> List[str]:
    return _enc_names(cfg) + ["cq", "ck", "cv", "co"]


def seq2seq_capture_aliases(cfg: Seq2SeqConfig) -> Dict[str, str]:
    """Linears reading the same activation buffer (one Hessian each): self
    k/v off q's input, wi1 off wi0's, cross cv off ck's (both read the
    encoder output)."""
    al = {"k": "q", "v": "q", "cv": "ck"}
    if cfg.gated_act:
        al["wi1"] = "wi0"
    return al


@torch.no_grad()
def gptq_quantize_seq2seq(
    params,
    cfg: Seq2SeqConfig,
    enc_tokens: np.ndarray,  # [n, S]
    dec_tokens: np.ndarray,  # [n, T] (start-shifted decoder input ids)
    spec: QuantSpec,
    blocksize: int = 128,
    percdamp: float = 0.01,
    actorder: bool = False,
    pack: bool = True,
    batch_size: int = 8,
    progress: Optional[Callable[[int, int, Dict[str, float]], None]] = None,
):
    """Sequential GPTQ over encoder then decoder blocks
    (`seq2seq_calibration.py:103-286`): a new tree with every block linear
    a GPTQ `QuantizedTensor`; embeddings, norms, relative-bias tables and
    `lm_head` stay dense. `progress(done, total, errors)` after each
    block."""
    rq = NO_QUANT
    eps = cfg.layer_norm_eps
    shared = params["shared"]
    dev = shared.device
    enc_toks = torch.as_tensor(np.asarray(enc_tokens), dtype=torch.long).to(dev)
    dec_toks = torch.as_tensor(np.asarray(dec_tokens), dtype=torch.long).to(dev)
    n, s = enc_toks.shape
    t = dec_toks.shape[1]
    bs = min(batch_size, n)
    aliases = seq2seq_capture_aliases(cfg)

    enc_mask = _pad_mask(enc_toks, cfg.pad_token_id)  # [n, 1, 1, S]
    bias_enc = _position_bias(params["enc_rel"], s, s, True, cfg, torch.float32)
    bias_dec = _position_bias(params["dec_rel"], t, t, False, cfg, torch.float32) + _causal(t, dev)

    h_list = [shared[enc_toks[b0 : b0 + bs]] for b0 in range(0, n, bs)]
    m_list = [enc_mask[b0 : b0 + bs] for b0 in range(0, n, bs)]

    def enc_capture(lp, hb, mb):
        with backend("xla"):
            caps: Dict[str, torch.Tensor] = {}
            x1 = _rms(lp["ln1"], hb, eps)
            caps["q"] = x1
            attn, caps["o"] = _attn_capture(lp, x1, x1, bias_enc + mb, cfg, rq)
            x2 = _rms(lp["ln2"], hb + attn, eps)
            caps["wi0" if cfg.gated_act else "wi"] = x2
            _, caps["wo"] = _mlp_capture(lp, x2, cfg, rq)
        return {k: v for k, v in caps.items() if k not in aliases}

    def enc_fwd(lp, hb, mb):
        with backend("xla"):
            x = _rms(lp["ln1"], hb, eps)
            hb = hb + _t5_attention(lp, x, x, bias_enc + mb, cfg, rq)
            x = _rms(lp["ln2"], hb, eps)
            return hb + _t5_mlp(lp, x, cfg, rq)

    def dec_capture(lp, hb, eh, mb):
        with backend("xla"):
            caps: Dict[str, torch.Tensor] = {}
            x1 = _rms(lp["ln1"], hb, eps)
            caps["q"] = x1
            attn, caps["o"] = _attn_capture(lp, x1, x1, bias_dec, cfg, rq)
            h2 = hb + attn
            x2 = _rms(lp["ln2"], h2, eps)
            caps["cq"] = x2
            cattn, caps["co"] = _attn_capture(lp, x2, eh, mb, cfg, rq, prefix="c")
            x3 = _rms(lp["ln3"], h2 + cattn, eps)
            caps["wi0" if cfg.gated_act else "wi"] = x3
            _, caps["wo"] = _mlp_capture(lp, x3, cfg, rq)
        return {k: v for k, v in caps.items() if k not in aliases}

    def dec_fwd(lp, hb, eh, mb):
        with backend("xla"):
            x = _rms(lp["ln1"], hb, eps)
            hb = hb + _t5_attention(lp, x, x, bias_dec, cfg, rq)
            x = _rms(lp["ln2"], hb, eps)
            hb = hb + _t5_attention(lp, x, eh, mb, cfg, rq, prefix="c")
            x = _rms(lp["ln3"], hb, eps)
            return hb + _t5_mlp(lp, x, cfg, rq)

    def quantize_block(q_l, names, cap_fn, cap_args, errs, extra_h=None):
        """One block: Hessians over the stream, then each linear's solve.
        `extra_h`: {name: HessianState} of linears whose Hessian was
        accumulated outside this block (the shared cross-k/v one), which
        every later block reads again."""
        canon = {m: aliases.get(m, m) for m in names}
        uses: Dict[str, int] = {}
        for rep in canon.values():
            uses[rep] = uses.get(rep, 0) + 1
        hstate: Dict[str, HessianState] = {
            rep: hessian_init(q_l[rep].shape[0], device=dev)
            for rep in uses if not (extra_h and rep in extra_h)}
        for args in zip(*cap_args):
            caps = cap_fn(q_l, *args)
            for rep in hstate:
                hstate[rep] = hessian_update(hstate[rep], caps[rep])
            del caps
        if extra_h:
            hstate.update(extra_h)
        for m in names:
            rep = canon[m]
            uses[rep] -= 1
            keep = bool(extra_h) and rep in extra_h
            H = hstate[rep].H if (uses[rep] > 0 or keep) else hstate.pop(rep).H
            qt, err = gptq_quantize_weight(q_l[m], H, spec, blocksize=blocksize,
                                           actorder=actorder, percdamp=percdamp, pack=pack)
            del H
            errs[m] = float(err)
            q_l[m] = qt
        return q_l

    # ---- encoder blocks ----
    total = cfg.num_layers + cfg.num_decoder_layers
    done = 0
    new_enc = []
    for l in range(cfg.num_layers):
        q_l = dict(_layer_slice(params["enc"]["layers"], l))
        errs: Dict[str, float] = {}
        q_l = quantize_block(q_l, _enc_names(cfg), enc_capture, (h_list, m_list), errs)
        for bi in range(len(h_list)):
            h_list[bi] = enc_fwd(q_l, h_list[bi], m_list[bi])
        new_enc.append(q_l)
        done += 1
        if progress:
            progress(done, total, errs)

    # the quantized encoder's output: the decoder's cross k/v input stream
    eh_list = [_rms(params["enc_ln"], hb, eps) for hb in h_list]
    del h_list

    # cross k/v Hessian: the same input in every decoder block, so it is
    # accumulated once and reused by all ck/cv solves
    h_cross = hessian_init(cfg.d_model, device=dev)
    for eh in eh_list:
        h_cross = hessian_update(h_cross, eh)

    d_list = [shared[dec_toks[b0 : b0 + bs]] for b0 in range(0, n, bs)]

    # ---- decoder blocks ----
    new_dec = []
    for l in range(cfg.num_decoder_layers):
        q_l = dict(_layer_slice(params["dec"]["layers"], l))
        errs = {}
        q_l = quantize_block(q_l, _dec_names(cfg), dec_capture, (d_list, eh_list, m_list), errs,
                             extra_h={"ck": h_cross})
        for bi in range(len(d_list)):
            d_list[bi] = dec_fwd(q_l, d_list[bi], eh_list[bi], m_list[bi])
        new_dec.append(q_l)
        done += 1
        if progress:
            progress(done, total, errs)

    out = dict(params)
    out["enc"] = {"layers": _stack_layers(new_enc)}
    out["dec"] = {"layers": _stack_layers(new_dec)}
    return out


def split_calib_pairs(
    calib_tokens: np.ndarray, enc_frac: float = 0.5
) -> Tuple[np.ndarray, np.ndarray]:
    """(enc, dec) calibration streams from decoder-only-style `[n, S]`
    samples: the first `enc_frac` of each row conditions the encoder, the
    rest is the teacher-forced decoder stream. As in JAX, the decoder
    stream carries no start token, though `gptq_quantize_seq2seq` documents
    start-shifted ids (a quirk mirrored, ROADMAP C)."""
    calib_tokens = np.asarray(calib_tokens)
    s = calib_tokens.shape[1]
    cut = max(1, int(s * enc_frac))
    return calib_tokens[:, :cut], calib_tokens[:, cut:]
