"""Plain PyTorch reference of the decoder families the benchmark runs:
Llama and Mixtral (RMSNorm, RoPE, grouped-query attention, SwiGLU or a
top-k mixture of experts) and Falcon (LayerNorm, RoPE, multi-query
attention, attention and MLP in parallel off one norm).

Everything is fp32 with TF32 off, in plain `torch` operations: no kernel,
no cache, no batching tricks. (`dtype=torch.bfloat16` runs the same
operations in bf16, with reduced-precision reductions allowed: a plain
bf16 model, read beside the program as a witness; the logits come out
in fp32 either way.) The weights are drawn again from the run's
seed by `portbench/weights.py`, one layer at a time, and dequantized here
from their codes, so the reference holds one layer in fp32 at a time and
takes nothing that the program made. It computes its own routing: softmax
over the router's logits, the top `num_experts_per_tok`, renormalised.

Departures from the published models, each shared with the program as the
configuration states it: Falcon's gelu is the tanh form (the port's
`activation: gelu`) and its LayerNorm eps 1e-5.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

from .. import weights as W


def _rms(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * p["w"].to(x.dtype)


def _layer_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["w"].to(x.dtype) + p["b"].to(x.dtype)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..S-1 on x [B, S, H, D] (rotate-half form)."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = torch.cat([ang, ang], -1).cos().to(x.dtype)
    sin = torch.cat([ang, ang], -1).sin().to(x.dtype)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos[:, None] + rot * sin[:, None]


class Reference:
    """The reference model of configuration `cfg` with the weights of
    `seed`, on `device`, computed in `dtype`."""

    def __init__(self, cfg: dict, seed: int, device, dtype=torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            dtype == torch.bfloat16)
        self.cfg, self.model, self.seed, self.dtype = cfg, cfg["model"], seed, dtype
        self.device = torch.device(device)
        m = self.model
        self.hd = m.get("head_dim") or m["hidden_size"] // m["num_heads"]
        self.rms = m["arch"] in ("llama", "mixtral")

    def _norm(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        return _rms(x, p, self.model["rms_norm_eps"]) if self.rms else _layer_norm(x, p)

    def _linear(self, x: torch.Tensor, layer: int, name: str) -> torch.Tensor:
        w = W.dequant(*W.quant_linear(self.cfg, self.seed, layer, name, self.device))
        return x @ w.to(self.dtype)

    def _attention(self, x: torch.Tensor, layer: int) -> torch.Tensor:
        m = self.model
        b, s, _ = x.shape
        g, hq = m["num_kv_heads"], m["num_heads"]
        q = self._linear(x, layer, "q").reshape(b, s, hq, self.hd)
        k = self._linear(x, layer, "k").reshape(b, s, g, self.hd)
        v = self._linear(x, layer, "v").reshape(b, s, g, self.hd)
        q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        out = torch.empty_like(q)
        for row in range(b):  # one row at a time: scores [H, S, S] in fp32
            kr = k[row].repeat_interleave(hq // g, dim=1).transpose(0, 1)  # [H, S, D]
            vr = v[row].repeat_interleave(hq // g, dim=1).transpose(0, 1)
            scores = (q[row].transpose(0, 1) @ kr.transpose(1, 2)) / math.sqrt(self.hd)
            probs = scores.masked_fill(~causal, float("-inf")).softmax(-1)
            out[row] = (probs @ vr).transpose(0, 1)
        return self._linear(out.reshape(b, s, hq * self.hd), layer, "o")

    def _swiglu(self, x: torch.Tensor, codes: dict, e=()) -> torch.Tensor:
        gate, up, down = (W.dequant(*(t[e] for t in codes[n])).to(self.dtype)
                          for n in ("gate", "up", "down"))
        return (F.silu(x @ gate) * (x @ up)) @ down

    def _mlp(self, x: torch.Tensor, layer: int, fp: dict) -> torch.Tensor:
        m = self.model
        if m["arch"] == "falcon" or m["arch"] == "opt":
            h = self._linear(x, layer, "fc1")
            h = F.relu(h) if m["activation"] == "relu" else F.gelu(h, approximate="tanh")
            return self._linear(h, layer, "fc2")
        codes = {n: W.quant_linear(self.cfg, self.seed, layer, n, self.device)
                 for n in ("gate", "up", "down")}
        if not m.get("num_experts", 0):
            return self._swiglu(x, codes)
        flat = x.reshape(-1, x.shape[-1])
        probs = (flat @ fp["router"].to(self.dtype)).float().softmax(-1)
        topv, topi = probs.topk(m["num_experts_per_tok"], dim=-1)
        topv = topv / topv.sum(-1, keepdim=True)
        out = torch.zeros_like(flat)
        for e in range(m["num_experts"]):
            tok, slot = (topi == e).nonzero(as_tuple=True)
            if tok.numel():
                weight = topv[tok, slot, None].to(self.dtype)
                out.index_add_(0, tok, weight * self._swiglu(flat[tok], codes, e))
        return out.reshape(x.shape)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """Final-normed hidden states [B, S, d] of token ids [B, S], in the
        reference's dtype."""
        m = self.model
        glob = W.globals_fp(self.cfg, self.seed, self.device)
        h = glob["embed"].to(self.dtype)[tokens.to(self.device)]
        for layer in range(m["num_layers"]):
            fp = W.layer_fp(self.cfg, self.seed, layer, self.device)
            x = self._norm(h, fp["ln1"])
            if m.get("parallel_block"):
                mlp_x = self._norm(h, fp["ln2"]) if "ln2" in fp else x
                h = h + self._attention(x, layer) + self._mlp(mlp_x, layer, fp)
            else:
                h = h + self._attention(x, layer)
                h = h + self._mlp(self._norm(h, fp["ln2"]), layer, fp)
        self._head = glob["embed"].T if m.get("tie_word_embeddings") else glob["lm_head"]
        return self._norm(h, glob["norm"])

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """fp32 logits of hidden states `[..., d]` (after `hidden`)."""
        return (hidden @ self._head.to(self.dtype)).float()

    def chunks(self, hidden: torch.Tensor, size: int = 512) -> Iterator:
        for c0 in range(0, hidden.shape[1], size):
            yield c0, self.logits(hidden[:, c0:c0 + size])

    def mean_nll(self, tokens: torch.Tensor, hidden: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """Per row, the mean cross-entropy of tokens[1:] given their prefixes
        (the perplexity loop's shifted loss), fp32 [B]."""
        tokens = tokens.to(self.device)
        hidden = self.hidden(tokens) if hidden is None else hidden
        targets = tokens[:, 1:]
        total = torch.zeros(tokens.shape[0], dtype=torch.float32, device=self.device)
        for c0, logits in self.chunks(hidden[:, :-1]):
            t = targets[:, c0:c0 + logits.shape[1]]
            picked = logits.gather(-1, t[..., None])[..., 0]
            total += (logits.logsumexp(-1) - picked).sum(-1)
        return total / targets.shape[1]
