"""The work a configuration's traffic needs: floating-point operations and
bytes moved, from the shapes alone, whatever implements them.

Counts are of useful work. A mixture-of-experts layer does the work of its
`num_experts_per_tok` routed experts per token, whatever the program
computes (the port's dense MoE runs every expert on every token). Each
input byte counts once and each output byte once: a weight once per window
or decode step (every expert of a layer: a window of thousands of tokens,
or a step of dozens, routes to each of them), an activation once per
linear that reads it. A quantized weight is its codes, plus a two-byte
scale and a two-byte zero per group and column.

The least time a piece of work can take on the card is the larger of its
operations over the peak rate and its bytes over the bandwidth
(`bound_s`): NVIDIA's H100 SXM data sheet, dense bf16 without sparsity,
at the full 700 W.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
ACT_BYTES = 2  # bf16 activations


@dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    @property
    def bound_s(self) -> float:
        """The least time on the card: compute- or bandwidth-bound."""
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES_PER_S)


def total(works: Iterable[Work]) -> Work:
    out = Work()
    for w in works:
        out = out + w
    return out


def _head_dim(m: dict) -> int:
    return m.get("head_dim") or m["hidden_size"] // m["num_heads"]


def quantized_linears(cfg: dict) -> List[dict]:
    """Each quantized linear of one layer: K, N, how many copies the layer
    holds (the experts) and how many of them a token goes through."""
    m = cfg["model"]
    d, i, hd = m["hidden_size"], m["intermediate_size"], _head_dim(m)
    out = [dict(name="q", k=d, n=m["num_heads"] * hd), dict(name="k", k=d, n=m["num_kv_heads"] * hd),
           dict(name="v", k=d, n=m["num_kv_heads"] * hd), dict(name="o", k=m["num_heads"] * hd, n=d)]
    if m["arch"] in ("llama", "mixtral"):
        mlp = [dict(name="gate", k=d, n=i), dict(name="up", k=d, n=i), dict(name="down", k=i, n=d)]
    else:
        mlp = [dict(name="fc1", k=d, n=i), dict(name="fc2", k=i, n=d)]
    e = m.get("num_experts", 0)
    for lin in out + mlp:
        moe = e and lin in mlp
        lin.update(copies=e if moe else 1, per_token=m["num_experts_per_tok"] if moe else 1)
    return out + mlp


def weight_bytes(cfg: dict, k: int, n: int) -> float:
    q = cfg["quant"]
    return k * n * q["bits"] / 8 + (k // q["group_size"]) * n * 4


def _layer_linears(cfg: dict, tokens: int) -> List[Work]:
    """Each quantized linear of one layer for `tokens` token rows, its
    weights (every copy) read once."""
    out = []
    for lin in quantized_linears(cfg):
        rows = tokens * lin["per_token"]
        out.append(Work(flops=2.0 * rows * lin["k"] * lin["n"],
                        bytes=lin["copies"] * weight_bytes(cfg, lin["k"], lin["n"])
                        + ACT_BYTES * rows * (lin["k"] + lin["n"])))
    return out


def linear_work(cfg: dict, tokens: int) -> Work:
    """The quantized linears of every layer for `tokens` token rows."""
    one = total(_layer_linears(cfg, tokens))
    n_layers = cfg["model"]["num_layers"]
    return Work(one.flops * n_layers, one.bytes * n_layers)


def linear_bound_s(cfg: dict, tokens: int) -> float:
    """Σ over the quantized linears of every layer of each one's least time,
    for `tokens` token rows."""
    return cfg["model"]["num_layers"] * sum(w.bound_s for w in _layer_linears(cfg, tokens))


def causal_attention_work(cfg: dict, seqlens: Iterable[int]) -> Work:
    """Full causal attention over sequences of the given lengths, every
    layer: 4·H·D·S(S+1)/2 operations (QK^T and PV over the causal half),
    q, k, v read and the output written once."""
    m = cfg["model"]
    hq, g, hd = m["num_heads"], m["num_kv_heads"], _head_dim(m)
    flops = sum(4.0 * hq * hd * s * (s + 1) / 2 for s in seqlens)
    byt = sum(ACT_BYTES * s * (2 * hq + 2 * g) * hd for s in seqlens)
    return Work(flops * m["num_layers"], byt * m["num_layers"])


def decode_attention_work(cfg: dict, contexts: Iterable[int], kv_bytes: float) -> Work:
    """One cached token per context length c (positions attended), every
    layer: 4·H·D·c operations, its cached K and V read at `kv_bytes` an
    element, q read and the output written."""
    m = cfg["model"]
    hq, g, hd = m["num_heads"], m["num_kv_heads"], _head_dim(m)
    ctx = list(contexts)
    flops = sum(4.0 * hq * hd * c for c in ctx)
    byt = sum(2 * c * g * hd * kv_bytes + ACT_BYTES * 2 * hq * hd for c in ctx)
    return Work(flops * m["num_layers"], byt * m["num_layers"])


def router_work(cfg: dict, tokens: int) -> Work:
    m = cfg["model"]
    e = m.get("num_experts", 0)
    if not e:
        return Work()
    d = m["hidden_size"]
    return Work(2.0 * tokens * d * e * m["num_layers"],
                (ACT_BYTES * d * e + ACT_BYTES * tokens * d) * m["num_layers"])


def head_work(cfg: dict, tokens: int) -> Work:
    """The head's logits for `tokens` positions; the embedding rows read."""
    m = cfg["model"]
    d, v = m["hidden_size"], m["vocab_size"]
    return Work(2.0 * tokens * d * v, ACT_BYTES * (d * v + tokens * d + tokens * v))


def embed_work(cfg: dict, tokens: int) -> Work:
    return Work(0.0, ACT_BYTES * tokens * cfg["model"]["hidden_size"])


def window_work(cfg: dict, seqlen: int) -> Dict[str, Work]:
    """One perplexity window of `seqlen` tokens: the trunk over every
    position, the head over the `seqlen - 1` scored ones."""
    parts = {
        "qmm": linear_work(cfg, seqlen),
        "flash": causal_attention_work(cfg, [seqlen]),
        "router": router_work(cfg, seqlen),
        "head": head_work(cfg, seqlen - 1),
        "embed": embed_work(cfg, seqlen),
    }
    parts["step"] = total(parts.values())
    return parts


def decode_step_work(cfg: dict, contexts: List[int], kv_bytes: float) -> Dict[str, Work]:
    """One decode step of `len(contexts)` live sequences, each attending to
    its context length."""
    n = len(contexts)
    parts = {
        "qmm": linear_work(cfg, n),
        "attention": decode_attention_work(cfg, contexts, kv_bytes),
        "router": router_work(cfg, n),
        "head": head_work(cfg, n),
        "embed": embed_work(cfg, n),
    }
    parts["step"] = total(parts.values())
    return parts


def admission_work(cfg: dict, prompt_lens: List[int]) -> Dict[str, Work]:
    """One admission: the prompts' real tokens through the trunk (padding
    is not work), the head on each prompt's last position."""
    t = sum(prompt_lens)
    parts = {
        "qmm": linear_work(cfg, t),
        "attention": causal_attention_work(cfg, prompt_lens),
        "router": router_work(cfg, t),
        "head": head_work(cfg, len(prompt_lens)),
        "embed": embed_work(cfg, t),
    }
    parts["step"] = total(parts.values())
    return parts
