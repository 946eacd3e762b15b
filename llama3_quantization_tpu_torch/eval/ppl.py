"""Perplexity evaluation (port of `llama3_quantization_tpu/eval/ppl.py`).

The window math is the reference's manual PPL loop: the token stream is
cut into disjoint `seqlen` windows; per window, the cross-entropy over the
`seqlen - 1` shifted positions is averaged, then multiplied by `seqlen`;
the PPL is `exp(sum(nll) / (nsamples * seqlen))`.

`lm_head` and the fp32 `logsumexp` run over `chunk` positions at a time,
so the `[S, vocab]` fp32 logits never exist whole. Every window runs under
`torch.inference_mode()` on the device of the parameters; the forward
takes the port's routes (B2 for the linears of a [1, 2048] window under
the "pallas" backend, B7 for its attention), on weights padded once per
`compute_ppl` call where a kernel does not take their shape
(`ops/padding.py`). `sp_windowed_nll_fn` is the sequence-parallel step:
the window split over an `sp` mesh under ring attention
(`parallel/ring_attention.py`). On a rank-local tree (`parallel.
shard_params`) the forward runs tensor parallel and every rank computes
the same PPL.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models.transformer import NO_QUANT, RuntimeQuantConfig, forward_hidden, lm_head
from ..ops.padding import pad_for_kernels
from ..utils import profiling as prof


def params_device(params) -> torch.device:
    """The device of a parameter tree (that of its embedding table)."""
    return params["embed"].device


def _chunked_nll(params, hidden, targets, cfg: ModelConfig, chunk: int) -> torch.Tensor:
    """Sum of CE(logits[t], targets[t]) over valid (non -100) positions,
    computed `chunk` sequence positions at a time, in fp32
    (`eval/ppl.py:27-52`)."""
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, hidden.shape[1], chunk):
        h, t = hidden[:, c0 : c0 + chunk], targets[:, c0 : c0 + chunk]
        logits = lm_head(params, h, cfg).float()
        logz = torch.logsumexp(logits, dim=-1)
        tok_logp = torch.gather(logits, -1, t.clamp(min=0)[..., None])[..., 0]
        total = total + torch.where(t >= 0, logz - tok_logp, 0.0).sum()
    return total


def windowed_nll_fn(cfg: ModelConfig, rq: RuntimeQuantConfig = NO_QUANT,
                    chunk: int = 512) -> Callable:
    """The per-window NLL step: tokens [B, S] -> summed shifted CE, the
    reference's `loss.mean() * seqlen` (`eval/ppl.py:55-75`), under the
    spans `eval.forward` and `eval.nll`."""

    @prof.entry_point
    def step(params, tokens: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            with prof.span("eval.forward"):
                hidden = forward_hidden(params, tokens, cfg, rq)
            with prof.span("eval.nll"):
                shift_t = tokens[:, 1:]
                ce_sum = _chunked_nll(params, hidden[:, :-1, :], shift_t, cfg, chunk)
                return ce_sum / shift_t.numel() * tokens.shape[1]

    return step


def sp_windowed_nll_fn(
    cfg: ModelConfig,
    mesh,
    rq: RuntimeQuantConfig = NO_QUANT,
    chunk: int = 512,
) -> Callable:
    """The sequence-parallel per-window NLL step (`eval/ppl.py:76-96`): the
    trunk under ring attention with the window split over the mesh's `sp`
    axis (per-rank attention [S/sp, S/sp]), the hidden states gathered, the
    window math of `windowed_nll_fn`."""
    from ..parallel.ring_attention import make_sp_forward

    hidden_fn = make_sp_forward(cfg, mesh, rq, return_hidden=True)

    def step(params, tokens: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            hidden = hidden_fn(params, tokens)
            ce_sum = _chunked_nll(params, hidden[:, :-1, :], tokens[:, 1:], cfg, chunk)
            return ce_sum / tokens[:, 1:].numel() * tokens.shape[1]

    return step


def compute_ppl(
    params,
    cfg: ModelConfig,
    testenc: np.ndarray,  # [1, N] token stream
    seqlen: int = 2048,
    rq: RuntimeQuantConfig = NO_QUANT,
    limit: Optional[int] = None,
    step_fn: Optional[Callable] = None,
    progress: Optional[Callable[[int, int], None]] = None,
) -> float:
    """The reference's PPL over disjoint windows (`eval/ppl.py:100-130`),
    normalized by the windows evaluated."""
    testenc = np.asarray(testenc)
    nsamples = testenc.size // seqlen
    if limit is not None:
        nsamples = min(nsamples, limit)
    step = step_fn or windowed_nll_fn(cfg, rq)
    dev = params_device(params)
    params = pad_for_kernels(params)
    nlls = []
    for i in range(nsamples):
        window = np.ascontiguousarray(testenc[:, i * seqlen : (i + 1) * seqlen], dtype=np.int64)
        nlls.append(step(params, torch.from_numpy(window).to(dev)))
        if progress:
            progress(i + 1, nsamples)
    with torch.inference_mode():
        total = torch.stack(nlls).sum()
        return float(torch.exp(total / (nsamples * seqlen)))


def eval_ppl_suite(
    params,
    cfg: ModelConfig,
    streams: Dict[str, np.ndarray],
    seqlen: int = 2048,
    rq: RuntimeQuantConfig = NO_QUANT,
    limit: Optional[int] = None,
) -> Dict[str, float]:
    """PPL across datasets with one step function (`eval/ppl.py:133-144`)."""
    step = windowed_nll_fn(cfg, rq)
    return {
        name: compute_ppl(params, cfg, enc, seqlen, rq, limit, step_fn=step)
        for name, enc in streams.items()
    }

