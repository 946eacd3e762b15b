"""STS (semantic textual similarity) bi-encoder evaluation (port of
`llama3_quantization_tpu/eval/sts.py`).

The reference's `benchmark_mteb.py` wraps the quantized model in
`STSEvalModel` (`:57-139`) — an in-context demonstration prompt of scored
sentence pairs, embeddings taken as the last non-pad token's hidden state
of the decoder trunk — and runs MTEB STS tasks. Here `STSEncoder`
reproduces the prompt + last-token embedding through the port's
`forward_hidden` on the parameters' device, and `evaluate_sts` computes the
Spearman correlation of cosine similarities against gold scores (MTEB's
main STS metric) for injected datasets.

`cosine_sim`, `spearman` and `evaluate_sts` are the JAX module's code;
`STSEncoder` runs `forward_hidden` where JAX jits it.
`tests/test_torch_retrieval_sts.py` holds both to JAX's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

PROMPT_TEMPLATE = "Sentence 1: {s1}\nSentence 2: {s2}\nSimilarity Score: {score}\n"


from .retrieval import _encode_plain


class STSEncoder:
    def __init__(
        self,
        params,
        cfg,
        tokenizer,
        demonstration_set: Sequence[Tuple[str, str, float]] = (),
        rq=None,
        max_length: int = 2048,
    ):
        from ..models.transformer import NO_QUANT
        from ..ops.padding import pad_for_kernels

        self.params, self.cfg, self.tok = pad_for_kernels(params), cfg, tokenizer
        self.max_length = max_length
        self.demo_prompt = (
            "\n".join(
                PROMPT_TEMPLATE.format(s1=a, s2=b, score=s)
                for a, b, s in demonstration_set
            )
            + "\n"
            if demonstration_set
            else ""
        )
        self.rq = rq or NO_QUANT

    def _fwd(self, batch: np.ndarray) -> np.ndarray:
        """fp32 hidden states [B, S, d] of one `forward_hidden` call."""
        import torch

        from ..models.transformer import forward_hidden

        toks = torch.from_numpy(batch.astype(np.int64)).to(self.params["embed"].device)
        with torch.inference_mode():
            return forward_hidden(self.params, toks, self.cfg, self.rq).float().cpu().numpy()

    @staticmethod
    def _bucket(n: int) -> int:
        from .data import bucket_pow2

        return bucket_pow2(n)

    def encode(self, sentences: Sequence[str], batch_size: int = 8) -> np.ndarray:
        embs = [None] * len(sentences)
        items = sorted(
            (
                (i, _encode_plain(self.tok, self.demo_prompt + f"Sentence: {s}\nEmbedding:")[-self.max_length :])
                for i, s in enumerate(sentences)
            ),
            key=lambda it: len(it[1]),
        )
        for start in range(0, len(items), batch_size):
            chunk = items[start : start + batch_size]
            maxlen = self._bucket(max(len(t) for _, t in chunk))
            batch = np.zeros((len(chunk), maxlen), dtype=np.int32)
            for i, (_, toks) in enumerate(chunk):
                batch[i, : len(toks)] = toks
            hidden = self._fwd(batch)
            for i, (orig, toks) in enumerate(chunk):
                embs[orig] = hidden[i, len(toks) - 1]  # last real token
        return np.stack(embs)


def cosine_sim(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / np.clip(np.linalg.norm(a, axis=-1, keepdims=True), 1e-9, None)
    b = b / np.clip(np.linalg.norm(b, axis=-1, keepdims=True), 1e-9, None)
    return np.sum(a * b, axis=-1)


def spearman(x: Sequence[float], y: Sequence[float]) -> float:
    def ranks(v):
        order = np.argsort(v)
        r = np.empty(len(v), dtype=np.float64)
        r[order] = np.arange(len(v))
        # average ties
        vals = np.asarray(v)
        for u in np.unique(vals):
            mask = vals == u
            r[mask] = r[mask].mean()
        return r

    rx, ry = ranks(list(x)), ranks(list(y))
    rx -= rx.mean()
    ry -= ry.mean()
    denom = np.sqrt((rx**2).sum() * (ry**2).sum())
    return float((rx * ry).sum() / denom) if denom else 0.0


def evaluate_sts(
    encoder: STSEncoder,
    pairs: Sequence[Tuple[str, str]],
    gold_scores: Sequence[float],
    batch_size: int = 8,
) -> dict:
    """Spearman of cosine similarity vs gold (`benchmark_mteb.py:365-368`
    output metric)."""
    s1 = encoder.encode([a for a, _ in pairs], batch_size)
    s2 = encoder.encode([b for _, b in pairs], batch_size)
    sims = cosine_sim(s1, s2)
    return {
        "spearman_cosine": spearman(sims.tolist(), list(gold_scores)),
        "n_pairs": len(pairs),
    }
