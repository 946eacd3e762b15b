"""IR benchmarking: BM25 first stage + UPR cross-encoder reranking (port of
`llama3_quantization_tpu/eval/retrieval.py`).

The reference's `benchmark_beir.py` drives an external Elasticsearch BM25
server (`:348-355`) and reranks with a UPR prompt through HF internals
(`QLlamaUPRModel`, `:211-266`). Here the first stage is an in-process Okapi
BM25 index (no server), and UPR scoring runs through the port's
`forward_logits` on the parameters' device — score = −mean CE of the query
tokens conditioned on "{header} {passage} {instruction}", identical prompt
semantics. Padding is applied only *after* the scored region (right pad,
causal attention), so no attention-mask plumbing is needed.

BM25, the analyzers and `evaluate_retrieval` are the JAX module's code;
`UPRReranker` scores each batch with `forward_logits` where JAX jits it.
`tests/test_torch_retrieval_sts.py` holds both to JAX's.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

DEFAULT_HEADER = "Passage: "
DEFAULT_INSTRUCTION = "Please write a question based on this passage."


# ---------------------------------------------------------------------------
# BM25 (Okapi) — replaces the Elasticsearch dependency
# ---------------------------------------------------------------------------


def _tokenize(text: str) -> List[str]:
    import re

    return re.findall(r"[a-z0-9]+", text.lower())


#: "standard"-analyzer token pattern (see `_tokenize_standard`)
_STD_PATTERN = None


def _tokenize_standard(text: str) -> List[str]:
    """Approximate Elasticsearch's default `standard` analyzer (Unicode
    UAX#29 word segmentation + lowercase, no stopwords) — the analyzer
    the reference's first stage indexes with (`benchmark_beir.py:348-355`
    never sets a custom one). Divergences from the ASCII `_tokenize`
    ("simple") this fixes, each a UAX#29 word-boundary rule:

    - MidLetter apostrophes: "don't" is ONE token (simple: "don", "t");
    - MidNum: "3.5" / "1,000" are one numeric token (simple: split);
    - non-ASCII letters: "café"/"naïve" keep their letters (simple drops
      them entirely — those documents became unsearchable);
    - ExtendNumLet: "foo_bar" joins (simple: splits).

    Known residual divergences from a real ES ranking, documented in
    docs/PARITY.md (BM25/ES section): full UAX#29 script handling (CJK
    per-character tokens, Hangul syllables), Lucene's lossy 1-byte doc-
    length norms (see `lucene_norms`), and per-shard IDF (exact for the
    default single-shard index ES 7+ creates)."""
    global _STD_PATTERN
    import re

    if _STD_PATTERN is None:
        # one alphanumeric run (UAX#29 does NOT break between letters
        # and digits: "x86"/"mp3" are single tokens), optionally joined
        # by MidLetter apostrophes (letter on both sides) or MidNum
        # ./,(digit on both sides); underscore rides the word class like
        # UAX#29's ExtendNumLet
        _STD_PATTERN = re.compile(
            r"\w+(?:(?<=[^\W\d_])['’](?=[^\W\d_])\w+"
            r"|(?<=\d)[.,](?=\d)\w+)*",
            re.UNICODE,
        )
    return _STD_PATTERN.findall(text.lower())


def _lucene_norm_quantize(lengths: np.ndarray) -> np.ndarray:
    """Approximate Lucene's lossy doc-length norms: BM25Similarity stores
    each document's length through SmallFloat's 1-byte encoding (exact
    below 2^3-mantissa resolution, progressively truncated above), so two
    docs with lengths 1000 and 1015 share a norm and tie where exact-dl
    BM25 would not. Modeled here as truncation to a 3-bit mantissa
    (value = (8 + m) << e form) — an APPROXIMATION used to bound the
    effect, not a bit-exact SmallFloat port; measured rank-overlap impact
    on the fixture corpus is recorded in docs/PARITY.md."""
    lengths = np.asarray(lengths, dtype=np.int64)
    out = lengths.copy()
    big = lengths >= 16
    if big.any():
        vals = lengths[big]
        shifts = np.maximum(0, np.floor(np.log2(vals)).astype(np.int64) - 3)
        out[big] = (vals >> shifts) << shifts
    return out.astype(np.float32)



def _encode_plain(tok, text):
    """Encode without special tokens (the reference's add_special_tokens=
    False, `models/LMClass.py:81-88`) — a BOS spliced mid-sequence would
    corrupt scoring."""
    try:
        return tok.encode(text, add_special_tokens=False)
    except TypeError:
        return tok.encode(text)

# BM25 parameter presets. The reference's first stage is Elasticsearch with
# Lucene defaults k1=1.2 / b=0.75 (`benchmark_beir.py:348-355`; ES never
# overrides them), so "es" is the default here — first-stage rankings, and
# therefore the top-k rerank pools, match the reference's. "anserini" is the
# tuned preset common in IR literature (k1=0.9, b=0.4), kept as an option.
BM25_PRESETS = {"es": (1.2, 0.75), "anserini": (0.9, 0.4)}


class BM25Index:
    def __init__(
        self,
        corpus: Dict[str, str],
        k1: float | None = None,
        b: float | None = None,
        preset: str = "es",
        analyzer: str = "standard",
        lucene_norms: bool = False,
    ):
        pk1, pb = BM25_PRESETS[preset]
        self.k1 = pk1 if k1 is None else k1
        self.b = pb if b is None else b
        if analyzer not in ("standard", "simple"):
            raise ValueError(analyzer)
        # "standard" (default) approximates ES's UAX#29 analyzer — see
        # `_tokenize_standard`; "simple" is the round-3 ASCII tokenizer,
        # kept for A/B. `lucene_norms` additionally quantizes doc lengths
        # like Lucene's 1-byte norms (sensitivity probe, default off).
        self._tok = _tokenize_standard if analyzer == "standard" else _tokenize
        self.doc_ids = list(corpus.keys())
        self.doc_toks = [self._tok(corpus[d]) for d in self.doc_ids]
        self.doc_len = np.asarray([len(t) for t in self.doc_toks], dtype=np.float32)
        if lucene_norms:
            self.doc_len = _lucene_norm_quantize(self.doc_len)
        self.avgdl = float(self.doc_len.mean()) if len(self.doc_len) else 0.0
        self.tf: List[Counter] = [Counter(t) for t in self.doc_toks]
        df: Counter = Counter()
        for t in self.doc_toks:
            df.update(set(t))
        n = len(self.doc_ids)
        self.idf = {
            w: math.log(1 + (n - c + 0.5) / (c + 0.5)) for w, c in df.items()
        }

    def search(self, query: str, top_k: int = 100) -> Dict[str, float]:
        q_toks = self._tok(query)
        scores = np.zeros(len(self.doc_ids), dtype=np.float32)
        for w in q_toks:
            idf = self.idf.get(w)
            if idf is None:
                continue
            tf = np.asarray([t[w] for t in self.tf], dtype=np.float32)
            denom = tf + self.k1 * (1 - self.b + self.b * self.doc_len / max(self.avgdl, 1e-9))
            scores += idf * tf * (self.k1 + 1) / np.maximum(denom, 1e-9)
        top = np.argsort(-scores)[:top_k]
        return {self.doc_ids[i]: float(scores[i]) for i in top if scores[i] > 0}


# ---------------------------------------------------------------------------
# UPR cross-encoder scoring
# ---------------------------------------------------------------------------


class UPRReranker:
    """−mean-CE(query | passage+instruction) scorer
    (`benchmark_beir.py:225-266`)."""

    def __init__(
        self,
        params,
        cfg,
        tokenizer,
        rq=None,
        header: str = DEFAULT_HEADER,
        instruction: str = DEFAULT_INSTRUCTION,
        max_length: int = 2048,
    ):
        from ..models.transformer import NO_QUANT
        from ..ops.padding import pad_for_kernels

        self.params, self.cfg, self.tok = pad_for_kernels(params), cfg, tokenizer
        self.header, self.instruction = header, instruction
        self.max_length = max_length
        self.rq = rq or NO_QUANT

    def _score(self, inps, targets, mask):
        """−mean CE of the masked targets per row, from one `forward_logits`
        over the batch: only [B] means leave the device (full [B, S, V]
        logprobs are ~GBs at Llama-3 vocab)."""
        import torch

        from ..models.transformer import forward_logits

        dev = self.params["embed"].device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        inp, tgt, msk = put(inps.astype(np.int64)), put(targets.astype(np.int64)), put(mask)
        with torch.inference_mode():
            logits = forward_logits(self.params, inp, self.cfg, self.rq).float()
            logz = torch.logsumexp(logits, dim=-1)
            tok_lp = torch.gather(logits, -1, tgt[..., None])[..., 0] - logz
            denom = torch.clamp(msk.sum(dim=-1), min=1.0)
            return ((tok_lp * msk).sum(dim=-1) / denom).cpu().numpy()

    def _bucket(self, n: int) -> int:
        from .data import bucket_pow2

        return bucket_pow2(n)

    def score_pairs(self, pairs: Sequence[Tuple[str, str]], batch_size: int = 8) -> List[float]:
        """pairs of (query, passage) -> scores (higher = better match)."""
        items = []
        for qi, (query, passage) in enumerate(pairs):
            ctx = _encode_plain(self.tok, f"{self.header}{passage} {self.instruction}")
            tgt = _encode_plain(self.tok, query)
            seq = (list(ctx) + list(tgt))[-self.max_length :]
            n_tgt = min(len(tgt), len(seq) - 1)
            items.append((qi, seq, n_tgt))
        # group by bucketed length to limit recompiles
        items.sort(key=lambda it: len(it[1]))
        scores = [0.0] * len(pairs)
        for start in range(0, len(items), batch_size):
            chunk = items[start : start + batch_size]
            maxlen = self._bucket(max(len(seq) - 1 for _, seq, _ in chunk))
            b = len(chunk)
            inp = np.zeros((b, maxlen), dtype=np.int32)
            tgt = np.zeros((b, maxlen), dtype=np.int32)
            mask = np.zeros((b, maxlen), dtype=np.float32)
            for i, (_, seq, n_tgt) in enumerate(chunk):
                L = len(seq) - 1
                inp[i, :L] = seq[:-1]
                tgt[i, :L] = seq[1:]
                mask[i, L - n_tgt : L] = 1.0
            means = self._score(inp, tgt, mask)
            for i, (qi, _, _) in enumerate(chunk):
                scores[qi] = float(means[i])  # -mean CE
        return scores

    def rerank(
        self,
        corpus: Dict[str, str],
        queries: Dict[str, str],
        first_stage: Dict[str, Dict[str, float]],
        top_k: int = 100,
        batch_size: int = 8,
    ) -> Dict[str, Dict[str, float]]:
        """BEIR `Rerank(...).rerank` flow (`benchmark_beir.py:358-361`)."""
        out: Dict[str, Dict[str, float]] = {}
        for qid, cands in first_stage.items():
            ranked = sorted(cands.items(), key=lambda kv: -kv[1])[:top_k]
            pairs = [(queries[qid], corpus[did]) for did, _ in ranked]
            scores = self.score_pairs(pairs, batch_size=batch_size)
            out[qid] = {did: s for (did, _), s in zip(ranked, scores)}
        return out


# ---------------------------------------------------------------------------
# trec-style metrics (beir's EvaluateRetrieval.evaluate equivalent)
# ---------------------------------------------------------------------------


def _dcg(rels: List[float]) -> float:
    return sum(r / math.log2(i + 2) for i, r in enumerate(rels))


def evaluate_retrieval(
    qrels: Dict[str, Dict[str, int]],
    results: Dict[str, Dict[str, float]],
    k_values: Sequence[int] = (1, 3, 5, 10, 100),
) -> Dict[str, float]:
    """NDCG@k / MAP@k / Recall@k / P@k over all queries
    (`benchmark_beir.py:363-369`)."""
    metrics: Dict[str, List[float]] = defaultdict(list)
    for qid, rel in qrels.items():
        ranked = sorted(results.get(qid, {}).items(), key=lambda kv: -kv[1])
        gains = [rel.get(did, 0) for did, _ in ranked]
        n_rel = sum(1 for v in rel.values() if v > 0)
        for k in k_values:
            top = gains[:k]
            ideal = sorted(rel.values(), reverse=True)[:k]
            idcg = _dcg([v for v in ideal if v > 0])
            metrics[f"NDCG@{k}"].append(_dcg(top) / idcg if idcg > 0 else 0.0)
            hits = sum(1 for g in top if g > 0)
            metrics[f"P@{k}"].append(hits / k)
            metrics[f"Recall@{k}"].append(hits / n_rel if n_rel else 0.0)
            ap, seen = 0.0, 0
            for i, g in enumerate(top):
                if g > 0:
                    seen += 1
                    ap += seen / (i + 1)
            # trec_eval map_cut: AP normalized by the TOTAL relevant count
            metrics[f"MAP@{k}"].append(ap / n_rel if n_rel else 0.0)
    return {m: float(np.mean(v)) for m, v in metrics.items()}
