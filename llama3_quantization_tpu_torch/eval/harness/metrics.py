"""Aggregation metrics + bootstrap stderr (the reference harness's
`lm_eval/metrics.py`; a copy of `llama3_quantization_tpu/eval/harness/
metrics.py`, held equal to it by `tests/test_torch_harness.py`).
`sacrebleu` is imported only by the metrics that need it."""

from __future__ import annotations

import math
import random
from typing import Callable, List, Tuple


def mean(arr) -> float:
    return sum(arr) / len(arr)


def median(arr) -> float:
    arr = sorted(arr)
    return arr[len(arr) // 2]


def perplexity(items) -> float:
    return math.exp(-mean(items))


def weighted_mean(items: List[Tuple[float, float]]) -> float:
    """Zero total weight (e.g. a bootstrap resample of only empty docs)
    contributes 0 rather than dividing by zero."""
    a, b = zip(*items)
    return sum(a) / sum(b) if sum(b) else 0.0


def weighted_perplexity(items: List[Tuple[float, float]]) -> float:
    return math.exp(-weighted_mean(items))


def bits_per_byte(items: List[Tuple[float, float]]) -> float:
    return -weighted_mean(items) / math.log(2)


def squad_normalize(text: str) -> str:
    """SQuAD answer normalization (lowercase, strip punctuation/articles,
    collapse whitespace) — the comparison used by ReCoRD/SQuADv2/CoQA/DROP
    in the reference harness (via `transformers` squad_metrics)."""
    import re
    import string

    text = text.lower()
    text = "".join(ch for ch in text if ch not in set(string.punctuation))
    text = re.sub(r"\b(a|an|the)\b", " ", text)
    return " ".join(text.split())


def squad_em(prediction: str, ground_truth: str) -> float:
    return float(squad_normalize(prediction) == squad_normalize(ground_truth))


def squad_f1(prediction: str, ground_truth: str) -> float:
    """Token-overlap F1 over normalized answers."""
    pred_toks = squad_normalize(prediction).split()
    gold_toks = squad_normalize(ground_truth).split()
    if not pred_toks or not gold_toks:
        return float(pred_toks == gold_toks)
    overlap = 0
    gold_counts = {}
    for t in gold_toks:
        gold_counts[t] = gold_counts.get(t, 0) + 1
    for t in pred_toks:
        if gold_counts.get(t, 0) > 0:
            gold_counts[t] -= 1
            overlap += 1
    if overlap == 0:
        return 0.0
    precision = overlap / len(pred_toks)
    recall = overlap / len(gold_toks)
    return 2 * precision * recall / (precision + recall)


def metric_max_over_ground_truths(metric_fn, prediction: str, ground_truths) -> float:
    return max(metric_fn(prediction, gt) for gt in ground_truths)


def matthews_corrcoef(items) -> float:
    golds, preds = zip(*items)
    tp = sum(1 for g, p in zip(golds, preds) if g == 1 and p == 1)
    tn = sum(1 for g, p in zip(golds, preds) if g == 0 and p == 0)
    fp = sum(1 for g, p in zip(golds, preds) if g == 0 and p == 1)
    fn = sum(1 for g, p in zip(golds, preds) if g == 1 and p == 0)
    denom = math.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return ((tp * tn) - (fp * fn)) / denom if denom else 0.0


def f1_score(items) -> float:
    golds, preds = zip(*items)
    tp = sum(1 for g, p in zip(golds, preds) if g == 1 and p == 1)
    fp = sum(1 for g, p in zip(golds, preds) if g == 0 and p == 1)
    fn = sum(1 for g, p in zip(golds, preds) if g == 1 and p == 0)
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    return 2 * prec * rec / (prec + rec) if prec + rec else 0.0


def f1_macro(items) -> float:
    """Unweighted mean of per-class F1 (CB's 3-class metric,
    `lm_eval/tasks/superglue.py` cb_multi_fi)."""
    golds, preds = zip(*items)
    scores = []
    for cls in sorted(set(golds)):
        tp = sum(1 for g, p in zip(golds, preds) if g == cls and p == cls)
        fp = sum(1 for g, p in zip(golds, preds) if g != cls and p == cls)
        fn = sum(1 for g, p in zip(golds, preds) if g == cls and p != cls)
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        scores.append(2 * prec * rec / (prec + rec) if prec + rec else 0.0)
    return sum(scores) / len(scores) if scores else 0.0


def acc_all(items) -> float:
    """Question-level accuracy for multi-span tasks (ReCoRD/MultiRC style):
    every span must be correct (`lm_eval/metrics.py:48-90`)."""
    question_scoring: dict = {}
    for correct, doc in items:
        key = (doc.get("idx", {}).get("paragraph", 0), doc.get("idx", {}).get("question", 0))
        question_scoring.setdefault(key, []).append(correct)
    return mean([int(all(v)) for v in question_scoring.values()])


def _sacre():
    import sacrebleu

    return sacrebleu


def bleu(items) -> float:
    """Corpus BLEU over (ref, pred) pairs (`lm_eval/metrics.py:111-127`)."""
    refs, preds = zip(*items)
    return _sacre().corpus_bleu(list(preds), [list(refs)]).score


def chrf(items) -> float:
    refs, preds = zip(*items)
    return _sacre().corpus_chrf(list(preds), [list(refs)]).score


def ter(items) -> float:
    refs, preds = zip(*items)
    return _sacre().corpus_ter(list(preds), [list(refs)]).score


def bootstrap_stderr(f: Callable, xs, iters: int = 1000) -> float:
    """Bootstrap standard error of metric f over xs
    (`lm_eval/metrics.py:192-253`; single-process — the reference uses a
    multiprocessing pool, unnecessary at these sizes)."""
    rnd = random.Random(1234)
    res = []
    n = len(xs)
    for _ in range(min(iters, 2000)):
        res.append(f([rnd.choice(xs) for _ in range(n)]))
    mu = mean(res)
    return math.sqrt(sum((r - mu) ** 2 for r in res) / max(len(res) - 1, 1))


def stderr_for_metric(metric: Callable, bootstrap_iters: int = 1000):
    if metric in (mean, acc_all):
        return lambda xs: bootstrap_stderr(metric, xs, bootstrap_iters)
    bootstrappable = {
        median,
        matthews_corrcoef,
        f1_score,
        perplexity,
        weighted_perplexity,
        bits_per_byte,
    }
    if metric in bootstrappable:
        return lambda xs: bootstrap_stderr(metric, xs, bootstrap_iters)
    return None
