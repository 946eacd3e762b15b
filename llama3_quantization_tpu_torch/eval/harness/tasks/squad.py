"""SQuAD v2 (the reference's `lm_eval/tasks/squad.py`): greedy answer +
"unanswerable" loglikelihood; the official squad_v2 aggregate (exact/f1,
HasAns/NoAns splits, best_* threshold sweep) implemented natively — the
reference delegates to `datasets.load_metric("squad_v2")`.

A copy of `llama3_quantization_tpu/eval/harness/tasks/squad.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

import math

from .. import metrics
from ..base import Task, rf


def _squad2_aggregate(items):
    """Full squad_v2 metric dict over (prediction, reference) pairs.
    Mirrors the official evaluate script: per-question max-over-golds
    normalized EM/F1, empty gold = unanswerable, and the best_* variants
    swept over no-answer probability thresholds."""
    rows = []
    for pred, ref in items:
        golds = [t for t in ref["answers"]["text"] if t.strip()]
        has_ans = bool(golds)
        if has_ans:
            em = max(metrics.squad_em(pred["prediction_text"], g) for g in golds)
            f1 = max(metrics.squad_f1(pred["prediction_text"], g) for g in golds)
        else:
            correct = metrics.squad_normalize(pred["prediction_text"]) in ("", "unanswerable")
            em = f1 = float(correct)
        rows.append(
            {
                "em": em,
                "f1": f1,
                "has_ans": has_ans,
                "na_prob": pred.get("no_answer_probability", 0.0),
            }
        )
    n = len(rows)
    out = {
        "exact": 100.0 * sum(r["em"] for r in rows) / n,
        "f1": 100.0 * sum(r["f1"] for r in rows) / n,
    }
    has_rows = [r for r in rows if r["has_ans"]]
    no_rows = [r for r in rows if not r["has_ans"]]
    if has_rows:
        out["HasAns_exact"] = 100.0 * sum(r["em"] for r in has_rows) / len(has_rows)
        out["HasAns_f1"] = 100.0 * sum(r["f1"] for r in has_rows) / len(has_rows)
    if no_rows:
        out["NoAns_exact"] = 100.0 * sum(r["em"] for r in no_rows) / len(no_rows)
        out["NoAns_f1"] = 100.0 * sum(r["f1"] for r in no_rows) / len(no_rows)
    # best_*: descending-threshold scan — at t=inf nothing abstains (score
    # = sum of the metric); lowering t past a row's na_prob flips that row
    # from its metric value to "correct iff unanswerable". One sort + one
    # linear pass instead of a rescan per candidate threshold.
    by_na = sorted(rows, key=lambda r: r["na_prob"], reverse=True)
    for metric_key, best_key in [("em", "best_exact"), ("f1", "best_f1")]:
        score = sum(r[metric_key] for r in rows)
        best = score
        for r in by_na:
            score += float(not r["has_ans"]) - r[metric_key]
            best = max(best, score)
        out[best_key] = 100.0 * best / n
    return out


#: the evaluator calls one aggregation fn per metric key, each over a list
#: of the SAME (prediction, reference) tuples; compute the expensive
#: aggregate once per distinct item sequence and share it across keys
_AGG_CACHE: dict = {}


def _agg(key):
    def agg(items):
        cache_key = tuple(id(x) for x in items)
        if _AGG_CACHE.get("key") != cache_key:
            _AGG_CACHE["key"] = cache_key
            _AGG_CACHE["value"] = _squad2_aggregate(items)
        return _AGG_CACHE["value"].get(key, 0.0)

    return agg


class SQuAD2(Task):
    VERSION = 1
    DATASET_PATH = "squad_v2"
    DATASET_NAME = None

    KEYS = [
        "exact", "f1", "HasAns_exact", "HasAns_f1",
        "NoAns_exact", "NoAns_f1", "best_exact", "best_f1",
    ]

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        return self.dataset["train"]

    def validation_docs(self):
        return self.dataset["validation"]

    def doc_to_text(self, doc):
        return (
            "Title: " + doc["title"] + "\n\n"
            "Background: " + doc["context"] + "\n\n"
            "Question: " + doc["question"] + "\n\n"
            "Answer:"
        )

    def doc_to_target(self, doc):
        answers = doc["answers"]["text"]
        return " " + (answers[0] if answers else "unanswerable")

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["context"]

    def construct_requests(self, doc, ctx):
        continuation = rf.greedy_until(ctx, ["\n"])
        is_unanswerable = rf.loglikelihood(ctx, " unanswerable")
        return continuation, is_unanswerable

    def process_results(self, doc, results):
        continuation, (logprob_unanswerable, _) = results
        predictions = {
            "id": doc["id"],
            "prediction_text": continuation,
            "no_answer_probability": math.exp(logprob_unanswerable),
        }
        references = {"id": doc["id"], "answers": doc["answers"]}
        return {key: (predictions, references) for key in self.KEYS}

    def aggregation(self):
        return {key: _agg(key) for key in self.KEYS}

    def higher_is_better(self):
        return {key: True for key in self.KEYS}
