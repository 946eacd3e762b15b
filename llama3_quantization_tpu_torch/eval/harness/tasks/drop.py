"""DROP discrete-reasoning QA (the reference's `lm_eval/tasks/drop.py`):
greedy generation until "."; official DROP metric — bag-of-token F1 with
optimal span alignment (Hungarian) and number-aware matching.

A copy of `llama3_quantization_tpu/eval/harness/tasks/drop.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

import re
import string

import numpy as np
from scipy.optimize import linear_sum_assignment

from .. import metrics
from ..base import Task, rf

_ARTICLES = re.compile(r"\b(a|an|the)\b", re.UNICODE)


def _is_number(text):
    try:
        float(text)
        return True
    except ValueError:
        return False


def _normalize(answer: str) -> str:
    """DROP answer normalization (`drop.py:268-281`): per-token lowercase,
    punctuation strip (numbers kept), article removal, float canonical."""

    def _fix_number(tok):
        return str(float(tok)) if _is_number(tok) else tok

    def _remove_punc(tok):
        if _is_number(tok):
            return tok
        return "".join(ch for ch in tok if ch not in set(string.punctuation))

    tokens = [
        " ".join(_ARTICLES.sub(" ", _fix_number(_remove_punc(tok.lower()))).split())
        for tok in re.split(" |-", answer)
    ]
    return " ".join(t for t in tokens if t.strip()).strip()


def _answer_to_bags(answer):
    raw_spans = answer if isinstance(answer, (list, tuple)) else [answer]
    spans = [_normalize(s) for s in raw_spans]
    bags = [set(s.split()) for s in spans]
    return spans, bags


def _bag_f1(pred_bag, gold_bag):
    intersection = len(gold_bag & pred_bag)
    precision = intersection / len(pred_bag) if pred_bag else 1.0
    recall = intersection / len(gold_bag) if gold_bag else 1.0
    if precision == recall == 0.0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def _numbers_compatible(gold_bag, pred_bag):
    gold_numbers = {w for w in gold_bag if _is_number(w)}
    pred_numbers = {w for w in pred_bag if _is_number(w)}
    return not gold_numbers or bool(gold_numbers & pred_numbers)


def get_drop_metrics(predicted, gold):
    """(EM, F1) for one prediction/gold pair (`drop.py:160-180`)."""
    pred_spans, pred_bags = _answer_to_bags(predicted)
    gold_spans, gold_bags = _answer_to_bags(gold)
    exact = float(
        set(pred_spans) == set(gold_spans) and len(pred_spans) == len(gold_spans)
    )
    scores = np.zeros([len(gold_bags), len(pred_bags)])
    for gi, gold_bag in enumerate(gold_bags):
        for pi, pred_bag in enumerate(pred_bags):
            if _numbers_compatible(gold_bag, pred_bag):
                scores[gi, pi] = _bag_f1(pred_bag, gold_bag)
    row_ind, col_ind = linear_sum_assignment(-scores)
    max_scores = np.zeros([max(len(gold_bags), len(pred_bags))])
    for row, col in zip(row_ind, col_ind):
        max_scores[row] = max(max_scores[row], scores[row, col])
    return exact, round(float(np.mean(max_scores)), 2)


class DROP(Task):
    VERSION = 1
    DATASET_PATH = "drop"
    DATASET_NAME = None

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(map(self._process_doc, self.dataset["train"]))
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.dataset["validation"])

    def _process_doc(self, doc):
        if "answers" in doc and "passage" in doc:
            return doc
        return {
            "id": doc["query_id"],
            "passage": doc["passage"],
            "question": doc["question"],
            "answers": self.get_answers(doc),
        }

    @classmethod
    def get_answers(cls, qa):
        """Dedup the primary + validated answers (`drop.py:70-99`)."""
        validated = qa["validated_answers"]
        candidates = [qa["answer"]] + [
            {
                "number": validated["number"][i],
                "date": validated["date"][i],
                "spans": validated["spans"][i],
            }
            for i in range(len(validated["number"]))
        ]
        answers, seen = [], set()
        for candidate in candidates:
            answer = cls.parse_answer(candidate)
            if answer not in seen:
                seen.add(answer)
                answers.append(answer)
        return answers

    @classmethod
    def parse_answer(cls, answer):
        if answer["number"] != "":
            return (str(answer["number"]),)
        if answer["spans"]:
            return tuple(answer["spans"])
        date = answer["date"]
        return (" ".join([date["day"], date["month"], date["year"]]).strip(),)

    def doc_to_text(self, doc):
        return f"Passage: {doc['passage']}\nQuestion: {doc['question']}\nAnswer:"

    def doc_to_target(self, doc):
        return " " + ", ".join(doc["answers"][0])

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["passage"] + " " + doc["question"]

    def construct_requests(self, doc, ctx):
        return [rf.greedy_until(ctx, ["."])]

    def process_results(self, doc, results):
        preds, golds = results, doc["answers"]
        max_em = max_f1 = 0.0
        for gold_answer in golds:
            em, f1 = get_drop_metrics(preds, gold_answer)
            if gold_answer[0].strip():
                max_em = max(max_em, em)
                max_f1 = max(max_f1, f1)
        return {"em": max_em, "f1": max_f1}

    def aggregation(self):
        return {"em": metrics.mean, "f1": metrics.mean}

    def higher_is_better(self):
        return {"em": True, "f1": True}
