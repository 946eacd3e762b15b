"""QASPER scientific-paper QA (the reference's `lm_eval/tasks/qasper.py`):
per-question docs flattened from paper records; yes/no questions scored as
binary F1, free-form answers as token F1; extractive spans and
unanswerables are skipped (as in the reference, `qasper.py:168-196`).

A copy of `llama3_quantization_tpu/eval/harness/tasks/qasper.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .. import metrics
from ..base import Task, rf


def categorise_answer(answer_blob):
    """(answer, type) from a QASPER answer record (`qasper.py:65-85`)."""
    if answer_blob["unanswerable"]:
        return "unanswerable", "unanswerable"
    if answer_blob["yes_no"]:
        return "yes", "bool"
    if answer_blob["free_form_answer"]:
        return answer_blob["free_form_answer"], "free form answer"
    if answer_blob["extractive_spans"]:
        return answer_blob["extractive_spans"], "extractive_spans"
    if answer_blob["yes_no"] is False:
        return "no", "bool"
    return "unanswerable", "unanswerable"


class QASPER(Task):
    VERSION = 0
    DATASET_PATH = "qasper"
    DATASET_NAME = None

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        for doc in self.dataset["train"]:
            yield from self._flatten(doc)

    def validation_docs(self):
        for doc in self.dataset["validation"]:
            yield from self._flatten(doc)

    @staticmethod
    def _flatten(doc):
        if "answer_type" in doc:  # already flattened (injected docs)
            yield doc
            return
        for question, answer_list in zip(doc["qas"]["question"], doc["qas"]["answers"]):
            for answer_blob in answer_list["answer"]:
                answer, answer_type = categorise_answer(answer_blob)
                yield {
                    "title": doc["title"],
                    "abstract": doc["abstract"],
                    "question": question,
                    "answer": answer,
                    "answer_type": answer_type,
                }

    def doc_to_text(self, doc):
        return (
            "TITLE: " + doc["title"] + "\n"
            "ABSTRACT: " + doc["abstract"] + "\n\n"
            "Q: " + doc["question"] + "\n\nA:"
        )

    def doc_to_target(self, doc):
        answer = doc["answer"]
        if isinstance(answer, list):
            answer = ", ".join(answer)
        return " " + answer

    def construct_requests(self, doc, ctx):
        if doc["answer_type"] == "free form answer":
            return [rf.greedy_until(ctx, ["\n"])]
        if doc["answer_type"] == "bool":
            ll_yes, _ = rf.loglikelihood(ctx, " yes")
            ll_no, _ = rf.loglikelihood(ctx, " no")
            return [ll_yes, ll_no]
        return []

    def process_results(self, doc, results):
        if not results:
            return {}
        if doc["answer_type"] == "bool":
            ll_yes, ll_no = results
            gold = 1 if doc["answer"] == "yes" else 0
            return {"f1_yesno": (gold, int(ll_yes > ll_no))}
        if doc["answer_type"] == "free form answer":
            pred_toks = metrics.squad_normalize(results[0]).split()
            gold_toks = metrics.squad_normalize(doc["answer"]).split()
            return {"f1_abstractive": metrics.squad_f1(results[0], doc["answer"])
                    if pred_toks and gold_toks else 0.0}
        return {}

    def aggregation(self):
        return {"f1_yesno": metrics.f1_score, "f1_abstractive": metrics.mean}

    def higher_is_better(self):
        return {"f1_yesno": True, "f1_abstractive": True}
