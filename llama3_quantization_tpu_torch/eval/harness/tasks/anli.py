"""Adversarial NLI rounds 1-3 (the reference's `lm_eval/tasks/anli.py`):
premise + "Question: <hypothesis> True, False, or Neither?" scored by the
loglikelihood of the three answer words (label order True/Neither/False).

A copy of `llama3_quantization_tpu/eval/harness/tasks/anli.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .. import metrics
from ..base import Task, rf


class ANLIBase(Task):
    VERSION = 0
    DATASET_PATH = "anli"
    DATASET_NAME = None
    SPLIT = 1

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.dataset[f"train_r{self.SPLIT}"])
        return self._training_docs

    def validation_docs(self):
        return self.dataset[f"dev_r{self.SPLIT}"]

    def test_docs(self):
        return self.dataset[f"test_r{self.SPLIT}"]

    def doc_to_text(self, doc):
        return (
            doc["premise"]
            + "\nQuestion: "
            + doc["hypothesis"]
            + " True, False, or Neither?\nAnswer:"
        )

    def doc_to_target(self, doc):
        # label 0=entailment(True), 1=neutral(Neither), 2=contradiction(False)
        return " " + ["True", "Neither", "False"][doc["label"]]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["premise"]

    def construct_requests(self, doc, ctx):
        return [
            rf.loglikelihood(ctx, " True")[0],
            rf.loglikelihood(ctx, " Neither")[0],
            rf.loglikelihood(ctx, " False")[0],
        ]

    def process_results(self, doc, results):
        pred = max(range(len(results)), key=lambda i: results[i])
        return {"acc": float(pred == doc["label"])}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}


class ANLIRound1(ANLIBase):
    SPLIT = 1


class ANLIRound2(ANLIBase):
    SPLIT = 2


class ANLIRound3(ANLIBase):
    SPLIT = 3
