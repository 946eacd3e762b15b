"""BoolQ (SuperGLUE; the reference's `lm_eval/tasks/superglue.py` BoolQ).

A copy of `llama3_quantization_tpu/eval/harness/tasks/boolq.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from ..base import Task, rf
from .. import metrics


class BoolQ(Task):
    VERSION = 1
    DATASET_PATH = "super_glue"
    DATASET_NAME = "boolq"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.dataset["train"])
        return self._training_docs

    def validation_docs(self):
        return self.dataset["validation"]

    def doc_to_text(self, doc):
        return f"{doc['passage']}\nQuestion: {doc['question']}?\nAnswer:"

    def doc_to_target(self, doc):
        return " yes" if doc["label"] else " no"

    def construct_requests(self, doc, ctx):
        ll_yes, _ = rf.loglikelihood(ctx, " yes")
        ll_no, _ = rf.loglikelihood(ctx, " no")
        return ll_yes, ll_no

    def process_results(self, doc, results):
        ll_yes, ll_no = results
        gold = doc["label"]
        acc = 1.0 if (ll_yes > ll_no) == gold else 0.0
        return {"acc": acc}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}
