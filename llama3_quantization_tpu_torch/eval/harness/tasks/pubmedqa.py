"""PubMedQA (the reference's `lm_eval/tasks/pubmedqa.py`): abstract +
question scored over yes/no/maybe loglikelihoods; the HF train split is the
labeled evaluation set.

A copy of `llama3_quantization_tpu/eval/harness/tasks/pubmedqa.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .. import metrics
from ..base import Task, rf


class PubMedQA(Task):
    VERSION = 0
    DATASET_PATH = "pubmed_qa"
    DATASET_NAME = "pqa_labeled"

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def test_docs(self):
        return self.dataset["train"]

    def doc_to_text(self, doc):
        contexts = "\n".join(doc["context"]["contexts"])
        return "Abstract: {}\nQuestion: {}\nAnswer:".format(contexts, doc["question"])

    def doc_to_target(self, doc):
        return " {}".format(doc["final_decision"])

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["question"] + " " + "\n".join(doc["context"]["contexts"])

    def construct_requests(self, doc, ctx):
        ll_yes, _ = rf.loglikelihood(ctx, " yes")
        ll_no, _ = rf.loglikelihood(ctx, " no")
        ll_maybe, _ = rf.loglikelihood(ctx, " maybe")
        return ll_yes, ll_no, ll_maybe

    def process_results(self, doc, results):
        results = list(results)
        pred = max(range(3), key=lambda i: results[i])
        return {"acc": float(["yes", "no", "maybe"][pred] == doc["final_decision"])}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}
