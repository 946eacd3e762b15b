"""GLUE classification tasks (the reference's `lm_eval/tasks/glue.py`).

Same zero-shot prompt formats and yes/no-style verbalizers as the
reference's lm-eval v0.3 vintage, so scores are comparable: each doc is
scored by the loglikelihood of each label verbalizer continuation and the
argmax is the prediction.

A copy of `llama3_quantization_tpu/eval/harness/tasks/glue.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .. import metrics
from ..base import Task, rf


class _GlueBinaryTask(Task):
    """Shared scaffolding: two-verbalizer yes/no style classification."""

    VERSION = 0
    DATASET_PATH = "glue"
    #: (positive, negative) continuations; positive corresponds to label 1
    #: unless `POSITIVE_LABEL` says otherwise
    CHOICES = (" yes", " no")
    POSITIVE_LABEL = 1
    METRICS = ("acc",)

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

    def doc_to_target(self, doc):
        return self.CHOICES[0 if doc["label"] == self.POSITIVE_LABEL else 1]

    def construct_requests(self, doc, ctx):
        ll_pos, _ = rf.loglikelihood(ctx, self.CHOICES[0])
        ll_neg, _ = rf.loglikelihood(ctx, self.CHOICES[1])
        return ll_pos, ll_neg

    def process_results(self, doc, results):
        ll_pos, ll_neg = results
        pred = self.POSITIVE_LABEL if ll_pos > ll_neg else 1 - self.POSITIVE_LABEL
        gold = doc["label"]
        out = {}
        if "acc" in self.METRICS:
            out["acc"] = float(pred == gold)
        if "f1" in self.METRICS:
            out["f1"] = (gold, pred)
        if "mcc" in self.METRICS:
            out["mcc"] = (gold, pred)
        return out

    def aggregation(self):
        table = {"acc": metrics.mean, "f1": metrics.f1_score, "mcc": metrics.matthews_corrcoef}
        return {m: table[m] for m in self.METRICS}

    def higher_is_better(self):
        return {m: True for m in self.METRICS}


class CoLA(_GlueBinaryTask):
    DATASET_NAME = "cola"
    METRICS = ("mcc",)

    def doc_to_text(self, doc):
        return f"{doc['sentence']}\nQuestion: Does this sentence make sense?\nAnswer:"


class SST(_GlueBinaryTask):
    DATASET_NAME = "sst2"
    CHOICES = (" positive", " negative")

    def doc_to_text(self, doc):
        from ..text_utils import general_detokenize

        return (
            f"{general_detokenize(doc['sentence'])}\n"
            "Question: Is this sentence positive or negative?\nAnswer:"
        )


class MRPC(_GlueBinaryTask):
    DATASET_NAME = "mrpc"
    METRICS = ("acc", "f1")

    def doc_to_text(self, doc):
        from ..text_utils import general_detokenize

        return (
            f"Sentence 1: {general_detokenize(doc['sentence1'])}\n"
            f"Sentence 2: {general_detokenize(doc['sentence2'])}\n"
            "Question: Do both sentences mean the same thing?\nAnswer:"
        )


class QQP(_GlueBinaryTask):
    DATASET_NAME = "qqp"
    METRICS = ("acc", "f1")

    def doc_to_text(self, doc):
        return (
            f"Question 1: {doc['question1']}\nQuestion 2: {doc['question2']}\n"
            "Question: Do both questions ask the same thing?\nAnswer:"
        )


class QNLI(_GlueBinaryTask):
    DATASET_NAME = "qnli"
    POSITIVE_LABEL = 0  # 0 = entailment -> " yes"

    def doc_to_text(self, doc):
        return (
            f"{doc['question']}\n{doc['sentence']}\n"
            "Question: Does this response answer the question?\nAnswer:"
        )


class RTE(_GlueBinaryTask):
    DATASET_NAME = "rte"
    CHOICES = (" True", " False")
    POSITIVE_LABEL = 0  # 0 = entailment -> " True"

    def doc_to_text(self, doc):
        return f"{doc['sentence1']}\nQuestion: {doc['sentence2']} True or False?\nAnswer:"


class WNLI(_GlueBinaryTask):
    DATASET_NAME = "wnli"
    CHOICES = (" True", " False")
    POSITIVE_LABEL = 1  # 1 = entailment -> " True"

    def doc_to_text(self, doc):
        return f"{doc['sentence1']}\nQuestion: {doc['sentence2']} True or False?\nAnswer:"


class MNLI(Task):
    """Three-way NLI (`glue.py` MNLI): True / Neither / False verbalizers."""

    VERSION = 0
    DATASET_PATH = "glue"
    DATASET_NAME = "mnli"
    VALIDATION_SPLIT = "validation_matched"
    CHOICES = (" True", " Neither", " False")  # label 0 / 1 / 2

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
        return self.dataset[self.VALIDATION_SPLIT]

    def doc_to_text(self, doc):
        hyp = doc["hypothesis"].strip()
        hyp = hyp + ("" if hyp.endswith(".") else ".")
        return f"{doc['premise']}\nQuestion: {hyp} True, False or Neither?\nAnswer:"

    def doc_to_target(self, doc):
        return self.CHOICES[doc["label"]]

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, c)[0] for c in self.CHOICES]

    def process_results(self, doc, results):
        pred = max(range(len(results)), key=lambda i: results[i])
        return {"acc": float(pred == doc["label"])}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}


class MNLIMismatched(MNLI):
    VALIDATION_SPLIT = "validation_mismatched"
