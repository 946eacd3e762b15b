"""Additional multiple-choice tasks from the reference's registry
(the reference's `lm_eval/tasks/__init__.py`): COPA, OpenBookQA, SciQ —
same v0.3 prompt formats.

A copy of `llama3_quantization_tpu/eval/harness/tasks/extra_mc.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from ..base import MultipleChoiceTask, Task, rf
from .. import metrics


class Copa(Task):
    """SuperGLUE COPA (`lm_eval/tasks/superglue.py` Copa)."""

    VERSION = 0
    DATASET_PATH = "super_glue"
    DATASET_NAME = "copa"

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
        connector = {"cause": "because", "effect": "therefore"}[doc["question"]]
        return doc["premise"].strip()[:-1] + f" {connector}"

    def doc_to_target(self, doc):
        correct = doc["choice1"] if doc["label"] == 0 else doc["choice2"]
        return " " + self.convert_choice(correct)

    @staticmethod
    def convert_choice(choice):
        return choice[0].lower() + choice[1:]

    def construct_requests(self, doc, ctx):
        ll1, _ = rf.loglikelihood(ctx, " " + self.convert_choice(doc["choice1"]))
        ll2, _ = rf.loglikelihood(ctx, " " + self.convert_choice(doc["choice2"]))
        return ll1, ll2

    def process_results(self, doc, results):
        ll1, ll2 = results
        pred = 0 if ll1 > ll2 else 1
        return {"acc": float(pred == doc["label"])}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}


class OpenBookQA(MultipleChoiceTask):
    """`lm_eval/tasks/openbookqa.py`."""

    VERSION = 0
    DATASET_PATH = "openbookqa"
    DATASET_NAME = "main"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(map(self._process_doc, self.dataset["train"]))
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.dataset["validation"])

    def test_docs(self):
        return map(self._process_doc, self.dataset["test"])

    def _process_doc(self, doc):
        if "query" in doc:
            return doc
        return {
            "id": doc["id"],
            "query": doc["question_stem"],
            "choices": doc["choices"]["text"],
            "gold": ["A", "B", "C", "D"].index(doc["answerKey"].strip()),
        }

    def doc_to_text(self, doc):
        return doc["query"]


class SciQ(MultipleChoiceTask):
    """`lm_eval/tasks/sciq.py`: support passage + question, 4 options."""

    VERSION = 0
    DATASET_PATH = "sciq"
    DATASET_NAME = None

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(map(self._process_doc, self.dataset["train"]))
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.dataset["validation"])

    def test_docs(self):
        return map(self._process_doc, self.dataset["test"])

    def _process_doc(self, doc):
        if "query" in doc:
            return doc
        choices = [
            doc["distractor1"],
            doc["distractor2"],
            doc["distractor3"],
            doc["correct_answer"],
        ]
        src = doc.get("support", "") or ""
        return {
            "query": f"{src}\nQuestion: {doc['question']}\nAnswer:".strip(),
            "choices": choices,
            "gold": 3,
        }

    def doc_to_text(self, doc):
        return doc["query"]
