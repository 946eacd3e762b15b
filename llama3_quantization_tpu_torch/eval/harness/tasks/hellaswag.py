"""HellaSwag (the reference's `lm_eval/tasks/hellaswag.py:28-76`).

A copy of `llama3_quantization_tpu/eval/harness/tasks/hellaswag.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

import re

from ..base import MultipleChoiceTask


class HellaSwag(MultipleChoiceTask):
    VERSION = 0
    DATASET_PATH = "hellaswag"
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
        if "query" in doc:
            return doc
        ctx = doc["ctx_a"] + " " + doc["ctx_b"].capitalize()
        return {
            "query": self.preprocess(doc["activity_label"] + ": " + ctx),
            "choices": [self.preprocess(ending) for ending in doc["endings"]],
            "gold": int(doc["label"]),
        }

    @classmethod
    def preprocess(cls, text):
        text = text.strip()
        # brackets are artifacts of the WikiHow portion of HellaSwag
        text = text.replace(" [title]", ". ")
        text = re.sub("\\[.*?\\]", "", text)
        text = text.replace("  ", " ")
        return text

    def doc_to_text(self, doc):
        return doc["query"]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["query"]
