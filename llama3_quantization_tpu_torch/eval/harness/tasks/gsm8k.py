"""GSM8K generative task (the reference's `lm_eval/tasks/gsm8k.py:30-115`).

A copy of `llama3_quantization_tpu/eval/harness/tasks/gsm8k.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

import re

from ..base import Task, rf
from .. import metrics

ANS_RE = re.compile(r"#### (\-?[0-9\.\,]+)")
INVALID_ANS = "[invalid]"


class GSM8K(Task):
    VERSION = 0
    DATASET_PATH = "gsm8k"
    DATASET_NAME = "main"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.dataset["train"])
        return self._training_docs

    def test_docs(self):
        return self.dataset["test"]

    def doc_to_text(self, doc):
        return "Question: " + doc["question"] + "\nAnswer:"

    def doc_to_target(self, doc):
        return " " + doc["answer"]

    def construct_requests(self, doc, ctx):
        return rf.greedy_until(ctx, ["\n"])

    def _extract_answer(self, completion):
        match = ANS_RE.search(completion)
        if match:
            return match.group(1).strip().replace(",", "")
        return INVALID_ANS

    def process_results(self, doc, results):
        completion = results[0] if isinstance(results, (list, tuple)) else results
        gold = self._extract_answer(doc["answer"])
        return {"acc": float(self._extract_answer(completion) == gold)}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}
