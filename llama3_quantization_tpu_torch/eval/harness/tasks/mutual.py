"""MuTual dialogue-reasoning tasks (the reference's `lm_eval/tasks/mutual.py`):
rank four response options by loglikelihood; report R@1, R@2 and MRR.

A copy of `llama3_quantization_tpu/eval/harness/tasks/mutual.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .. import metrics
from ..base import Task, rf

CHOICES = ["A", "B", "C", "D"]


def detokenize(text: str) -> str:
    """Undo PTB-style tokenization in the MuTual transcripts
    (`mutual.py:69-85`)."""
    text = text.replace(" '", "'")
    text = text.replace(" \n", "\n")
    text = text.replace("\n ", "\n")
    text = text.replace(" n't", "n't")
    text = text.replace("`` ", '"')
    text = text.replace("''", '"')
    for punct in [":", ";", "!", "?", ",", "."]:
        text = text.replace(f" {punct}", punct)
    return text


class MuTualBase(Task):
    VERSION = 1
    DATASET_PATH = "mutual"
    DATASET_NAME = None

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
        return detokenize(doc["article"])

    def doc_to_target(self, doc):
        return " " + detokenize(doc["options"][CHOICES.index(doc["answers"])])

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["article"]

    def construct_requests(self, doc, ctx):
        return [
            rf.loglikelihood(ctx, f" {detokenize(option)}")[0]
            for option in doc["options"]
        ]

    def process_results(self, doc, results):
        gold = CHOICES.index(doc["answers"])
        results = list(results)
        r_at_1 = float(max(range(len(results)), key=lambda i: results[i]) == gold)
        ranks = sorted(results, reverse=True)
        gold_rank = ranks.index(results[gold])
        r_at_2 = float(gold_rank == 1) + r_at_1
        mrr = 1.0 / (gold_rank + 1)
        return {"r@1": r_at_1, "r@2": r_at_2, "mrr": mrr}

    def aggregation(self):
        return {"r@1": metrics.mean, "r@2": metrics.mean, "mrr": metrics.mean}

    def higher_is_better(self):
        return {"r@1": True, "r@2": True, "mrr": True}


class MuTual(MuTualBase):
    DATASET_NAME = "mutual"


class MuTualPlus(MuTualBase):
    DATASET_NAME = "mutual_plus"
