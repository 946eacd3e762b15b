"""LAMBADA (openai variant; the reference's `lm_eval/tasks/lambada.py`):
predict the final word; metrics ppl = exp(-ll) and greedy accuracy.

A copy of `llama3_quantization_tpu/eval/harness/tasks/lambada.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from ..base import Task, rf
from .. import metrics


class Lambada(Task):
    VERSION = 0
    DATASET_PATH = "EleutherAI/lambada_openai"
    DATASET_NAME = "default"

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def validation_docs(self):
        return self.dataset["test"] if "test" in self.dataset else self.dataset["validation"]

    def doc_to_text(self, doc):
        return doc["text"].rsplit(" ", 1)[0]

    def doc_to_target(self, doc):
        return " " + doc["text"].rsplit(" ", 1)[1]

    def construct_requests(self, doc, ctx):
        # two indexed promises so (ll, is_greedy) route back separately
        ll, is_greedy = rf.loglikelihood(ctx, self.doc_to_target(doc))
        return ll, is_greedy

    def process_results(self, doc, results):
        ll, is_greedy = results
        return {"ppl": ll, "acc": int(is_greedy)}

    def aggregation(self):
        return {"ppl": metrics.perplexity, "acc": metrics.mean}

    def higher_is_better(self):
        return {"ppl": False, "acc": True}


class LambadaStandard(Lambada):
    """The original LAMBADA test split (`lm_eval/tasks/lambada.py` variant
    registered as `lambada_standard`)."""

    DATASET_PATH = "lambada"
    DATASET_NAME = None


class LambadaCloze(Lambada):
    """Cloze-styled prompt variant (`lm_eval/tasks/lambada_cloze.py`
    LambadaOpenAICloze)."""

    def doc_to_text(self, doc):
        return doc["text"].rsplit(" ", 1)[0] + " ____. ->"


class LambadaStandardCloze(LambadaStandard):
    """Cloze-styled original test split (`lm_eval/tasks/lambada_cloze.py`
    LambadaStandardCloze)."""

    def doc_to_text(self, doc):
        return doc["text"].rsplit(" ", 1)[0] + " ____. ->"
