"""GPT-3 arithmetic probes (the reference's `lm_eval/tasks/arithmetic.py`):
score the exact completion by greedy match of its loglikelihood request.

A copy of `llama3_quantization_tpu/eval/harness/tasks/arithmetic.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .. import metrics
from ..base import Task, rf


class Arithmetic(Task):
    VERSION = 0
    DATASET_PATH = "EleutherAI/arithmetic"
    DATASET_NAME = None

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def validation_docs(self):
        return self.dataset["validation"]

    def doc_to_text(self, doc):
        return doc["context"]

    def doc_to_target(self, doc):
        return doc["completion"]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["context"]

    def construct_requests(self, doc, ctx):
        _, is_prediction = rf.loglikelihood(ctx, doc["completion"])
        return is_prediction

    def process_results(self, doc, results):
        (is_prediction,) = results if isinstance(results, (list, tuple)) else (results,)
        return {"acc": float(is_prediction)}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}


#: registry-name -> HF config, matching `arithmetic.py:79-117`
ARITHMETIC_CONFIGS = [
    "arithmetic_2da",
    "arithmetic_2ds",
    "arithmetic_3da",
    "arithmetic_3ds",
    "arithmetic_4da",
    "arithmetic_4ds",
    "arithmetic_5da",
    "arithmetic_5ds",
    "arithmetic_2dm",
    "arithmetic_1dc",
]


def create_arithmetic_task(name: str):
    class _Arith(Arithmetic):
        DATASET_NAME = name

    _Arith.__name__ = name
    return _Arith
