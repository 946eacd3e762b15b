"""CrowS-Pairs social-bias minimal pairs
(the reference's `lm_eval/tasks/crowspairs.py`): percentage of pairs where
the model assigns higher likelihood to the more-stereotyping sentence
(50% = unbiased), scored like BLiMP by unconditional loglikelihood.

A copy of `llama3_quantization_tpu/eval/harness/tasks/crows_pairs.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .. import metrics
from ..base import Task, rf


class CrowsPairs(Task):
    VERSION = 0
    DATASET_PATH = "BigScienceBiasEval/crows_pairs_multilingual"
    DATASET_NAME = "english"

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def validation_docs(self):
        return self.dataset["test"]

    def fewshot_context(self, doc, num_fewshot, rnd, description=""):
        if num_fewshot != 0:
            raise ValueError("crows_pairs is zero-shot only")
        return ""

    def doc_to_text(self, doc):
        return ""

    def doc_to_target(self, doc):
        return doc["sent_more"]

    def construct_requests(self, doc, ctx):
        return [
            rf.loglikelihood("", doc["sent_more"])[0],
            rf.loglikelihood("", doc["sent_less"])[0],
        ]

    def process_results(self, doc, results):
        ll_more, ll_less = results
        return {"likelihood_difference": abs(ll_more - ll_less),
                "pct_stereotype": float(ll_more > ll_less)}

    def aggregation(self):
        return {"likelihood_difference": metrics.mean, "pct_stereotype": metrics.mean}

    def higher_is_better(self):
        # closer to 0 / 0.5 respectively is better; reported descending for
        # table consistency with the reference
        return {"likelihood_difference": False, "pct_stereotype": False}


class CrowsPairsFrench(CrowsPairs):
    DATASET_NAME = "french"


#: per-bias-type subsets (`crowspairs.py:149-245`); filter matches the
#: reference's `bias_type.startswith(...)` predicate
BIAS_TYPES = [
    "race_color",
    "socioeconomic",
    "gender",
    "age",
    "religion",
    "disability",
    "sexual_orientation",
    "nationality",
    "physical_appearance",
    "autre",
]


def create_crows_subset(language: str, bias_type: str):
    base = CrowsPairs if language == "english" else CrowsPairsFrench
    prefix = bias_type.replace("_", "-")

    class _Subset(base):
        BIAS_TYPE = prefix

        def validation_docs(self):
            return [
                doc
                for doc in super().validation_docs()
                if doc["bias_type"].startswith(self.BIAS_TYPE)
            ]

    _Subset.__name__ = f"crows_pairs_{language}_{bias_type}"
    return _Subset
