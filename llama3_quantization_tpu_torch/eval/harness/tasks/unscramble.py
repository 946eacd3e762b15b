"""GPT-3 word-unscrambling probes
(the reference's `lm_eval/tasks/unscramble.py`): greedy generation until
newline, exact-match accuracy against the unscrambled completion.

A copy of `llama3_quantization_tpu/eval/harness/tasks/unscramble.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .. import metrics
from ..base import Task, rf


class WordUnscramble(Task):
    VERSION = 0
    DATASET_PATH = "unscramble"
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
        return rf.greedy_until(ctx, ["\n"])

    def process_results(self, doc, results):
        pred = results[0] if isinstance(results, (list, tuple)) else results
        return {"acc": float(pred == doc["completion"])}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}


#: registry-name -> dataset config (`unscramble.py:78-94`)
UNSCRAMBLE_CONFIGS = {
    "anagrams1": "mid_word_1_anagrams",
    "anagrams2": "mid_word_2_anagrams",
    "cycle_letters": "cycle_letters_in_word",
    "random_insertion": "random_insertion_in_word",
    "reversed_words": "reversed_words",
}


def create_unscramble_task(name: str):
    class _Unscr(WordUnscramble):
        DATASET_NAME = UNSCRAMBLE_CONFIGS[name]

    _Unscr.__name__ = name
    return _Unscr
