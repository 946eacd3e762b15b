"""Open-domain QA via alias greedy-match (the reference's `lm_eval/tasks/
triviaqa.py`, `webqs.py`): one loglikelihood per (prefix-deduped) answer
alias; correct if any alias is the model's greedy continuation.

A copy of `llama3_quantization_tpu/eval/harness/tasks/qa_free.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .. import metrics
from ..base import Task, rf


def remove_prefixes(aliases):
    """Drop aliases that have a strict prefix elsewhere in the list — a
    greedy-matched prefix already proves the answer (`triviaqa.py:66-74`)."""
    aliases = sorted(aliases)
    kept = [aliases[0]]
    for alias in aliases[1:]:
        if not alias.startswith(kept[-1]):
            kept.append(alias)
    return kept


class TriviaQA(Task):
    VERSION = 1
    DATASET_PATH = "trivia_qa"
    DATASET_NAME = "rc.nocontext"

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
        return f"Question: {doc['question']}\nAnswer:"

    def doc_to_target(self, doc):
        return " " + doc["answer"]["value"]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["question"]

    def construct_requests(self, doc, ctx):
        return [
            rf.loglikelihood(ctx, " " + alias)[1]
            for alias in remove_prefixes(doc["answer"]["aliases"])
        ]

    def process_results(self, doc, results):
        return {"acc": float(any(results))}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}


class WebQs(Task):
    VERSION = 0
    DATASET_PATH = "web_questions"
    DATASET_NAME = None

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
        return " " + doc["answers"][0]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["question"]

    def construct_requests(self, doc, ctx):
        return [
            rf.loglikelihood(ctx, " " + alias)[1]
            for alias in remove_prefixes(doc["answers"])
        ]

    def process_results(self, doc, results):
        return {"acc": float(any(results))}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}
