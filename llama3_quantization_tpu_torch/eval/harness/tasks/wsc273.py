"""Winograd Schema Challenge 273 (the reference's `lm_eval/tasks/wsc273.py`):
partial-evaluation scoring — substitute each candidate into the pronoun slot
and compare the loglikelihood of the shared continuation.

A copy of `llama3_quantization_tpu/eval/harness/tasks/wsc273.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .. import metrics
from ..base import Task, rf

UPPER_PRONOUNS = [
    "A", "An", "The", "She", "He", "It", "They", "My", "His", "Her", "Their",
]


class WinogradSchemaChallenge273(Task):
    VERSION = 0
    DATASET_PATH = "winograd_wsc"
    DATASET_NAME = "wsc273"

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def test_docs(self):
        return map(self._process_doc, self.dataset["test"])

    def _process_doc(self, doc):
        doc = dict(doc)
        doc["text"] = doc["text"].replace("  ", " ")
        doc["options"] = [
            self._normalize_option(doc, doc["options"][0]),
            self._normalize_option(doc, doc["options"][1]),
        ]
        return doc

    def _normalize_option(self, doc, option):
        # possessive pronouns need "'s"; mid-sentence candidates lowercase
        if doc["pronoun"].lower() in ["my", "his", "her", "our", "their"]:
            option += "'s"
        pronoun = option.split()[0]
        start_of_sentence = doc["text"][doc["pronoun_loc"] - 2] == "."
        if not start_of_sentence and pronoun in UPPER_PRONOUNS:
            return option.replace(pronoun, pronoun.lower())
        return option

    def fewshot_examples(self, k, rnd):
        # test-only dataset: sample shots from the test docs
        if self._fewshot_docs is None:
            self._fewshot_docs = list(self.test_docs())
        return rnd.sample(self._fewshot_docs, k)

    @classmethod
    def partial_context(cls, doc, option):
        return doc["text"][: doc["pronoun_loc"]] + option

    @classmethod
    def partial_target(cls, doc):
        start = doc["pronoun_loc"] + len(doc["pronoun"])
        return " " + doc["text"][start:].strip()

    def doc_to_text(self, doc):
        return self.partial_context(doc, doc["options"][doc["label"]])

    def doc_to_target(self, doc):
        return self.partial_target(doc)

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["text"]

    @classmethod
    def append_context(cls, ctx, partial_ctx):
        parts = ctx.split("\n\n")
        parts.pop()  # drop the doc_to_text context; we substitute our own
        return "\n\n".join([*parts, partial_ctx]) if parts else partial_ctx

    def construct_requests(self, doc, ctx):
        target = self.partial_target(doc)
        return [
            rf.loglikelihood(self.append_context(ctx, self.partial_context(doc, opt)), target)[0]
            for opt in doc["options"]
        ]

    def process_results(self, doc, results):
        pred = max(range(len(results)), key=lambda i: results[i])
        return {"acc": float(pred == doc["label"])}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}
