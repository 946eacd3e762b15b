"""RACE reading comprehension (the reference's `lm_eval/tasks/race.py`):
one document per article (questions collated GPT-3 style, earlier problems
shown answered in the context), score the last problem's four options.

A copy of `llama3_quantization_tpu/eval/harness/tasks/race.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

import collections

from .. import metrics
from ..base import Task, rf

LETTER_TO_NUM = {"A": 0, "B": 1, "C": 2, "D": 3}


class RACE(Task):
    VERSION = 1
    DATASET_PATH = "race"
    DATASET_NAME = "high"

    def __init__(self, data=None):
        self._collated = {}
        super().__init__(data=data)

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def _collate(self, split):
        """Group per-question HF rows back into per-article documents
        (`race.py:59-84`). Pre-collated injected docs pass through."""
        if split in self._collated:
            return self._collated[split]
        rows = list(self.dataset[split])
        if rows and "problems" in rows[0]:
            docs = rows
        else:
            by_article = collections.defaultdict(list)
            for item in rows:
                by_article[item["article"]].append(item)
            docs = [
                {
                    "article": items[0]["article"],
                    "problems": [
                        {
                            "question": y["question"],
                            "answer": y["answer"],
                            "options": y["options"],
                        }
                        for y in items
                    ],
                }
                for items in by_article.values()
            ]
        self._collated[split] = docs
        return docs

    def training_docs(self):
        return self._collate("train")

    def validation_docs(self):
        return self._collate("validation")

    def test_docs(self):
        return self._collate("test")

    @classmethod
    def get_answer_option(cls, problem):
        return problem["options"][LETTER_TO_NUM[problem["answer"]]]

    @classmethod
    def last_problem(cls, doc):
        return doc["problems"][-1]

    def doc_to_text(self, doc):
        text = "Article: " + doc["article"] + "\n\n"
        for problem in doc["problems"][:-1]:
            if problem["question"][-6:] == "  _  .":
                text += problem["question"][-5:] + self.get_answer_option(problem) + "\n"
            else:
                text += "Question: " + problem["question"] + "\n"
                text += "Answer: " + self.get_answer_option(problem) + "\n"
        text += self.last_problem(doc)["question"]
        return text

    def doc_to_target(self, doc):
        return " " + self.get_answer_option(self.last_problem(doc))

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["article"]

    def construct_requests(self, doc, ctx):
        problem = self.last_problem(doc)
        return [rf.loglikelihood(ctx, " " + option)[0] for option in problem["options"]]

    def process_results(self, doc, results):
        gold = LETTER_TO_NUM[self.last_problem(doc)["answer"]]
        pred = max(range(len(results)), key=lambda i: results[i])
        return {"acc": float(pred == gold)}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}
