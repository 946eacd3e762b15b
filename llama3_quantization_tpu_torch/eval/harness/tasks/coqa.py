"""CoQA conversational QA (the reference's `lm_eval/tasks/coqa.py`):
passage + dialogue history prompt, greedy generation until "\\nQ:", scored
with leave-one-out max EM/F1 over the gold answer set.

A copy of `llama3_quantization_tpu/eval/harness/tasks/coqa.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from itertools import zip_longest

from .. import metrics
from ..base import Task, rf


class CoQA(Task):
    VERSION = 1
    DATASET_PATH = "EleutherAI/coqa"
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
        # passage, then q/a turns with the final answer left blank
        text = doc["story"] + "\n\n"
        for q, a in zip_longest(
            doc["questions"]["input_text"], doc["answers"]["input_text"][:-1]
        ):
            text += f"Q: {q}\n\n"
            text += f"A: {a}\n\n" if a is not None else "A:"
        return text

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["story"] + " " + "\n".join(doc["questions"]["input_text"])

    @classmethod
    def get_answers(cls, doc, turn_id):
        answers = [doc["answers"]["input_text"][turn_id - 1]]
        for alt in (doc.get("additional_answers") or {}).values():
            candidate = alt["input_text"][turn_id - 1]
            if candidate.lower() not in map(str.lower, answers):
                answers.append(candidate)
        return answers

    @staticmethod
    def compute_scores(gold_list, pred):
        """Leave-one-out over multiple golds (`coqa.py:102-124`)."""
        f1_sum = em_sum = 0.0
        if len(gold_list) > 1:
            for i in range(len(gold_list)):
                rest = gold_list[:i] + gold_list[i + 1 :]
                em_sum += max(metrics.squad_em(pred, a) for a in rest)
                f1_sum += max(metrics.squad_f1(pred, a) for a in rest)
        else:
            em_sum = max(metrics.squad_em(pred, a) for a in gold_list)
            f1_sum = max(metrics.squad_f1(pred, a) for a in gold_list)
        n = max(1, len(gold_list))
        return {"em": em_sum / n, "f1": f1_sum / n}

    def doc_to_target(self, doc, turnid=None):
        if turnid is None:
            turnid = len(doc["questions"]["input_text"])
        return " " + doc["answers"]["input_text"][turnid - 1]

    def construct_requests(self, doc, ctx):
        return rf.greedy_until(ctx, ["\nQ:"])

    def process_results(self, doc, results):
        turn_id = len(doc["questions"]["input_text"])
        gold_list = self.get_answers(doc, turn_id)
        pred = results[0].strip().split("\n")[0]
        return self.compute_scores(gold_list, pred)

    def aggregation(self):
        return {"f1": metrics.mean, "em": metrics.mean}

    def higher_is_better(self):
        return {"f1": True, "em": True}
