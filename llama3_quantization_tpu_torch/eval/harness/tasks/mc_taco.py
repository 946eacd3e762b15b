"""MC-TACO temporal-commonsense plausibility
(the reference's `lm_eval/tasks/mc_taco.py`): per-candidate yes/no scoring
with question-grouped exact match and F1 (paper §4 metrics).

A copy of `llama3_quantization_tpu/eval/harness/tasks/mc_taco.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from collections import defaultdict

from ..base import Task, rf


class MCTACO(Task):
    VERSION = 0
    DATASET_PATH = "mc_taco"
    DATASET_NAME = None

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def validation_docs(self):
        return self.dataset["validation"]

    def test_docs(self):
        return self.dataset["test"]

    def doc_to_text(self, doc):
        return (
            f"{doc['sentence']}\nQuestion: {doc['question']}\n"
            f"Answer: {doc['answer']}\nPlausible:"
        )

    def doc_to_target(self, doc):
        return " " + ["no", "yes"][doc["label"]]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["question"] + " " + doc["sentence"]

    def construct_requests(self, doc, ctx):
        ll_no, _ = rf.loglikelihood(ctx, " no")
        ll_yes, _ = rf.loglikelihood(ctx, " yes")
        return ll_no, ll_yes

    def process_results(self, doc, results):
        ll_no, ll_yes = results
        gold = doc["label"]
        pred = int(ll_yes > ll_no)
        question_id = " ".join([doc["sentence"], doc["question"]])
        items = (gold, pred, question_id)
        return {"em": items, "f1": items}

    def aggregation(self):
        return {"em": mc_taco_em, "f1": mc_taco_f1}

    def higher_is_better(self):
        return {"em": True, "f1": True}


def mc_taco_em(items):
    """Question counted correct only if every candidate answer for it is
    classified correctly (`mc_taco.py:120-128`)."""
    per_question = defaultdict(list)
    for gold, pred, question in items:
        per_question[question].append(pred == gold)
    correct = [all(oks) for oks in per_question.values()]
    return sum(correct) / len(correct)


def mc_taco_f1(items):
    """Mean per-question F1 over "plausible" labels (`mc_taco.py:131-147`)."""
    gold_pos, pred_pos = defaultdict(list), defaultdict(list)
    for gold, pred, question in items:
        gold_pos[question].append(gold)
        pred_pos[question].append(pred)
    f1s = []
    for q in gold_pos:
        gp, pp = sum(gold_pos[q]), sum(pred_pos[q])
        tp = sum(g and p for g, p in zip(gold_pos[q], pred_pos[q]))
        precision = tp / pp if pp > 0 else 1.0
        recall = tp / gp if gp > 0 else 1.0
        if precision + recall > 0:
            f1s.append(2 * precision * recall / (precision + recall))
    return sum(f1s) / len(f1s) if f1s else 0.0
