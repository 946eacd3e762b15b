"""SuperGLUE tasks beyond BoolQ/Copa (the reference's `lm_eval/tasks/superglue.py`):
CB, WiC, WSC, MultiRC — same v0.3 prompt formats and metrics.

A copy of `llama3_quantization_tpu/eval/harness/tasks/superglue.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .. import metrics
from ..base import Task, rf


class _SuperGlueTask(Task):
    VERSION = 0
    DATASET_PATH = "super_glue"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(self.dataset["train"])
        return self._training_docs

    def validation_docs(self):
        return self.dataset["validation"]


class CB(_SuperGlueTask):
    """CommitmentBank: 3-way NLI, acc + 3-class macro F1."""

    DATASET_NAME = "cb"
    CHOICES = (" True", " False", " Neither")  # label 0 / 1 / 2

    def doc_to_text(self, doc):
        return (
            f"{doc['premise']}\nQuestion: {doc['hypothesis']}. "
            "True, False or Neither?\nAnswer:"
        )

    def doc_to_target(self, doc):
        return self.CHOICES[doc["label"]]

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, c)[0] for c in self.CHOICES]

    def process_results(self, doc, results):
        pred = max(range(len(results)), key=lambda i: results[i])
        gold = doc["label"]
        return {"acc": float(pred == gold), "f1": (gold, pred)}

    def aggregation(self):
        return {"acc": metrics.mean, "f1": metrics.f1_macro}

    def higher_is_better(self):
        return {"acc": True, "f1": True}


class _YesNoSuperGlue(_SuperGlueTask):
    def construct_requests(self, doc, ctx):
        ll_yes, _ = rf.loglikelihood(ctx, " yes")
        ll_no, _ = rf.loglikelihood(ctx, " no")
        return ll_yes, ll_no

    def doc_to_target(self, doc):
        return " yes" if doc["label"] else " no"

    def process_results(self, doc, results):
        ll_yes, ll_no = results
        return {"acc": float((ll_yes > ll_no) == bool(doc["label"]))}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}


class WiC(_YesNoSuperGlue):
    """Word-in-Context: same word sense in both sentences?"""

    DATASET_NAME = "wic"

    def doc_to_text(self, doc):
        return (
            f"Sentence 1: {doc['sentence1']}\nSentence 2: {doc['sentence2']}\n"
            f"Question: Is the word '{doc['sentence1'][doc['start1']:doc['end1']]}'"
            " used in the same way in the two sentences above?\nAnswer:"
        )


class WSC(_YesNoSuperGlue):
    """Winograd Schema Challenge: pronoun coreference as yes/no. The
    pronoun is *starred* in the detokenized passage
    (`lm_eval/tasks/superglue.py:453-466`)."""

    DATASET_NAME = "wsc"

    def doc_to_text(self, doc):
        from ..text_utils import general_detokenize

        raw = doc["text"]
        # HF span indices are word-based
        pre = " ".join(raw.split()[: doc["span2_index"]])
        post = raw[len(pre) + len(doc["span2_text"]) + 1 :]
        passage = general_detokenize(pre + " *{}*".format(doc["span2_text"]) + post)
        return (
            f"Passage: {passage}\n"
            f'Question: In the passage above, does the pronoun "*{doc["span2_text"]}*" '
            f'refer to "*{doc["span1_text"]}*"?\nAnswer:'
        )


class MultiRC(_SuperGlueTask):
    """Multi-sentence reading comprehension: every candidate answer of a
    question must be judged correctly (question-level `acc_all`)."""

    DATASET_NAME = "multirc"

    def doc_to_text(self, doc):
        return f"{doc['paragraph']}\nQuestion: {doc['question']}\nAnswer:"

    @staticmethod
    def format_answer(answer, label):
        label_str = "yes" if label else "no"
        return f" {answer}\nIs the answer correct? {label_str}"

    def doc_to_target(self, doc):
        return self.format_answer(doc["answer"], doc["label"])

    def construct_requests(self, doc, ctx):
        ll_true, _ = rf.loglikelihood(ctx, self.format_answer(doc["answer"], True))
        ll_false, _ = rf.loglikelihood(ctx, self.format_answer(doc["answer"], False))
        return ll_true, ll_false

    def process_results(self, doc, results):
        ll_true, ll_false = results
        pred = ll_true > ll_false
        return {"acc": (float(pred == bool(doc["label"])), doc)}

    def aggregation(self):
        return {"acc": metrics.acc_all}

    def higher_is_better(self):
        return {"acc": True}


class ReCoRD(_SuperGlueTask):
    """ReCoRD (`lm_eval/tasks/superglue.py:276-366`): cloze-style entity
    filling — score every candidate entity substituted into @placeholder,
    report per-example max-over-answers token F1 and EM."""

    DATASET_NAME = "record"

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = [
                self._process_doc(doc) for doc in self.dataset["train"]
            ]
        return self._training_docs

    def validation_docs(self):
        for doc in self.dataset["validation"]:
            yield self._process_doc(doc)

    @classmethod
    def _process_doc(cls, doc):
        if "entities" in doc and isinstance(doc["entities"], list):
            doc = dict(doc)
            doc["entities"] = sorted(set(doc["entities"]))
            doc["answers"] = sorted(set(doc["answers"]))
            return doc
        return doc

    def doc_to_text(self, doc):
        initial_text, *highlights = doc["passage"].strip().split("\n@highlight\n")
        text = initial_text + "\n\n"
        for highlight in highlights:
            text += f"  - {highlight}.\n"
        return text

    @classmethod
    def format_answer(cls, query, entity):
        return f"  - {query}".replace("@placeholder", entity)

    def doc_to_target(self, doc):
        return self.format_answer(query=doc["query"], entity=doc["answers"][0])

    def construct_requests(self, doc, ctx):
        return [
            rf.loglikelihood(ctx, self.format_answer(query=doc["query"], entity=entity))
            for entity in doc["entities"]
        ]

    def process_results(self, doc, results):
        max_idx = max(range(len(results)), key=lambda i: results[i][0])
        prediction = doc["entities"][max_idx]
        gold = doc["answers"]
        return {
            "f1": metrics.metric_max_over_ground_truths(metrics.squad_f1, prediction, gold),
            "em": metrics.metric_max_over_ground_truths(metrics.squad_em, prediction, gold),
        }

    def aggregation(self):
        return {"f1": metrics.mean, "em": metrics.mean}

    def higher_is_better(self):
        return {"f1": True, "em": True}
