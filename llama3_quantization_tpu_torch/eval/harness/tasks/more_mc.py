"""Second tranche of multiple-choice tasks from the reference registry
(the reference's `lm_eval/tasks/__init__.py`): HeadQA, LogiQA, MathQA,
SWAG, PROST, QA4MRE, ToxiGen — same v0.3 prompt formats and splits.

A copy of `llama3_quantization_tpu/eval/harness/tasks/more_mc.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

import re

from ..base import MultipleChoiceTask


class HeadQABase(MultipleChoiceTask):
    """`lm_eval/tasks/headqa.py`: Spanish healthcare-exam MC QA."""

    VERSION = 0
    DATASET_PATH = "EleutherAI/headqa"
    DATASET_NAME = None

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(map(self._process_doc, self.dataset["train"]))
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.dataset["validation"])

    def test_docs(self):
        return map(self._process_doc, self.dataset["test"])

    def _process_doc(self, doc):
        if "query" in doc:
            return doc
        return {
            "id": doc["qid"],
            "query": "Question: " + doc["qtext"] + "\nAnswer:",
            "choices": [a["atext"] for a in doc["answers"]],
            "gold": int(doc["ra"]) - 1,
        }

    def doc_to_text(self, doc):
        return doc["query"]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["query"]


class HeadQAEn(HeadQABase):
    DATASET_NAME = "en"


class HeadQAEs(HeadQABase):
    DATASET_NAME = "es"


class LogiQA(MultipleChoiceTask):
    """`lm_eval/tasks/logiqa.py`: passage + question + lettered options."""

    VERSION = 0
    DATASET_PATH = "EleutherAI/logiqa"
    DATASET_NAME = None

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(map(self._process_doc, self.dataset["train"]))
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.dataset["validation"])

    def test_docs(self):
        return map(self._process_doc, self.dataset["test"])

    def _process_doc(self, doc):
        if "query" in doc:
            return doc
        letters = ["a", "b", "c", "d"]
        prompt = "Passage: " + doc["context"] + "\n"
        prompt += "Question: " + doc["question"] + "\nChoices:\n"
        for letter, option in zip(letters, doc["options"]):
            prompt += f"{letter.upper()}. {option}\n"
        prompt += "Answer:"
        return {
            "passage": doc["context"],
            "query": prompt,
            "choices": doc["options"],
            "gold": letters.index(doc["label"]),
        }

    def doc_to_text(self, doc):
        return doc["query"]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["passage"]


class MathQA(MultipleChoiceTask):
    """`lm_eval/tasks/mathqa.py`: math word problems, options parsed from
    the "a ) ... , b ) ..." string."""

    VERSION = 0
    DATASET_PATH = "math_qa"
    DATASET_NAME = None

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(map(self._process_doc, self.dataset["train"]))
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.dataset["validation"])

    def test_docs(self):
        return map(self._process_doc, self.dataset["test"])

    def _process_doc(self, doc):
        if "query" in doc:
            return doc
        choices = [
            c[4:].rstrip(" ,")
            for c in re.findall(r"[abcd] \) .*?, |e \) .*?$", doc["options"])
        ]
        return {
            "query": "Question: " + doc["Problem"] + "\nAnswer:",
            "choices": choices,
            "gold": ["a", "b", "c", "d", "e"].index(doc["correct"]),
        }

    def doc_to_text(self, doc):
        return doc["query"]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["query"]


class SWAG(MultipleChoiceTask):
    """`lm_eval/tasks/swag.py`: grounded commonsense continuation."""

    VERSION = 0
    DATASET_PATH = "swag"
    DATASET_NAME = "regular"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = list(map(self._process_doc, self.dataset["train"]))
        return self._training_docs

    def validation_docs(self):
        return map(self._process_doc, self.dataset["validation"])

    def _process_doc(self, doc):
        if "query" in doc:
            return doc
        return {
            "query": doc["startphrase"],
            "choices": [doc["ending0"], doc["ending1"], doc["ending2"], doc["ending3"]],
            "gold": int(doc["label"]),
        }

    def doc_to_text(self, doc):
        return doc["query"]


class PROST(MultipleChoiceTask):
    """`lm_eval/tasks/prost.py`: physical-reasoning probes, zero-shot only."""

    VERSION = 0
    DATASET_PATH = "corypaik/prost"
    DATASET_NAME = None

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def test_docs(self):
        return map(self._process_doc, self.dataset["test"])

    def fewshot_context(self, doc, num_fewshot, rnd, description=""):
        if num_fewshot != 0:
            raise ValueError("PROST is zero-shot only")
        return super().fewshot_context(doc, num_fewshot, rnd, description)

    def _process_doc(self, doc):
        if "query" in doc:
            return doc
        return {
            "query": f"{doc['context']}\nQuestion: {doc['ex_question']}\nAnswer:",
            "choices": [doc["A"], doc["B"], doc["C"], doc["D"]],
            "gold": doc["label"],
        }

    def doc_to_text(self, doc):
        return doc["query"]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["query"]


class QA4MRE(MultipleChoiceTask):
    """`lm_eval/tasks/qa4mre.py`: machine-reading evaluation; only a train
    split exists, used as test."""

    VERSION = 0
    DATASET_PATH = "qa4mre"
    DATASET_NAME = None

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def test_docs(self):
        return map(self._process_doc, self.dataset["train"])

    def _process_doc(self, doc):
        if "query" in doc:
            return doc
        return {
            "source": doc["document_str"].strip().replace("'", "'"),
            "query": doc["question_str"],
            "choices": doc["answer_options"]["answer_str"],
            "gold": int(doc["correct_answer_id"]) - 1,
        }

    def doc_to_text(self, doc):
        return "{}\nQuestion: {}\nAnswer:".format(doc["source"], doc["query"])

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["source"] + " " + doc["query"]


class QA4MRE2011(QA4MRE):
    DATASET_NAME = "2011.main.EN"


class QA4MRE2012(QA4MRE):
    DATASET_NAME = "2012.main.EN"


class QA4MRE2013(QA4MRE):
    DATASET_NAME = "2013.main.EN"


class ToxiGen(MultipleChoiceTask):
    """`lm_eval/tasks/toxigen.py`: binary hatefulness classification; label
    from rounded mean of AI+human toxicity annotations (>5.5 = toxic)."""

    VERSION = 0
    DATASET_PATH = "skg/toxigen-data"
    DATASET_NAME = "annotated"

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def training_docs(self):
        if self._training_docs is None:
            self._training_docs = [
                self._process_doc(d) for d in self.dataset["train"]
            ]
        return self._training_docs

    def test_docs(self):
        return map(self._process_doc, self.dataset["test"])

    def _process_doc(self, doc):
        if "query" in doc:
            return doc
        label = int((doc["toxicity_ai"] + doc["toxicity_human"]) > 5.5)
        return {"query": doc["text"], "choices": ["No", "Yes"], "gold": label}

    def doc_to_text(self, doc):
        return (
            "Is the following statement hateful? Respond with either Yes or "
            f"No. Statement: '{doc['query']}'"
        )
