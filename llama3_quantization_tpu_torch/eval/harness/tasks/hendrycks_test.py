"""MMLU / hendrycksTest-* 57-subject factory
(the reference's `lm_eval/tasks/hendrycks_test.py:92-235`).

The fork scores the *full choice text* (not the letter) and draws fewshot
examples from the dev split. Offline data injection: pass
`data={"test": [...], "validation": [...], "dev": [...]}` with docs
holding question/choices/answer.

A copy of `llama3_quantization_tpu/eval/harness/tasks/hendrycks_test.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from ..base import MultipleChoiceTask

SUBJECTS = [
    "abstract_algebra", "anatomy", "astronomy", "business_ethics",
    "clinical_knowledge", "college_biology", "college_chemistry",
    "college_computer_science", "college_mathematics", "college_medicine",
    "college_physics", "computer_security", "conceptual_physics",
    "econometrics", "electrical_engineering", "elementary_mathematics",
    "formal_logic", "global_facts", "high_school_biology",
    "high_school_chemistry", "high_school_computer_science",
    "high_school_european_history", "high_school_geography",
    "high_school_government_and_politics", "high_school_macroeconomics",
    "high_school_mathematics", "high_school_microeconomics",
    "high_school_physics", "high_school_psychology", "high_school_statistics",
    "high_school_us_history", "high_school_world_history", "human_aging",
    "human_sexuality", "international_law", "jurisprudence",
    "logical_fallacies", "machine_learning", "management", "marketing",
    "medical_genetics", "miscellaneous", "moral_disputes",
    "moral_scenarios", "nutrition", "philosophy", "prehistory",
    "professional_accounting", "professional_law", "professional_medicine",
    "professional_psychology", "public_relations", "security_studies",
    "sociology", "us_foreign_policy", "virology", "world_religions",
]

KEYS = ["A", "B", "C", "D"]


class GeneralHendrycksTest(MultipleChoiceTask):
    VERSION = 0
    DATASET_PATH = "cais/mmlu"

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def validation_docs(self):
        return map(self._process_doc, self.dataset["validation"])

    def test_docs(self):
        return map(self._process_doc, self.dataset["test"])

    def _process_doc(self, doc):
        if "query" in doc:
            return doc
        prompt = "Question: " + doc["question"] + "\nChoices:\n"
        prompt += "".join(
            f"{key}. {choice}\n" for key, choice in zip(KEYS, doc["choices"])
        )
        prompt += "Answer:"
        answer = doc["answer"]
        return {
            "query": prompt,
            "choices": doc["choices"],
            "gold": answer if isinstance(answer, int) else KEYS.index(answer),
        }

    def fewshot_examples(self, k, rnd):
        # dev split is in-distribution for val/test; auxiliary_train is not
        if self._fewshot_docs is None:
            self._fewshot_docs = list(map(self._process_doc, self.dataset["dev"]))
        return rnd.sample(list(self._fewshot_docs), k)

    def doc_to_text(self, doc):
        return doc["query"]


def create_mmlu_task(subject: str):
    class HendrycksTest(GeneralHendrycksTest):
        DATASET_NAME = subject

    HendrycksTest.__name__ = f"HendrycksTest_{subject}"
    return HendrycksTest
