"""Harness core types: LM interface, Request plumbing, Task API (a copy
of `llama3_quantization_tpu/eval/harness/base.py`, held equal to it by
`tests/test_torch_harness.py`).

Mirrors the reference harness's `lm_eval/base.py` semantics (request types at
:20-117, Task at :374-643, MultipleChoiceTask :646-679, PerplexityTask
:682-761, Request/RequestFactory :844-892) in a compact functional style.
"""

from __future__ import annotations

import abc
import random
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

REQUEST_RETURN_LENGTHS = {
    "loglikelihood": 2,
    "greedy_until": None,
    "loglikelihood_rolling": None,
}


class LM(abc.ABC):
    """Abstract language model over three request types
    (`lm_eval/base.py:20-117`)."""

    @abc.abstractmethod
    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        """[(ctx, continuation)] -> [(logprob, is_greedy)]"""

    @abc.abstractmethod
    def loglikelihood_rolling(self, requests) -> List[float]:
        """[(string,)] -> [sum logprob over rolling windows]"""

    @abc.abstractmethod
    def greedy_until(self, requests) -> List[str]:
        """[(ctx, stop_sequences)] -> [generated text]"""


class Request:
    """Indexable promise for one LM call (`lm_eval/base.py:844-880`)."""

    def __init__(self, request_type: str, args: tuple, index: Optional[int] = None):
        if request_type not in REQUEST_RETURN_LENGTHS:
            raise NotImplementedError(f"request type {request_type} undefined")
        self.request_type = request_type
        self.args = args
        self.index = index

    def __iter__(self):
        if REQUEST_RETURN_LENGTHS[self.request_type] is None:
            raise IndexError("this request type returns a single output")
        for i in range(REQUEST_RETURN_LENGTHS[self.request_type]):
            yield Request(self.request_type, self.args, i)

    def __getitem__(self, i: int):
        if REQUEST_RETURN_LENGTHS[self.request_type] is None:
            raise IndexError("this request type returns a single output")
        return Request(self.request_type, self.args, i)

    def __repr__(self):
        return f"Req_{self.request_type}{self.args}[{self.index}]"


class RequestFactory:
    def __getattr__(self, attr: str):
        def fn(*args):
            return Request(attr, args)

        return fn


rf = RequestFactory()


class Task(abc.ABC):
    """One benchmark dataset + prompting + metrics
    (`lm_eval/base.py:374-643`).

    Subclasses either rely on HF `datasets` (DATASET_PATH/NAME) or accept
    injected documents (offline operation) via `data` overrides.
    """

    VERSION: int = 0
    DATASET_PATH: Optional[str] = None
    DATASET_NAME: Optional[str] = None

    def __init__(self, data: Optional[Dict[str, List[dict]]] = None):
        self.dataset: Optional[Dict[str, List[dict]]] = data
        self._training_docs: Optional[list] = None
        self._fewshot_docs: Optional[list] = None
        if self.dataset is None:
            self.download()

    def download(self):
        try:
            import datasets

            self.dataset = datasets.load_dataset(
                self.DATASET_PATH, self.DATASET_NAME, trust_remote_code=True
            )
        except Exception as e:  # zero-egress container without cache
            raise RuntimeError(
                f"dataset {self.DATASET_PATH}/{self.DATASET_NAME} unavailable "
                f"offline — pass `data={{split: [docs]}}` to the task ({e})"
            ) from e

    # --- doc access -------------------------------------------------------
    @abc.abstractmethod
    def has_training_docs(self) -> bool: ...

    @abc.abstractmethod
    def has_validation_docs(self) -> bool: ...

    @abc.abstractmethod
    def has_test_docs(self) -> bool: ...

    def training_docs(self) -> Iterable[dict]:
        return []

    def validation_docs(self) -> Iterable[dict]:
        return []

    def test_docs(self) -> Iterable[dict]:
        return []

    def _process_doc(self, doc: dict) -> dict:
        return doc

    # --- prompting --------------------------------------------------------
    @abc.abstractmethod
    def doc_to_text(self, doc: dict) -> str: ...

    @abc.abstractmethod
    def doc_to_target(self, doc: dict) -> str: ...

    @abc.abstractmethod
    def construct_requests(self, doc: dict, ctx: str): ...

    @abc.abstractmethod
    def process_results(self, doc: dict, results) -> Dict[str, float]: ...

    @abc.abstractmethod
    def aggregation(self) -> Dict[str, Any]: ...

    @abc.abstractmethod
    def higher_is_better(self) -> Dict[str, bool]: ...

    def fewshot_description(self) -> str:
        return ""

    # --- decontamination --------------------------------------------------
    def should_decontaminate(self) -> bool:
        return False

    def doc_to_decontamination_query(self, doc: dict) -> str:
        raise NotImplementedError(
            "task marks should_decontaminate but has no decontamination query"
        )

    def fewshot_examples(self, k: int, rnd: random.Random):
        if self._training_docs is None:
            self._training_docs = list(self.training_docs())
        return rnd.sample(self._training_docs, k)

    def fewshot_context(
        self, doc: dict, num_fewshot: int, rnd: random.Random, description: str = ""
    ) -> str:
        """Build the k-shot prompt (`lm_eval/base.py:576-643`): sample shots
        from train (or val/test minus the doc), join with double newlines."""
        description = description + "\n\n" if description else ""
        if num_fewshot == 0:
            labeled_examples = ""
        else:
            if self.has_training_docs():
                fewshotex = self.fewshot_examples(k=num_fewshot, rnd=rnd)
            else:
                if self._fewshot_docs is None:
                    self._fewshot_docs = list(
                        self.validation_docs()
                        if self.has_validation_docs()
                        else self.test_docs()
                    )
                fewshotex = rnd.sample(self._fewshot_docs, num_fewshot + 1)
                fewshotex = [x for x in fewshotex if x != doc][:num_fewshot]
            labeled_examples = (
                "\n\n".join(
                    self.doc_to_text(d) + self.doc_to_target(d) for d in fewshotex
                )
                + "\n\n"
            )
        return description + labeled_examples + self.doc_to_text(doc)


class MultipleChoiceTask(Task):
    """Per-choice loglikelihood; acc + length-normalized acc_norm
    (`lm_eval/base.py:646-679`)."""

    def doc_to_target(self, doc):
        return " " + doc["choices"][doc["gold"]]

    def construct_requests(self, doc, ctx):
        return [rf.loglikelihood(ctx, " {}".format(choice))[0] for choice in doc["choices"]]

    def process_results(self, doc, results):
        gold = doc["gold"]
        acc = 1.0 if int(max(range(len(results)), key=lambda i: results[i])) == gold else 0.0
        completion_len = [float(len(c)) for c in doc["choices"]]
        acc_norm = (
            1.0
            if int(
                max(range(len(results)), key=lambda i: results[i] / completion_len[i])
            )
            == gold
            else 0.0
        )
        return {"acc": acc, "acc_norm": acc_norm}

    def aggregation(self):
        from . import metrics

        return {"acc": metrics.mean, "acc_norm": metrics.mean}

    def higher_is_better(self):
        return {"acc": True, "acc_norm": True}


class PerplexityTask(Task):
    """Rolling-loglikelihood over whole documents; word/byte perplexity +
    bits-per-byte (`lm_eval/base.py:682-761`)."""

    def has_training_docs(self):
        return False

    def fewshot_context(self, doc, num_fewshot, rnd, description=""):
        if num_fewshot != 0:
            raise ValueError("perplexity tasks are zero-shot only")
        return ""

    def doc_to_text(self, doc):
        return ""

    def doc_to_target(self, doc):
        return doc

    def construct_requests(self, doc, ctx):
        if ctx:
            raise ValueError("perplexity tasks expect empty context")
        return rf.loglikelihood_rolling(self.doc_to_target(doc))

    def process_results(self, doc, results):
        (loglikelihood,) = results
        words = self.count_words(doc)
        bytes_ = self.count_bytes(doc)
        return {
            "word_perplexity": (loglikelihood, words),
            "byte_perplexity": (loglikelihood, bytes_),
            "bits_per_byte": (loglikelihood, bytes_),
        }

    def aggregation(self):
        from . import metrics

        return {
            "word_perplexity": metrics.weighted_perplexity,
            "byte_perplexity": metrics.weighted_perplexity,
            "bits_per_byte": metrics.bits_per_byte,
        }

    def higher_is_better(self):
        return {"word_perplexity": False, "byte_perplexity": False, "bits_per_byte": False}

    @classmethod
    def count_bytes(cls, doc: str) -> int:
        return len(doc.encode("utf-8"))

    @classmethod
    def count_words(cls, doc: str) -> int:
        return len(re.split(r"\s+", doc))
