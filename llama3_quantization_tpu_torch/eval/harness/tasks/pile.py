"""Pile perplexity subsets (the reference's `lm_eval/tasks/pile.py`):
each subset is a PerplexityTask over that component's documents (word
perplexity / byte perplexity / bits-per-byte).

A copy of `llama3_quantization_tpu/eval/harness/tasks/pile.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from ..base import PerplexityTask

#: v0.3 subset names (`pile.py:80-130`, minus the deprecated ones)
PILE_SUBSETS = [
    "arxiv",
    "books3",
    "bookcorpus2",
    "dm-mathematics",
    "enron",
    "europarl",
    "freelaw",
    "github",
    "gutenberg",
    "hackernews",
    "nih-exporter",
    "opensubtitles",
    "openwebtext2",
    "philpapers",
    "pile-cc",
    "pubmed-abstracts",
    "pubmed-central",
    "stackexchange",
    "ubuntu-irc",
    "uspto",
    "wikipedia",
    "youtubesubtitles",
]


class PileTask(PerplexityTask):
    VERSION = 1
    DATASET_PATH = "pile"
    DATASET_NAME = None

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return True

    def validation_docs(self):
        for doc in self.dataset["validation"]:
            yield doc["text"] if isinstance(doc, dict) else doc

    def test_docs(self):
        for doc in self.dataset["test"]:
            yield doc["text"] if isinstance(doc, dict) else doc


def create_pile_task(subset: str):
    class _Pile(PileTask):
        DATASET_NAME = subset

    _Pile.__name__ = f"Pile_{subset}"
    return _Pile
