"""WMT translation tasks (the reference's `lm_eval/tasks/translation.py`):
generative greedy decoding with corpus BLEU / chrF / TER via sacrebleu,
the same zero-shot "X phrase: ... Y phrase:" prompt format.

A copy of `llama3_quantization_tpu/eval/harness/tasks/translation.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .. import metrics
from ..base import Task, rf

LANG_NAMES = {
    "en": "English",
    "fr": "French",
    "de": "German",
    "ro": "Romanian",
    "ru": "Russian",
    "zh": "Chinese",
    "cs": "Czech",
    "iu": "Inuktitut",
    "ja": "Japanese",
    "km": "Khmer",
    "pl": "Polish",
    "ps": "Pashto",
    "ta": "Tamil",
    "ar": "Arabic",
}


class TranslationTask(Task):
    VERSION = 0
    DATASET_PATH = None  # e.g. "wmt14"
    DATASET_NAME = None  # e.g. "fr-en"
    SRC = "fr"
    TGT = "en"

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def test_docs(self):
        return self.dataset["test"]

    def _pair(self, doc):
        tr = doc.get("translation", doc)
        return tr[self.SRC], tr[self.TGT]

    def doc_to_text(self, doc):
        src, _ = self._pair(doc)
        return (
            f"{LANG_NAMES[self.SRC]} phrase: {src}\n"
            f"{LANG_NAMES[self.TGT]} phrase:"
        )

    def doc_to_target(self, doc):
        return " " + self._pair(doc)[1]

    def construct_requests(self, doc, ctx):
        return rf.greedy_until(ctx, ["\n"])

    def process_results(self, doc, results):
        pred = results[0].strip() if isinstance(results, (list, tuple)) else results.strip()
        _, ref = self._pair(doc)
        return {"bleu": (ref, pred), "chrf": (ref, pred), "ter": (ref, pred)}

    def aggregation(self):
        return {"bleu": metrics.bleu, "chrf": metrics.chrf, "ter": metrics.ter}

    def higher_is_better(self):
        return {"bleu": True, "chrf": True, "ter": False}


def create_translation_task(dataset: str, src: str, tgt: str):
    # HF wmt configs are named "<xx>-en" regardless of direction; pairs
    # without English (wmt20 de-fr) keep their own ordering
    if "en" in (src, tgt):
        other = src if src != "en" else tgt
        config = f"{other}-en"
    else:
        config = f"{src}-{tgt}"

    class _Tr(TranslationTask):
        DATASET_PATH = dataset
        DATASET_NAME = config
        SRC = src
        TGT = tgt

    _Tr.__name__ = f"{dataset}_{src}_{tgt}"
    return _Tr


#: wmt20 language pairs (sacrebleu's wmt20 test set, the reference's
#: `selected_translation_benchmarks`, `tasks/__init__.py:70`)
_WMT20_PAIRS = [
    "cs-en", "de-en", "de-fr", "en-cs", "en-de", "en-iu", "en-ja", "en-km",
    "en-pl", "en-ps", "en-ru", "en-ta", "en-zh", "fr-de", "iu-en", "ja-en",
    "km-en", "pl-en", "ps-en", "ru-en", "ta-en", "zh-en",
]

#: the v0.3 registry's translation benchmarks (`tasks/__init__.py:61-71,
#: 185-188`): gpt3 set (wmt14/wmt16) + chef's selection (wmt20, iwslt17)
WMT_PAIRS = [
    ("wmt14", "en", "fr"),
    ("wmt14", "fr", "en"),
    ("wmt16", "en", "ro"),
    ("wmt16", "ro", "en"),
    ("wmt16", "de", "en"),
    ("wmt16", "en", "de"),
    *[("wmt20", *pair.split("-")) for pair in _WMT20_PAIRS],
    ("iwslt17", "en", "ar"),
    ("iwslt17", "ar", "en"),
]
