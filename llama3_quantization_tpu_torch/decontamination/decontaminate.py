"""Train/test overlap detection against stored training n-grams.

Port of the reference's `lm_eval/decontamination/decontaminate.py:36-169`:
training-corpus 13-grams (produced offline with `Janitor.
save_contamination_ngrams`) are checked against every benchmark doc's
decontamination query; overlapping docs are excluded from the
`*_decontaminate` metric variants.

A copy of `llama3_quantization_tpu/decontamination/decontaminate.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Set

from .janitor import Janitor, word_ngrams


def get_train_overlap(
    docs_by_task: Dict[str, List[str]],
    ngrams_path: str,
    ngrams_n_size: int = 13,
) -> Dict[str, Set[int]]:
    """task -> set of contaminated doc indices.

    `ngrams_path` may be one pickle of a set of n-grams, or a directory of
    such pickles (the reference scans a directory of janitored shards).
    """
    files = (
        [os.path.join(ngrams_path, f) for f in sorted(os.listdir(ngrams_path))]
        if os.path.isdir(ngrams_path)
        else [ngrams_path]
    )
    train_ngrams: Set[str] = set()
    for f in files:
        with open(f, "rb") as fh:
            train_ngrams |= set(pickle.load(fh))

    overlaps: Dict[str, Set[int]] = {}
    for task, docs in docs_by_task.items():
        bad: Set[int] = set()
        for i, doc in enumerate(docs):
            grams = word_ngrams(doc, ngrams_n_size)
            if any(g in train_ngrams for g in grams):
                bad.add(i)
        overlaps[task] = bad
    return overlaps
