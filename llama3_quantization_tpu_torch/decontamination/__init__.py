"""Train/test overlap detection (decontamination).

Port of the reference's `lm_eval/decontamination/` with the C++ fast path
actually shipped (`csrc/janitor_util.cpp`) instead of referenced.

A copy of `llama3_quantization_tpu/decontamination/__init__.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .archiver import Archive, Reader, TextArchive, TextReader  # noqa: F401
from .janitor import Janitor, word_ngrams  # noqa: F401
