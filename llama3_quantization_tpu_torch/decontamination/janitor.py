"""13-gram contamination scrubber (port of
`llama3_quantization_tpu/decontamination/janitor.py`).

Mirrors the reference Janitor
(the reference's `lm_eval/decontamination/janitor.py`): normalize text
(lowercase, strip punctuation), register contaminant n-grams from
benchmark docs, detect them in training documents, and scrub matches by
deleting a window around each hit, splitting documents that lose too much.

The hot string ops run in the C++ helper `csrc/janitor_util.cpp` (a copy of
the JAX package's `native/janitor_util.cpp`), built with g++ at first use
into the git-ignored `_build/` under a name keyed on the source's hash and
loaded via ctypes; without g++ the pure-Python path runs, as in the JAX
package. It is host code, not a device kernel. `native_used()` says which
of the two runs. Everything below `_native_lib` is the JAX module's code,
held equal to it by `tests/test_torch_decontamination.py`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pickle
import re
import string
import subprocess
from typing import Iterator, List, Sequence, Tuple

_NATIVE = None
_NATIVE_TRIED = False


def _native_lib():
    """Build (once) and load the C++ janitor_util via ctypes."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    pkg = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    src = os.path.join(pkg, "csrc", "janitor_util.cpp")
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        build = os.path.join(pkg, "_build")
        so = os.path.join(build, f"janitor_util_{digest}.so")
        if not os.path.exists(so):
            os.makedirs(build, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        text, size = ctypes.c_char_p, ctypes.c_size_t
        lib.janitor_clean_text.argtypes = [text, size, text]
        lib.janitor_word_ngrams.argtypes = [text, size, ctypes.c_int, text, size]
        lib.janitor_count_contaminated.argtypes = [text, size, text, size]
        lib.janitor_clean_text.restype = ctypes.c_size_t
        lib.janitor_word_ngrams.restype = ctypes.c_size_t
        lib.janitor_count_contaminated.restype = ctypes.c_size_t
        _NATIVE = lib
    except Exception:
        _NATIVE = None
    return _NATIVE


def native_used() -> bool:
    """Whether the C++ helper runs (else the pure-Python path)."""
    return _native_lib() is not None


# ---------------------------------------------------------------------------
# text normalization (python fallback mirrors janitor.py:125+)
# ---------------------------------------------------------------------------

_TRANSLATE = str.maketrans(string.punctuation, " " * len(string.punctuation))


def clean_text(text: str) -> str:
    lib = _native_lib()
    if lib is not None:
        raw = text.encode("utf-8", errors="ignore")
        buf = ctypes.create_string_buffer(len(raw) + 1)
        n = lib.janitor_clean_text(raw, len(raw), buf)
        return buf.raw[:n].decode("utf-8", errors="ignore")
    return re.sub(r"\s+", " ", text.lower().translate(_TRANSLATE)).strip()


def word_ngrams(text: str, n: int) -> List[str]:
    lib = _native_lib()
    if lib is not None:
        raw = text.encode("utf-8", errors="ignore")
        cap = max(1024, (n + 1) * len(raw) + 16)
        buf = ctypes.create_string_buffer(cap)
        m = lib.janitor_word_ngrams(raw, len(raw), n, buf, cap)
        out = buf.raw[:m].decode("utf-8", errors="ignore")
        return out.split("\n") if out else []
    words = clean_text(text).split()
    return [" ".join(words[i : i + n]) for i in range(len(words) - n + 1)]


def split_indices(text: str) -> List[Tuple[str, Tuple[int, int]]]:
    """Word tokens with (start, end) character indices in the raw text."""
    return [(m.group(), (m.start(), m.end() - 1)) for m in re.finditer(r"\S+", text)]


class Janitor:
    """Contamination registration + scrubbing
    (`lm_eval/decontamination/janitor.py:58-250` semantics)."""

    def __init__(
        self,
        ngram_n: int = 13,
        window_to_remove: int = 200,
        too_dirty_cutoff: int = 10,
        minimum_slice_length: int = 200,
        delete_chars: bool = True,
    ):
        self.ngram_n = ngram_n
        self.window_to_remove = window_to_remove
        self.too_dirty_cutoff = too_dirty_cutoff
        self.minimum_slice_length = minimum_slice_length
        self.delete_chars = delete_chars
        self.dirt_ngrams: set = set()
        self.dirty_count = 0

    # -- registration ------------------------------------------------------
    def register_contaminant(self, dirt_string: str) -> None:
        self.dirt_ngrams.update(word_ngrams(dirt_string, self.ngram_n))

    def save_contamination_ngrams(self, filename: str) -> None:
        with open(filename, "wb") as f:
            pickle.dump(self.dirt_ngrams, f)

    def load_contamination_ngrams(self, filename: str) -> None:
        with open(filename, "rb") as f:
            self.dirt_ngrams = pickle.load(f)

    # -- detection / scrubbing --------------------------------------------
    def _contamination_spans(self, dirty_string: str) -> Iterator[Tuple[int, int]]:
        """(start, end) raw-text index spans of contaminated n-grams."""
        tokens = split_indices(dirty_string)
        words = [clean_text(w) for w, _ in tokens]
        for i in range(len(words) - self.ngram_n + 1):
            gram = " ".join(w for w in words[i : i + self.ngram_n] if w)
            if gram in self.dirt_ngrams:
                yield tokens[i][1][0], tokens[i + self.ngram_n - 1][1][1]

    def contamination_count(self, dirty_string: str) -> int:
        lib = _native_lib()
        if lib is not None and self.dirt_ngrams:
            raw = dirty_string.encode("utf-8", errors="ignore")
            grams = "\n".join(self.dirt_ngrams).encode("utf-8", errors="ignore")
            return int(lib.janitor_count_contaminated(raw, len(raw), grams, len(grams)))
        return sum(1 for _ in self._contamination_spans(dirty_string))

    def clean(self, dirty_string: str) -> List[str]:
        """Remove contaminated windows; return remaining slices (documents
        with >= too_dirty_cutoff hits are dropped entirely)."""
        spans = list(self._contamination_spans(dirty_string))
        self.dirty_count += len(spans)
        if len(spans) >= self.too_dirty_cutoff:
            return []
        if not spans:
            return [dirty_string]
        if not self.delete_chars:
            return [dirty_string]
        slices: List[str] = []
        cursor = 0
        for start, end in spans:
            cut_start = max(0, start - self.window_to_remove)
            cut_end = min(len(dirty_string), end + 1 + self.window_to_remove)
            if cut_start > cursor:
                piece = dirty_string[cursor:cut_start]
                if len(piece) >= self.minimum_slice_length:
                    slices.append(piece)
            cursor = max(cursor, cut_end)
        tail = dirty_string[cursor:]
        if len(tail) >= self.minimum_slice_length:
            slices.append(tail)
        return slices
