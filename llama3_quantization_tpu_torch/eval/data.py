"""Calibration / perplexity data pipelines (a copy of
`llama3_quantization_tpu/eval/data.py`; the port imports nothing of the
JAX package, and `tests/test_torch_eval.py` holds this copy's outputs
equal to the original's).

The reference's `datautils.py`, faithfully: the same sampling RNG (python
`random` with the same seeds and call order), the same "\n\n" joins and
window math, because PPL parity needs the *same* token windows.

Loaders take caller-given text (`train_text`, `test_text`, `train_docs`,
`val_docs`); without it they read a local HF `datasets` cache and raise
when there is none. `get_pile(data_file=...)` needs the decontamination
archiver's reader, which the port does not have yet: it raises
`NotImplementedError`; `train_docs=` works.
"""

from __future__ import annotations

import random
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np


def bucket_pow2(n: int, floor: int = 32) -> int:
    """Next power-of-two >= n (>= floor) — shared jit shape bucketing."""
    b = floor
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# Tokenizer adapters — the loaders only need `encode(text) -> np.ndarray[int]`
# ---------------------------------------------------------------------------


class HFTokenizer:
    """transformers AutoTokenizer adapter (the reference always uses
    `AutoTokenizer.from_pretrained(model, use_fast=False)`,
    `datautils.py:40`)."""

    def __init__(self, name_or_path: str, use_fast: bool = False):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(name_or_path, use_fast=use_fast)

    def encode(self, text: str, add_special_tokens: bool = True) -> np.ndarray:
        """Default keeps specials (the reference's PPL/calibration streams
        tokenize with them, `datautils.py:40-49`); the harness passes
        `add_special_tokens=False` so continuations never grow a BOS
        (`models/LMClass.py:81-88`)."""
        ids = self.tok(text, add_special_tokens=add_special_tokens)["input_ids"]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(list(ids))

    @property
    def vocab_size(self) -> int:
        return len(self.tok)

    @property
    def eot_token_id(self) -> int:
        eos = self.tok.eos_token_id
        if eos is None:
            eos = self.tok.bos_token_id
        return int(eos) if eos is not None else 0


class ByteTokenizer:
    """UTF-8 byte fallback tokenizer (offline tests; vocab 256 + BOS)."""

    vocab_size = 257
    bos_id = 256

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")


class SyntheticTokenizer:
    """Deterministic fake corpus tokenizer for tests: hashes words to ids.

    Uses crc32 (NOT Python `hash`, which is salted per process) so token
    ids — and therefore golden PPL/score fixtures — are stable across
    runs and machines."""

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> np.ndarray:
        ids = [zlib.crc32(w.encode()) % self.vocab_size for w in text.split()]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids):
        return " ".join(f"w{i}" for i in ids)


# ---------------------------------------------------------------------------
# Corpus access
# ---------------------------------------------------------------------------


def _load_hf_text(dataset: str, subset: Optional[str], split: str, field: str) -> List[str]:
    try:
        from datasets import load_dataset

        ds = load_dataset(dataset, subset, split=split, trust_remote_code=True)
        return list(ds[field])
    except Exception as e:  # offline / missing cache
        raise RuntimeError(
            f"corpus {dataset}/{subset}:{split} unavailable (offline container?): {e}"
        ) from e


def _sample_windows(
    trainenc: np.ndarray, nsamples: int, seed: int, seqlen: int
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The reference's calibration sampler (`datautils.py:44-52`): python
    `random.randint` (inclusive bounds!) over the concatenated token stream;
    targets are the input with all but the last position masked to -100."""
    random.seed(seed)
    loader = []
    for _ in range(nsamples):
        i = random.randint(0, trainenc.shape[0] - seqlen - 1)
        inp = trainenc[i : i + seqlen][None, :]
        tar = inp.copy()
        tar[:, :-1] = -100
        loader.append((inp, tar))
    return loader


def get_wikitext2(nsamples, seed, seqlen, tokenizer, train_text=None, test_text=None):
    """`datautils.get_wikitext2` (`datautils.py:35-53`). `*_text` overrides
    allow offline injection of the corpus."""
    if train_text is None:
        train_text = "\n\n".join(
            _load_hf_text("wikitext", "wikitext-2-raw-v1", "train", "text")
        )
    if test_text is None:
        test_text = "\n\n".join(
            _load_hf_text("wikitext", "wikitext-2-raw-v1", "test", "text")
        )
    trainenc = tokenizer.encode(train_text)
    testenc = tokenizer.encode(test_text)[None, :]
    return _sample_windows(trainenc, nsamples, seed, seqlen), testenc


def get_ptb(nsamples, seed, seqlen, tokenizer, train_text=None, test_text=None):
    """`datautils.get_ptb` (`datautils.py:56-77`) — note the reference uses
    the *validation* split as its PTB test stream."""
    if train_text is None:
        train_text = "\n\n".join(
            _load_hf_text("ptb_text_only", "penn_treebank", "train", "sentence")
        )
    if test_text is None:
        test_text = "\n\n".join(
            _load_hf_text("ptb_text_only", "penn_treebank", "validation", "sentence")
        )
    trainenc = tokenizer.encode(train_text)
    testenc = tokenizer.encode(test_text)[None, :]
    return _sample_windows(trainenc, nsamples, seed, seqlen), testenc


def get_pile(nsamples, seed, seqlen, tokenizer, train_docs=None, data_file=None):
    """`datautils.get_pile` (`datautils.py:14-32`): the first 1000 Pile val
    documents joined with "\\n\\n", random calibration windows, no test
    stream. The reference reads a hard-coded cluster-local `val.jsonl.zst`;
    here `data_file` points at any local jsonl(.zst) with a `text` field
    (the decontamination/archiver on-disk format), or `train_docs` injects
    document texts directly."""
    if train_docs is None:
        if data_file is None:
            raise RuntimeError(
                "pile loader needs data_file=<val.jsonl(.zst)> or train_docs "
                "(the reference's path is cluster-local, datautils.py:17)"
            )
        raise NotImplementedError(
            "get_pile(data_file=...) reads jsonl(.zst) through the decontamination "
            "archiver, which is not ported yet; pass train_docs=[...]"
        )
    trainenc = tokenizer.encode("\n\n".join(train_docs[:1000]))
    return _sample_windows(trainenc, nsamples, seed, seqlen), None


def get_ptb_new(nsamples, seed, seqlen, tokenizer, train_text=None, test_text=None):
    """`datautils.get_ptb_new` (`datautils.py:124-144`): space-joined
    sentences (vs the base loader's "\\n\\n") and the *test* split (vs
    validation) — the GPTQ-paper variant."""
    if train_text is None:
        train_text = " ".join(
            _load_hf_text("ptb_text_only", "penn_treebank", "train", "sentence")
        )
    if test_text is None:
        test_text = " ".join(
            _load_hf_text("ptb_text_only", "penn_treebank", "test", "sentence")
        )
    trainenc = tokenizer.encode(train_text)
    testenc = tokenizer.encode(test_text)[None, :]
    return _sample_windows(trainenc, nsamples, seed, seqlen), testenc


def get_c4_new(nsamples, seed, seqlen, tokenizer, train_docs=None, val_docs=None):
    """`datautils.get_c4_new` (`datautils.py:147-175`): same per-document
    train resampling as `get_c4`, but val = the first 1100 validation docs
    space-joined and truncated to 256*seqlen tokens (one contiguous stream
    instead of 256 hstacked windows)."""
    if train_docs is None:
        train_docs = _load_hf_text("allenai/c4", None, "train", "text")  # pragma: no cover
    if val_docs is None:
        val_docs = _load_hf_text("allenai/c4", None, "validation", "text")  # pragma: no cover

    random.seed(seed)
    trainloader = []
    for _ in range(nsamples):
        while True:
            i = random.randint(0, len(train_docs) - 1)
            trainenc = tokenizer.encode(train_docs[i])
            if trainenc.shape[0] > seqlen:
                break
        i = random.randint(0, trainenc.shape[0] - seqlen - 1)
        inp = trainenc[i : i + seqlen][None, :]
        tar = inp.copy()
        tar[:, :-1] = -100
        trainloader.append((inp, tar))

    valenc = tokenizer.encode(" ".join(val_docs[:1100]))[None, : 256 * seqlen]
    return trainloader, valenc


def get_c4(nsamples, seed, seqlen, tokenizer, train_docs=None, val_docs=None):
    """`datautils.get_c4` (`datautils.py:80-121`): per-document resampling
    until a document longer than seqlen is hit; val = 256 fixed-seed windows
    hstacked into one stream."""
    if train_docs is None:
        train_docs = _load_hf_text(
            "allenai/c4", None, "train", "text"
        )  # pragma: no cover - needs cache
    if val_docs is None:
        val_docs = _load_hf_text("allenai/c4", None, "validation", "text")  # pragma: no cover

    random.seed(seed)
    trainloader = []
    for _ in range(nsamples):
        while True:
            i = random.randint(0, len(train_docs) - 1)
            trainenc = tokenizer.encode(train_docs[i])
            if trainenc.shape[0] > seqlen:
                break
        i = random.randint(0, trainenc.shape[0] - seqlen - 1)
        inp = trainenc[i : i + seqlen][None, :]
        tar = inp.copy()
        tar[:, :-1] = -100
        trainloader.append((inp, tar))

    random.seed(0)
    val_windows = []
    for _ in range(256):
        while True:
            i = random.randint(0, len(val_docs) - 1)
            tmp = tokenizer.encode(val_docs[i])
            if tmp.shape[0] > seqlen:
                break
        i = random.randint(0, tmp.shape[0] - seqlen - 1)
        val_windows.append(tmp[i : i + seqlen][None, :])
    valenc = np.hstack(val_windows)
    return trainloader, valenc


def get_loaders(
    name: str,
    nsamples: int = 128,
    seed: int = 0,
    seqlen: int = 2048,
    tokenizer=None,
    cache_dir: Optional[str] = None,
    **overrides,
):
    """Dispatcher mirroring `datautils.get_loaders` (`datautils.py:178-199`).

    `overrides` lets callers inject offline corpora
    (train_text/test_text/train_docs/val_docs). `cache_dir` persists the
    tokenized loaders like the reference's `./cache` torch saves
    (`main.py:105-116,371-383`) so reruns skip tokenization.
    """
    if cache_dir:
        import hashlib
        import os

        # identify the corpus + tokenizer, not just shapes: injected
        # override text and the tokenizer identity must key the cache or
        # different corpora silently share entries
        h = hashlib.sha1()
        for k in sorted(overrides):
            h.update(k.encode())
            h.update(repr(overrides[k])[:100_000].encode())
        tok_id = (
            f"{type(tokenizer).__name__}_{getattr(tokenizer, 'vocab_size', 'x')}_"
            f"{getattr(getattr(tokenizer, 'tok', None), 'name_or_path', '')}"
        )
        h.update(tok_id.encode())
        key = f"{name}_{nsamples}_{seed}_{seqlen}_{h.hexdigest()[:12]}"
        path = os.path.join(cache_dir, f"loader_{key}.npz")
        if os.path.exists(path):
            z = np.load(path, allow_pickle=False)
            n_tr = int(z["n_train"])
            loader = [(z[f"inp_{i}"], z[f"tar_{i}"]) for i in range(n_tr)]
            testenc = z["testenc"] if "testenc" in z else None
            return loader, testenc
        loader, testenc = get_loaders(
            name, nsamples, seed, seqlen, tokenizer, cache_dir=None, **overrides
        )
        os.makedirs(cache_dir, exist_ok=True)
        payload = {"n_train": np.asarray(len(loader))}
        for i, (inp, tar) in enumerate(loader):
            payload[f"inp_{i}"] = inp
            payload[f"tar_{i}"] = tar
        if testenc is not None:
            payload["testenc"] = np.asarray(testenc)
        np.savez(path, **payload)
        return loader, testenc
    if "wikitext2" in name:
        return get_wikitext2(nsamples, seed, seqlen, tokenizer, **overrides)
    if "pile" in name:
        return get_pile(nsamples, seed, seqlen, tokenizer, **overrides)
    if "ptb" in name:
        if "new" in name:
            return get_ptb_new(nsamples, seed, seqlen, tokenizer, **overrides)
        return get_ptb(nsamples, seed, seqlen, tokenizer, **overrides)
    if "c4" in name:
        if "new" in name:
            return get_c4_new(nsamples, seed, seqlen, tokenizer, **overrides)
        return get_c4(nsamples, seed, seqlen, tokenizer, **overrides)
    if "mix" in name:
        # per-corpus injection: plain train_text/test_text go to wikitext2,
        # ptb gets its own via ptb_train_text/ptb_test_text (distinct
        # corpora — the thirds must not share text), c4 takes doc overrides
        text_kw = {k: v for k, v in overrides.items() if k in ("train_text", "test_text")}
        ptb_kw = {
            k[len("ptb_"):]: v
            for k, v in overrides.items()
            if k in ("ptb_train_text", "ptb_test_text")
        }
        doc_kw = {k: v for k, v in overrides.items() if k in ("train_docs", "val_docs")}
        w_tr, _ = get_wikitext2(nsamples // 3, seed, seqlen, tokenizer, **text_kw)
        p_tr, _ = get_ptb(nsamples // 3, seed, seqlen, tokenizer, **(ptb_kw or text_kw))
        c_tr, _ = get_c4(nsamples // 3, seed, seqlen, tokenizer, **doc_kw)
        return w_tr + p_tr + c_tr, None
    raise ValueError(f"unknown dataset {name}")
