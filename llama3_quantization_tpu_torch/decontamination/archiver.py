"""Corpus archive IO for decontamination pipelines
(the reference's `lm_eval/decontamination/archiver.py`).

Jsonl documents with metadata, optionally zstd-compressed (the Pile's
`.jsonl.zst` layout), plus plain-text archives used for the 13-gram
janitor scans. Pure host-side IO — no reason to deviate from the
reference's format, so files written here are readable by the reference
tooling and vice versa.

A copy of `llama3_quantization_tpu/decontamination/archiver.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from __future__ import annotations

import datetime
import io
import json
import os
from typing import Iterator, Optional, Tuple

try:
    import zstandard as zstd
except ImportError:  # pragma: no cover - baked into this env, gate anyway
    zstd = None


def _zstd_required(path: str) -> bool:
    return path.endswith(".zst")


class Archive:
    """Append-only jsonl(.zst) document writer."""

    def __init__(self, file_path: str, compression_level: int = 3):
        self.file_path = file_path
        d = os.path.dirname(file_path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.fh = open(file_path, "wb")
        if _zstd_required(file_path):
            if zstd is None:
                raise RuntimeError("zstandard not available for .zst archives")
            self.cctx = zstd.ZstdCompressor(level=compression_level)
            self.compressor = self.cctx.stream_writer(self.fh)
        else:
            self.compressor = self.fh

    def add_data(self, data: str, meta: Optional[dict] = None) -> None:
        rec = {
            "text": data,
            "meta": meta or {},
            "created": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        }
        self.compressor.write((json.dumps(rec) + "\n").encode("utf-8"))

    def commit(self) -> None:
        if self.compressor is not self.fh:
            self.compressor.flush(zstd.FLUSH_FRAME)
        self.fh.flush()
        self.fh.close()


class Reader:
    """Streaming reader for jsonl(.zst) archives; yields document text
    (and metadata with `get_meta=True`)."""

    def read(self, file_path: str, get_meta: bool = False) -> Iterator:
        with open(file_path, "rb") as fh:
            if _zstd_required(file_path):
                if zstd is None:
                    raise RuntimeError("zstandard not available for .zst archives")
                dctx = zstd.ZstdDecompressor()
                stream = io.TextIOWrapper(dctx.stream_reader(fh), encoding="utf-8")
            else:
                stream = io.TextIOWrapper(fh, encoding="utf-8")
            for line in stream:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                text = rec["text"] if isinstance(rec, dict) else rec
                if get_meta:
                    yield text, rec.get("meta", {}) if isinstance(rec, dict) else {}
                else:
                    yield text


class TextArchive:
    """Newline-delimited raw-text archive (janitor ngram dumps)."""

    def __init__(self, file_path: str, mode: str = "ab"):
        self.file_path = file_path
        d = os.path.dirname(file_path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.fh = open(file_path, mode)

    def add_data(self, data: str) -> None:
        self.fh.write((data + "\n").encode("utf-8"))

    def commit(self) -> None:
        self.fh.flush()
        self.fh.close()


class TextReader:
    """Streams lines back out of a TextArchive."""

    def __init__(self, file_path: str):
        self.file_path = file_path

    def read(self) -> Iterator[str]:
        with open(self.file_path, "rb") as fh:
            for line in io.TextIOWrapper(fh, encoding="utf-8"):
                yield line.rstrip("\n")

    def read_tqdm(self) -> Iterator[str]:  # reference API name; no tqdm dep
        return self.read()
