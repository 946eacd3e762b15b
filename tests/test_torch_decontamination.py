"""Port parity: decontamination (`decontamination/`), the archiver across
the packages, `get_pile(data_file=)` and `simple_evaluate`'s
`decontamination_ngrams_path`.

- The port's janitor builds its C++ helper (`csrc/janitor_util.cpp`) into
  `_build/`, not beside the source; its native path gives the JAX janitor's
  native outputs (normalized text, n-grams, contamination counts, cleaned
  slices), its pure-Python path JAX's Python outputs, and the two agree
  with each other wherever JAX's two do.
- Archives written by either package read back alike in the other
  (jsonl, jsonl.zst, text archives), metadata included.
- `get_pile(data_file=...)` reads a jsonl(.zst) file into JAX's windows.
- With an n-gram pickle (or a directory of them), `simple_evaluate` gives
  JAX's results, the `*_decontaminate` metrics included, and drops exactly
  the contaminated documents; JAX's own hook test runs on both packages.
"""

import pickle
import types

import numpy as np
import pytest
import torch

import test_harness as JH
from llama3_quantization_tpu.decontamination import archiver as jarch
from llama3_quantization_tpu.decontamination import decontaminate as jdec
from llama3_quantization_tpu.decontamination import janitor as jjan
from llama3_quantization_tpu.eval import data as jdata
from llama3_quantization_tpu_torch.decontamination import archiver as tarch
from llama3_quantization_tpu_torch.decontamination import decontaminate as tdec
from llama3_quantization_tpu_torch.decontamination import janitor as tjan
from llama3_quantization_tpu_torch.eval import data as tdata
from llama3_quantization_tpu_torch.tools.reproduce_study import CORPUS
from test_torch_tasks import evaluate_both

torch.set_num_threads(1)

TEXTS = [
    "Hello, World!  This is   a TEST... with 123 numbers & symbols.",
    "",
    "   ",
    "one",
    "The quick brown fox -- jumps over the lazy dog; twice: (again) [and again]!",
] + [CORPUS.read_text()[i: i + 700] for i in (0, 5000, 90000)]


def python_path(mod):
    """A context in which `mod`'s janitor runs its pure-Python path."""
    class Ctx:
        def __enter__(self):
            self.saved = mod._NATIVE, mod._NATIVE_TRIED
            mod._NATIVE, mod._NATIVE_TRIED = None, True

        def __exit__(self, *exc):
            mod._NATIVE, mod._NATIVE_TRIED = self.saved

    return Ctx()


def test_native_helper_builds_into_the_build_dir():
    lib = tjan._native_lib()
    assert lib is not None and tjan.native_used()
    path = lib._name
    assert "/_build/janitor_util_" in path and path.endswith(".so")
    with python_path(tjan):
        assert not tjan.native_used()


def _janitor_outputs(mod, text):
    j = mod.Janitor(ngram_n=3, window_to_remove=5, minimum_slice_length=5)
    j.register_contaminant("the quick brown fox")
    j.register_contaminant(CORPUS.read_text()[5100:5200])
    return (mod.clean_text(text), mod.word_ngrams(text, 3), mod.word_ngrams(text, 13),
            j.contamination_count(text), j.clean(text), sorted(j.dirt_ngrams),
            mod.split_indices(text))


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_janitor_paths_match_each_other_and_jax(i):
    text = TEXTS[i]
    native = _janitor_outputs(tjan, text)
    with python_path(tjan):
        py = _janitor_outputs(tjan, text)
    ref = _janitor_outputs(jjan, text)
    with python_path(jjan):
        ref_py = _janitor_outputs(jjan, text)
    assert native == ref and py == ref_py
    # JAX's two paths count differently where a word cleans to nothing
    # ("@.@" in wikitext): the port's differ exactly where JAX's do
    assert (native == py) == (ref == ref_py)
    assert native == py or any(not w for w in ref[0].split(" ")) or "@" in text


def test_janitor_save_load_across_packages(tmp_path):
    j = tjan.Janitor(ngram_n=2)
    j.register_contaminant("alpha beta gamma")
    j.save_contamination_ngrams(str(tmp_path / "t.pkl"))
    r = jjan.Janitor(ngram_n=2)
    r.load_contamination_ngrams(str(tmp_path / "t.pkl"))
    assert r.dirt_ngrams == j.dirt_ngrams == {"alpha beta", "beta gamma"}
    doc = " ".join(["alpha beta"] * 12) + " end"
    assert r.clean(doc) == j.clean(doc) == []


# --------------------------------------------------------------- archiver ----
@pytest.mark.parametrize("suffix", [".jsonl", ".jsonl.zst"])
@pytest.mark.parametrize("writer,reader", [(jarch, tarch), (tarch, jarch)],
                         ids=["jax-writes", "port-writes"])
def test_archive_across_packages(tmp_path, suffix, writer, reader):
    if suffix.endswith(".zst"):
        pytest.importorskip("zstandard")
    path = str(tmp_path / f"docs{suffix}")
    a = writer.Archive(path)
    docs = [(f"doc {i} " + "text " * i, {"i": i, "pile_set_name": "ArXiv"}) for i in range(20)]
    for text, meta in docs:
        a.add_data(text, meta=meta)
    a.commit()
    assert list(reader.Reader().read(path)) == [t for t, _ in docs]
    assert list(reader.Reader().read(path, get_meta=True)) == docs
    assert list(reader.Reader().read(path)) == list(writer.Reader().read(path))


@pytest.mark.parametrize("writer,reader", [(jarch, tarch), (tarch, jarch)],
                         ids=["jax-writes", "port-writes"])
def test_text_archive_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "ngrams.txt")
    t = writer.TextArchive(path)
    for line in ("a b c", "d e f", ""):
        t.add_data(line)
    t.commit()
    assert list(reader.TextReader(path).read()) == ["a b c", "d e f", ""]
    assert list(reader.TextReader(path).read_tqdm()) == list(writer.TextReader(path).read())


@pytest.mark.parametrize("suffix", [".jsonl", ".jsonl.zst"])
def test_get_pile_reads_a_data_file(tmp_path, suffix):
    if suffix.endswith(".zst"):
        pytest.importorskip("zstandard")
    path = str(tmp_path / f"val{suffix}")
    a = tarch.Archive(path)
    for para in CORPUS.read_text().split("\n \n")[:40]:
        a.add_data(para)
    a.commit()
    for seed in (0, 3):
        got, none = tdata.get_pile(4, seed, 16, tdata.SyntheticTokenizer(), data_file=path)
        ref, _ = jdata.get_pile(4, seed, 16, jdata.SyntheticTokenizer(), data_file=path)
        assert none is None and len(got) == len(ref) == 4
        for (gi, gt), (ri, rt) in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(gi), np.asarray(ri))
            np.testing.assert_array_equal(np.asarray(gt), np.asarray(rt))


# -------------------------------------------------------- the evaluator ----
def _contaminated_piqa(tmp_path, n_bad):
    """piqa docs whose first `n_bad` goals are long and stored as training
    13-grams: (task_data, pickle path)."""
    docs = [dict(d, goal=" ".join(f"w{i}x{k}" for k in range(16))) if i < n_bad else d
            for i, d in enumerate(JH.PIQA_DOCS)]
    j = tjan.Janitor()
    for d in docs[:n_bad]:
        j.register_contaminant(d["goal"])
    path = tmp_path / "grams.pkl"
    j.save_contamination_ngrams(str(path))
    return {"piqa": {"train": docs, "validation": docs}}, path


@pytest.mark.parametrize("n_bad", [0, 2, 6])
def test_simple_evaluate_decontamination_matches_jax(tmp_path, n_bad):
    data, path = _contaminated_piqa(tmp_path, n_bad)
    res = evaluate_both(JH.DummyLM(seed=1), ["piqa"], task_data=data, bootstrap_iters=10,
                        decontamination_ngrams_path=str(path))
    row = res["results"]["piqa"]
    docs = [d["goal"] for d in data["piqa"]["validation"]]
    overlap = tdec.get_train_overlap({"piqa": docs}, str(path))
    assert overlap == jdec.get_train_overlap({"piqa": docs}, str(path))
    assert overlap["piqa"] == set(range(n_bad))
    # every document contaminated: nothing to aggregate, no such metric
    assert ({"acc_decontaminate", "acc_norm_decontaminate"} <= set(row)) == (n_bad < len(docs))


def test_ngrams_directory_matches_jax(tmp_path):
    data, path = _contaminated_piqa(tmp_path, 3)
    shards = tmp_path / "shards"
    shards.mkdir()
    grams = sorted(pickle.loads(path.read_bytes()))
    for i in range(3):
        (shards / f"part{i}.pkl").write_bytes(pickle.dumps(set(grams[i::3])))
    docs = {"piqa": [d["goal"] for d in data["piqa"]["validation"]]}
    assert tdec.get_train_overlap(docs, str(shards)) == jdec.get_train_overlap(
        docs, str(shards)) == {"piqa": {0, 1, 2}}
    evaluate_both(JH.DummyLM(seed=2), ["piqa"], task_data=data, bootstrap_iters=10,
                  decontamination_ngrams_path=str(shards))


def test_jax_decontamination_hook_runs_on_both(tmp_path):
    fn = JH.test_decontamination_hook
    env = dict(fn.__globals__, simple_evaluate=evaluate_both)
    types.FunctionType(fn.__code__, env, fn.__name__)(tmp_path)
