"""Port parity: IR (`eval/retrieval.py`), STS (`eval/sts.py`) and their
tools (`tools/benchmark_ir.py`, `tools/benchmark_sts.py`).

- BM25 on the fixture corpus (both analyzers, both presets, Lucene norms)
  gives JAX's scores bit for bit, and `evaluate_retrieval` JAX's metrics.
- `UPRReranker` scores and `STSEncoder` embeddings on TINY_LLAMA (vocab
  300, `ByteTokenizer`, fp32; fp and RTN W4 g32 under the "xla" backend)
  agree with JAX's within 1e-4, with a demonstration prompt and without;
  `evaluate_sts` and the reranked lists give JAX's.
- `benchmark_ir` and `benchmark_sts` give JAX's JSON on the same model.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import llama3_quantization_tpu.cli as jcli
from llama3_quantization_tpu.eval import retrieval as JR
from llama3_quantization_tpu.eval import sts as JS
from llama3_quantization_tpu.eval.data import ByteTokenizer as JByte
from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.models.params import quantize_model_rtn as j_rtn
from llama3_quantization_tpu.ops import matmul as jmm
from llama3_quantization_tpu.quant import QuantSpec as JSpec
from llama3_quantization_tpu.tools import benchmark_ir as jir
from llama3_quantization_tpu.tools import benchmark_sts as jsts
from llama3_quantization_tpu_torch import cli as tcli
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.eval import retrieval as TR
from llama3_quantization_tpu_torch.eval import sts as TS
from llama3_quantization_tpu_torch.eval.data import ByteTokenizer
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.ops import matmul as tmm
from llama3_quantization_tpu_torch.tools import benchmark_ir as tir
from llama3_quantization_tpu_torch.tools import benchmark_sts as tsts
from llama3_quantization_tpu_torch.tools.reproduce_study import CORPUS
from test_retrieval_sts import CORPUS as SMALL
from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

DOCS = [d for d in CORPUS.read_text().split("\n \n") if len(d) > 200][:150]
FIXTURE = {f"d{i}": d for i, d in enumerate(DOCS)}
FIXTURE.update({"u1": "Café naïve don't 3.5 x86 foo_bar 1,000 O’Neil"})


def _queries(n=12):
    rng = np.random.default_rng(0)
    out = ["café naive", "dont don't 3.5", "zzzunknownzzz", ""]
    for _ in range(n):
        words = DOCS[int(rng.integers(len(DOCS)))].split()
        i = int(rng.integers(max(1, len(words) - 8)))
        out.append(" ".join(words[i: i + 6]))
    return out


@pytest.mark.parametrize("kw", [{}, {"analyzer": "simple"}, {"preset": "anserini"},
                                {"lucene_norms": True}, {"k1": 2.0, "b": 0.3}],
                         ids=["es", "simple", "anserini", "lucene", "custom"])
def test_bm25_matches_jax(kw):
    got, ref = TR.BM25Index(FIXTURE, **kw), JR.BM25Index(FIXTURE, **kw)
    assert (got.k1, got.b, got.avgdl, got.idf) == (ref.k1, ref.b, ref.avgdl, ref.idf)
    np.testing.assert_array_equal(got.doc_len, ref.doc_len)
    for q in _queries():
        for k in (5, 100):
            assert got.search(q, top_k=k) == ref.search(q, top_k=k), q
    for text in FIXTURE.values():
        assert TR._tokenize(text) == JR._tokenize(text)
        assert TR._tokenize_standard(text) == JR._tokenize_standard(text)


def test_evaluate_retrieval_matches_jax():
    idx = TR.BM25Index(FIXTURE)
    qs = _queries()
    results = {f"q{i}": idx.search(q, top_k=20) for i, q in enumerate(qs)}
    rng = np.random.default_rng(1)
    qrels = {f"q{i}": {f"d{int(j)}": int(rng.integers(0, 3)) for j in rng.integers(0, 150, 5)}
             for i in range(len(qs))}
    for ks in ((1, 3, 5, 10, 100), (2, 7)):
        assert TR.evaluate_retrieval(qrels, results, ks) == JR.evaluate_retrieval(
            qrels, results, ks)


# ------------------------------------------------------- the model paths ----
@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(TINY_LLAMA, vocab_size=300)
    tc = dataclasses.replace(tcfg.TINY_LLAMA, vocab_size=300)
    params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rtn = j_rtn(params, cfg, JSpec(n_bits=4, group_size=32), pack=True)
    return {name: (p, convert.params_from_numpy(to_numpy_tree(p), device="cpu"), cfg, tc)
            for name, p in (("fp", params), ("rtn", rtn))}


@pytest.mark.parametrize("weights", ["fp", "rtn"])
def test_upr_matches_jax(models, weights):
    jp, tp, cfg, tc = models[weights]
    pairs = [("cat animal", SMALL["d1"]), ("qubit machine", SMALL["d2"]),
             ("cat", SMALL["d3"] * 12), ("", SMALL["d4"]), ("market fell", DOCS[0][:300])]
    with jmm.backend("xla"), tmm.backend("xla"):
        ref_rr = JR.UPRReranker(jp, cfg, JByte(), max_length=256)
        got_rr = TR.UPRReranker(tp, tc, ByteTokenizer(), max_length=256)
        for bs in (1, 2, 8):
            np.testing.assert_allclose(got_rr.score_pairs(pairs, batch_size=bs),
                                       ref_rr.score_pairs(pairs, batch_size=bs),
                                       rtol=0, atol=1e-4)
        idx = TR.BM25Index(SMALL)
        queries = {"q1": "cat animal", "q2": "stock market"}
        first = {q: idx.search(t, top_k=4) for q, t in queries.items()}
        got = got_rr.rerank(SMALL, queries, first, top_k=3, batch_size=2)
        ref = ref_rr.rerank(SMALL, queries, first, top_k=3, batch_size=2)
    assert {q: list(v) for q, v in got.items()} == {q: list(v) for q, v in ref.items()}
    for q in ref:
        np.testing.assert_allclose(list(got[q].values()), list(ref[q].values()), atol=1e-4)


@pytest.mark.parametrize("demo", [(), (("a cat", "a feline", 4.5), ("stock", "market", 3.0))],
                         ids=["zero-shot", "demonstrations"])
@pytest.mark.parametrize("weights", ["fp", "rtn"])
def test_sts_matches_jax(models, weights, demo):
    jp, tp, cfg, tc = models[weights]
    sents = ["the cat", "a cat", "stock market", "hello", "hello", DOCS[3][:150]]
    with jmm.backend("xla"), tmm.backend("xla"):
        ref_enc = JS.STSEncoder(jp, cfg, JByte(), demonstration_set=demo, max_length=256)
        got_enc = TS.STSEncoder(tp, tc, ByteTokenizer(), demonstration_set=demo, max_length=256)
        assert got_enc.demo_prompt == ref_enc.demo_prompt
        ref = ref_enc.encode(sents, batch_size=4)
        got = got_enc.encode(sents, batch_size=4)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        pairs, gold = list(zip(sents[::2], sents[1::2])), [4.0, 1.0, 2.5]
        assert TS.evaluate_sts(got_enc, pairs, gold, 2) == pytest.approx(
            JS.evaluate_sts(ref_enc, pairs, gold, 2), abs=1e-6)
    assert TS.spearman([1, 2, 2, 3], [4, 1, 1, 0]) == JS.spearman([1, 2, 2, 3], [4, 1, 1, 0])
    np.testing.assert_array_equal(TS.cosine_sim(ref, ref[::-1]), JS.cosine_sim(ref, ref[::-1]))


# -------------------------------------------------------------- the tools ----
@pytest.fixture
def same_model(models, monkeypatch):
    """Both tools' `load_model` return the same TINY_LLAMA (vocab 300);
    the port on JAX's default backend, xla."""
    jp, tp, cfg, tc = models["fp"]
    monkeypatch.setattr(jcli, "load_model", lambda args: (jp, cfg))
    monkeypatch.setattr(tcli, "load_model", lambda args: (tp, tc))
    with jmm.backend("xla"), tmm.backend("xla"):
        yield


def _same_json(port_main, jax_main, argv, capsys):
    got = port_main(argv + ["--device", "cpu"])
    got_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = jax_main(argv)
    ref_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got_line == got and ref_line == ref
    assert got.keys() == ref.keys()
    for key, val in ref.items():
        assert got[key] == pytest.approx(val, abs=1e-6), key
    return got


@pytest.mark.parametrize("argv", [["--synthetic", "16", "--top_k", "3", "--batch_size", "4"],
                                  ["--wbits", "4", "--group_size", "32", "--synthetic", "12"]],
                         ids=["fp", "rtn"])
def test_benchmark_ir_gives_jaxs_json(same_model, argv, capsys):
    res = _same_json(tir.main, jir.main, argv, capsys)
    assert set(res) == {"bm25", "upr"}


@pytest.mark.parametrize("quant", [[], ["--wbits", "4", "--group_size", "32"]],
                         ids=["fp", "rtn"])
def test_benchmark_sts_gives_jaxs_json(same_model, tmp_path, capsys, quant):
    """On a TSV of pairs. (`--synthetic` pairs repeat identical sentence
    pairs, whose cosines tie at 1 to the last bit, so their Spearman rank
    order is set by the last bit of two sums.)"""
    tsv = tmp_path / "sts.tsv"
    tsv.write_text("5.0\tsame words here\tsame words here\n0.0\talpha beta\tgamma delta\n"
                   "2.5\tthe cat sat\tthe dog sat\n1.0\tstock market\tmarket stall\n"
                   "4.0\ta red car\tthe red car\n")
    out = tmp_path / "out.json"
    res = _same_json(tsts.main, jsts.main, ["--data_tsv", str(tsv), "--output_json", str(out)]
                     + quant, capsys)
    assert json.loads(out.read_text()) == pytest.approx(res) and res["n_pairs"] == 5
