"""Port parity: the eval front end's data pipelines and perplexity, `api.quantize`
and the study's golden rows.

- `eval/data.py` is a copy: `bucket_pow2`, `ByteTokenizer`,
  `SyntheticTokenizer` and every `get_*` loader with caller-given text
  (`get_loaders` window sampling included, on which the golden numbers
  depend) give the JAX package's outputs exactly; `get_pile(data_file=)`
  raises until the decontamination archiver is ported.
- `windowed_nll_fn`, `compute_ppl` and `eval_ppl_suite` against JAX's on
  the same parameters (fp32, the "xla" backend on both sides, RTN W4 g32
  and fp), relative error <= 1e-5.
- `api.quantize`: "rtn" is `quantize_model_rtn` (packed or not); GPTQ,
  AWQ, SmoothQuant, OmniQuant and mixed dispatch and quantize every decoder
  linear; HQQ and IR-QLoRA raise `NotImplementedError`; JAX's argument
  checks hold.
- `tools/reproduce_study.run_study`: every row of `ROWS` (`fp`, `rtn`,
  `gptq`, `awq`, `smoothquant`, `omniquant`, `mixed`, `rtn_s4`, `rtn_a8`,
  each with the root study's kwargs) against
  `tests/fixtures/golden_study.json` directly,
  within |got - golden| <= 2e-3 * max(1, |golden|); its parameter npz
  equals JAX's `init_params(TINY_LLAMA, PRNGKey(0), float32)` bit for bit.
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.eval import data as jdata
from llama3_quantization_tpu.eval import ppl as jppl
from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.models.params import quantize_model_rtn as j_rtn
from llama3_quantization_tpu.ops import matmul as jmm
from llama3_quantization_tpu.quant import QuantSpec as JSpec
from llama3_quantization_tpu_torch import api, convert
from llama3_quantization_tpu_torch.eval import data as tdata
from llama3_quantization_tpu_torch.eval import ppl as tppl
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models.params import quantize_model_rtn as t_rtn
from llama3_quantization_tpu_torch.ops import matmul as tmm
from llama3_quantization_tpu_torch.quant.quantizer import QuantSpec
from llama3_quantization_tpu_torch.quant.qtensor import QuantizedTensor
from llama3_quantization_tpu_torch.tools import reproduce_study as study
from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

CFG, TCFG = TINY_LLAMA, tcfg.TINY_LLAMA
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CORPUS = open(os.path.join(FIXTURES, "wikitext2_slice.txt")).read()


# ------------------------------------------------------------------ data ----
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 64, 65, 1000, 2048, 2049])
def test_bucket_pow2(n):
    assert tdata.bucket_pow2(n) == jdata.bucket_pow2(n)
    assert tdata.bucket_pow2(n, floor=8) == jdata.bucket_pow2(n, floor=8)


@pytest.mark.parametrize("text", ["", "plain words here", "naïve — ünïcode ☃", CORPUS[:5000]])
def test_tokenizers(text):
    for jt, tt in ((jdata.ByteTokenizer(), tdata.ByteTokenizer()),
                   (jdata.SyntheticTokenizer(), tdata.SyntheticTokenizer()),
                   (jdata.SyntheticTokenizer(97), tdata.SyntheticTokenizer(97))):
        ids = tt.encode(text)
        np.testing.assert_array_equal(ids, jt.encode(text))
        assert ids.dtype == jt.encode(text).dtype
        assert tt.decode(ids[:50]) == jt.decode(ids[:50])
    assert (tdata.ByteTokenizer.vocab_size, tdata.ByteTokenizer.bos_id) == (257, 256)


def _assert_loaders_equal(a, b):
    (la, ta), (lb, tb) = a, b
    assert len(la) == len(lb)
    for (ia, ra), (ib, rb) in zip(la, lb):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ra, rb)
    if ta is None:
        assert tb is None
    else:
        np.testing.assert_array_equal(ta, tb)


HALF = len(CORPUS) // 2
DOCS = [d for d in CORPUS.split("\n\n") if d.strip()]


@pytest.mark.parametrize("name,kw", [
    ("wikitext2", dict(train_text=CORPUS[:HALF], test_text=CORPUS[HALF:])),
    ("ptb", dict(train_text=CORPUS[:HALF], test_text=CORPUS[HALF:])),
    ("ptb_new", dict(train_text=CORPUS[:HALF], test_text=CORPUS[HALF:])),
    ("c4", dict(train_docs=DOCS, val_docs=DOCS)),
    ("c4_new", dict(train_docs=DOCS, val_docs=DOCS)),
    ("pile", dict(train_docs=DOCS)),
    ("mix", dict(train_text=CORPUS[:HALF], test_text=CORPUS[HALF:], train_docs=DOCS,
                 val_docs=DOCS)),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_get_loaders_match_jax(name, kw, seed):
    args = dict(nsamples=6, seed=seed, seqlen=16)
    ref = jdata.get_loaders(name, tokenizer=jdata.SyntheticTokenizer(), **args, **kw)
    got = tdata.get_loaders(name, tokenizer=tdata.SyntheticTokenizer(), **args, **kw)
    _assert_loaders_equal(got, ref)


def test_get_loaders_cache_dir(tmp_path):
    kw = dict(nsamples=4, seed=1, seqlen=32, train_text=CORPUS[:HALF], test_text=CORPUS[HALF:])
    first = tdata.get_loaders("wikitext2", tokenizer=tdata.SyntheticTokenizer(),
                              cache_dir=str(tmp_path), **kw)
    assert len(list(tmp_path.iterdir())) == 1
    again = tdata.get_loaders("wikitext2", tokenizer=tdata.SyntheticTokenizer(),
                              cache_dir=str(tmp_path), **kw)
    ref = jdata.get_loaders("wikitext2", tokenizer=jdata.SyntheticTokenizer(), **kw)
    _assert_loaders_equal(first, ref)
    _assert_loaders_equal(again, ref)


def test_get_pile_data_file_waits_for_the_archiver():
    with pytest.raises(NotImplementedError, match="archiver"):
        tdata.get_pile(2, 0, 16, tdata.SyntheticTokenizer(), data_file="val.jsonl.zst")
    with pytest.raises(ValueError):
        tdata.get_loaders("unknown", tokenizer=tdata.SyntheticTokenizer())


# ------------------------------------------------------------------- PPL ----
@pytest.fixture(scope="module")
def tiny():
    params = init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    rtn = j_rtn(params, CFG, JSpec(n_bits=4, group_size=32), pack=True)
    return {name: (p, convert.params_from_numpy(to_numpy_tree(p), device="cpu"))
            for name, p in (("fp", params), ("rtn", rtn))}


@pytest.fixture(scope="module")
def testenc():
    _, enc = jdata.get_loaders("wikitext2", nsamples=1, seed=0, seqlen=64,
                               tokenizer=jdata.SyntheticTokenizer(),
                               train_text=CORPUS[:HALF], test_text=CORPUS[HALF:])
    return enc


@pytest.mark.parametrize("weights", ["fp", "rtn"])
@pytest.mark.parametrize("chunk,seqlen", [(512, 64), (16, 64), (20, 48)])
def test_windowed_nll_matches_jax(tiny, testenc, weights, chunk, seqlen):
    """One window's NLL, chunked lm_head + logsumexp (`chunk` positions at a
    time, a ragged last chunk at 20)."""
    jp, tp = tiny[weights]
    win = testenc[:, :seqlen].astype(np.int32)
    with jmm.backend("xla"), tmm.backend("xla"):
        ref = float(jppl.windowed_nll_fn(CFG, chunk=chunk)(jp, jnp.asarray(win)))
        got = float(tppl.windowed_nll_fn(TCFG, chunk=chunk)(tp, torch.from_numpy(win).long()))
    assert abs(got - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("weights", ["fp", "rtn"])
@pytest.mark.parametrize("limit", [None, 5])
def test_compute_ppl_matches_jax(tiny, testenc, weights, limit):
    jp, tp = tiny[weights]
    enc = testenc[:, : 64 * 12]
    seen = []
    with jmm.backend("xla"), tmm.backend("xla"):
        ref = jppl.compute_ppl(jp, CFG, enc, seqlen=64, limit=limit)
        got = tppl.compute_ppl(tp, TCFG, enc, seqlen=64, limit=limit,
                               progress=lambda i, n: seen.append((i, n)))
    assert abs(got - ref) <= 1e-5 * ref
    n = 12 if limit is None else limit
    assert seen == [(i + 1, n) for i in range(n)]


def test_eval_ppl_suite_matches_jax(tiny, testenc):
    jp, tp = tiny["rtn"]
    streams = {"a": testenc[:, :256], "b": testenc[:, 256:640]}
    with jmm.backend("xla"), tmm.backend("xla"):
        ref = jppl.eval_ppl_suite(jp, CFG, streams, seqlen=64)
        got = tppl.eval_ppl_suite(tp, TCFG, streams, seqlen=64)
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5 * ref[k]


# ------------------------------------------------------------------- api ----
@pytest.mark.parametrize("pack", [True, False])
def test_quantize_rtn_is_quantize_model_rtn(tiny, pack):
    _, tp = tiny["fp"]
    spec = QuantSpec(n_bits=4, group_size=32)
    got = api.quantize(tp, TCFG, "rtn", spec, pack=pack)
    ref = t_rtn(tp, TCFG, spec, pack=pack)
    for name in ("q", "down"):
        g, r = got["layers"][name]["w"], ref["layers"][name]["w"]
        assert g.packed == r.packed == pack
        assert torch.equal(g.data, r.data) and torch.equal(g.scale, r.scale)


@pytest.mark.parametrize("method", [m for m in api.METHODS if m != "rtn"])
def test_quantize_other_methods_wait_for_the_quantizers(tiny, method):
    """Every method dispatches as JAX's: every decoder linear quantized,
    packed where asked (mixed keeps unpacked containers); IR-QLoRA ignores
    the spec and, at its default block size, skips TINY_LLAMA's linears as
    the reference does (fp kept, `test_torch_nf4_irqlora.py`)."""
    _, tp = tiny["fp"]
    calib = np.zeros((2, 16), np.int32)
    if method == "irqlora":
        out = api.quantize(tp, TCFG, method, calib_tokens=calib, tau_n=2)
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            assert torch.equal(out["layers"][name]["w"], tp["layers"][name]["w"])
        return
    kw = {"epochs": 1} if method == "omniquant" else {}
    out = api.quantize(tp, TCFG, method, QuantSpec(n_bits=4, group_size=32), calib_tokens=calib,
                       **kw)
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        w = out["layers"][name]["w"]
        assert isinstance(w, QuantizedTensor) and w.packed == (method != "mixed")


def test_quantize_checks_like_jax(tiny):
    _, tp = tiny["fp"]
    from llama3_quantization_tpu import api as japi

    assert api.METHODS == japi.METHODS
    sig, jsig = inspect.signature(api.quantize), inspect.signature(japi.quantize)
    assert [(p.name, p.default) for p in sig.parameters.values()] == [
        (p.name, p.default) for p in jsig.parameters.values()]
    for method in ("gptq", "awq", "smoothquant", "omniquant", "mixed"):
        with pytest.raises(ValueError, match="calib_tokens"):
            api.quantize(tp, TCFG, method)
    with pytest.raises(ValueError, match="unknown method"):
        api.quantize(tp, TCFG, "bogus")


# ----------------------------------------------------------------- study ----
def test_study_params_are_jax_init_params():
    ref = to_numpy_tree(init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32))
    got = study.load_tiny_params("cpu")

    def walk(r, g, path=""):
        if isinstance(r, dict):
            assert set(r) == set(g), path
            for k in r:
                walk(r[k], g[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=path)
            assert g.dtype == torch.float32

    walk(ref, got)


def test_study_settings_are_the_root_studys():
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(FIXTURES), "..", "tools"))
    import reproduce_study as root

    assert (study.SEQLEN, study.NSAMPLES_CALIB, study.PPL_LIMIT) == (
        root.SEQLEN, root.NSAMPLES_CALIB, root.PPL_LIMIT)
    assert study.TASK_DATA == root.TASK_DATA
    assert set(study.ROWS) <= set(root.METHODS)
    assert all(study.KWARGS.get(m, {}) == root.METHODS[m] for m in study.ROWS if m != "fp")


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(FIXTURES, "golden_study.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("method", list(study.ROWS))
def test_golden_row(golden, method):
    table = study.run_study([method], device="cpu", verbose=False)
    assert set(table[method]) == set(golden[method])
    for k, v in table[method].items():
        g = golden[method][k]
        assert abs(v - g) <= 2e-3 * max(1.0, abs(g)), f"{method}.{k}: got {v}, golden {g}"
    assert study.golden_misses(table) == []
