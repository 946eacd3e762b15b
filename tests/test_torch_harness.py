"""Port parity: the task harness (`eval/harness`).

- The framework-free modules are copies: `metrics` (every aggregation,
  the SQuAD scores, the bootstrap stderr), `Reorderer`,
  `get_rolling_token_windows`, `make_disjoint_window`, `pattern_match`,
  `make_table`, the piqa / arc_easy / arc_challenge documents, prompts and
  requests, and `get_task_dict` give the JAX package's outputs.
- `TorchLM` against `JAXLM` on the same parameters and requests (fp32, the
  "xla" backend on both sides; fp and RTN W4 g32): log-likelihoods within
  1e-4 and identical greedy flags, for `loglikelihood` and
  `loglikelihood_rolling`; `greedy_until` strings identical to JAX's
  under `set_decode_kernel(False)` (JAX's own CPU route), with a stop
  string hit and not; `simple_evaluate` on the study's tasks gives JAX's
  results.
- `decontamination_ngrams_path` raises until decontamination is ported;
  unknown task names raise as in JAX.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.eval.harness import JAXLM
from llama3_quantization_tpu.eval.harness import base as jbase
from llama3_quantization_tpu.eval.harness import evaluator as jev
from llama3_quantization_tpu.eval.harness import lm as jlm
from llama3_quantization_tpu.eval.harness import metrics as jm
from llama3_quantization_tpu.eval.harness import tasks as jtasks
from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.models.params import quantize_model_rtn as j_rtn
from llama3_quantization_tpu.ops import matmul as jmm
from llama3_quantization_tpu.quant import QuantSpec as JSpec
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.eval.data import SyntheticTokenizer
from llama3_quantization_tpu_torch.eval.harness import TorchLM
from llama3_quantization_tpu_torch.eval.harness import base as tbase
from llama3_quantization_tpu_torch.eval.harness import evaluator as tev
from llama3_quantization_tpu_torch.eval.harness import lm as tlm
from llama3_quantization_tpu_torch.eval.harness import metrics as tm
from llama3_quantization_tpu_torch.eval.harness import tasks as ttasks
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.ops import matmul as tmm
from llama3_quantization_tpu_torch.tools.reproduce_study import TASK_DATA, Tok
from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

CFG, TCFG = TINY_LLAMA, tcfg.TINY_LLAMA


# --------------------------------------------------------------- metrics ----
def _items(kind, seed):
    rng = random.Random(seed)
    if kind == "floats":
        return [rng.uniform(-3, 0) for _ in range(17)]
    if kind == "pairs":
        return [(rng.uniform(-30, 0), rng.randint(1, 9)) for _ in range(13)]
    if kind == "binary":
        return [(rng.randint(0, 1), rng.randint(0, 1)) for _ in range(21)]
    if kind == "classes":
        return [(rng.randint(0, 2), rng.randint(0, 2)) for _ in range(21)]
    return [(rng.random() < 0.6, {"idx": {"paragraph": rng.randint(0, 2),
                                          "question": rng.randint(0, 3)}})
            for _ in range(19)]


@pytest.mark.parametrize("name,kind", [
    ("mean", "floats"), ("median", "floats"), ("perplexity", "floats"),
    ("weighted_mean", "pairs"), ("weighted_perplexity", "pairs"), ("bits_per_byte", "pairs"),
    ("matthews_corrcoef", "binary"), ("f1_score", "binary"), ("f1_macro", "classes"),
    ("acc_all", "spans"),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(name, kind, seed):
    items = _items(kind, seed)
    assert getattr(tm, name)(items) == getattr(jm, name)(items)
    tse = tm.stderr_for_metric(getattr(tm, name), bootstrap_iters=50)
    jse = jm.stderr_for_metric(getattr(jm, name), bootstrap_iters=50)
    assert (tse is None) == (jse is None)
    if tse is not None:
        assert tse(items) == jse(items)


@pytest.mark.parametrize("pred,gold", [("The Cat!", "cat"), ("a dog ran", "the dog walked"),
                                       ("", ""), ("x", "")])
def test_squad_scores_match_jax(pred, gold):
    for name in ("squad_normalize",):
        assert getattr(tm, name)(pred) == getattr(jm, name)(pred)
    for name in ("squad_em", "squad_f1"):
        assert getattr(tm, name)(pred, gold) == getattr(jm, name)(pred, gold)
    assert (tm.metric_max_over_ground_truths(tm.squad_f1, pred, [gold, "cat"])
            == jm.metric_max_over_ground_truths(jm.squad_f1, pred, [gold, "cat"]))


# ------------------------------------------------------- request engine ----
@pytest.mark.parametrize("n,max_len,ctx", [(0, 8, 1), (5, 8, 1), (8, 8, 1), (23, 8, 1),
                                           (40, 16, 4)])
def test_rolling_windows_match_jax(n, max_len, ctx):
    toks = list(range(100, 100 + n))
    ref = list(jlm.get_rolling_token_windows(toks, 7, max_len, ctx))
    got = list(tlm.get_rolling_token_windows(toks, 7, max_len, ctx))
    assert got == ref
    assert [tlm.make_disjoint_window(w) for w in got] == [jlm.make_disjoint_window(w) for w in ref]


def test_reorderer_matches_jax():
    arr = [("a", [1] * 3, [2] * 2), ("b", [1], [2] * 5), ("c", [1] * 4, [2]), ("d", [], [2])]
    fn = lambda x: -(len(x[1]) + len(x[2]))  # noqa: E731
    t, j = tlm.Reorderer(arr, fn), jlm.Reorderer(arr, fn)
    assert t.get_reordered() == j.get_reordered()
    out = [x[0] for x in t.get_reordered()]
    assert t.get_original(out) == j.get_original(out)


def test_pattern_match_and_registry():
    names = ["piqa", "arc_easy", "arc_challenge", "hellaswag"]
    for pats in (["arc_*"], ["piqa", "arc_e*"], ["*"], ["nothing*"]):
        assert tev.pattern_match(pats, names) == jev.pattern_match(pats, names)
    assert set(ttasks.TASK_REGISTRY) == {"piqa", "arc_easy", "arc_challenge"}
    for name, cls in ttasks.TASK_REGISTRY.items():
        jcls = jtasks.TASK_REGISTRY[name]
        assert (cls.VERSION, cls.DATASET_PATH, cls.DATASET_NAME) == (
            jcls.VERSION, jcls.DATASET_PATH, jcls.DATASET_NAME)


def _requests(tasks_mod, num_fewshot):
    """Every task's docs, prompts and requests as the evaluator builds them."""
    data = dict(TASK_DATA, arc_challenge=TASK_DATA["arc_easy"])
    out = []
    for name, task in tasks_mod.get_task_dict(sorted(data), task_data=data).items():
        docs = list(task.test_docs() if task.has_test_docs() else task.validation_docs())
        rnd = random.Random(42)
        rnd.shuffle(docs)
        for doc in docs:
            ctx = task.fewshot_context(doc, num_fewshot, rnd, description="Answer.")
            reqs = task.construct_requests(doc, ctx)
            out.append((name, doc, ctx, [(r.request_type, r.args, r.index) for r in reqs],
                        task.doc_to_target(doc), task.doc_to_decontamination_query(doc),
                        task.process_results(doc, [-1.0, -0.5, -2.0][: len(reqs)])))
    return out


@pytest.mark.parametrize("num_fewshot", [0, 2])
def test_task_requests_match_jax(num_fewshot):
    assert _requests(ttasks, num_fewshot) == _requests(jtasks, num_fewshot)


def test_make_table_matches_jax():
    res = {"results": {"piqa": {"acc": 0.5, "acc_stderr": 0.25, "acc_norm": 0.75},
                       "arc_easy": {"acc": 1.0}},
           "versions": {"piqa": 0, "arc_easy": 0}}
    for fmt in ("markdown", "latex"):
        assert tev.make_table(res, fmt) == jev.make_table(res, fmt)


def test_request_plumbing_matches_jax():
    for mod in (tbase, jbase):
        req = mod.rf.loglikelihood("ctx", " cont")
        assert [r.index for r in req] == [0, 1] and repr(req[1]).startswith("Req_loglikelihood")
        with pytest.raises(IndexError):
            mod.rf.greedy_until("ctx", ["\n"])[0]
        with pytest.raises(NotImplementedError):
            mod.Request("bogus", ())
    assert tbase.PerplexityTask.count_words("a b  c") == jbase.PerplexityTask.count_words("a b  c")


# ---------------------------------------------------------- TorchLM ----
@pytest.fixture(scope="module")
def lms():
    params = init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    rtn = j_rtn(params, CFG, JSpec(n_bits=4, group_size=32), pack=True)
    tok = Tok(SyntheticTokenizer())
    out = {}
    for name, p in (("fp", params), ("rtn", rtn)):
        tp = convert.params_from_numpy(to_numpy_tree(p), device="cpu")
        out[name] = (JAXLM(p, CFG, tok, batch_size=3, max_length=40),
                     TorchLM(tp, TCFG, tok, batch_size=3, max_length=40))
    return out


def _words(rng, n):
    return " ".join(f"word{int(i)}" for i in rng.integers(0, 50, n))


LL_REQUESTS = [("", "one two"), ("Question: how to open a jar\nAnswer:", " use the rubber grip")]


@pytest.mark.parametrize("weights", ["fp", "rtn"])
def test_loglikelihood_matches_jaxlm(lms, weights):
    """Batches of 3 over 7 requests (ragged buckets; one context of 60 words
    left-truncated to max_length + 1 = 41 tokens)."""
    jl, tl = lms[weights]
    rng = np.random.default_rng(5)
    reqs = LL_REQUESTS + [(_words(rng, n), " " + _words(rng, c))
                          for n, c in ((3, 1), (9, 4), (20, 2), (60, 3), (12, 12))]
    with jmm.backend("xla"), tmm.backend("xla"):
        ref = jl.loglikelihood(reqs)
        got = tl.loglikelihood(reqs)
    assert [g for _, g in got] == [g for _, g in ref]
    np.testing.assert_allclose([v for v, _ in got], [v for v, _ in ref], rtol=0, atol=1e-4)


def test_loglikelihood_rolling_matches_jaxlm(lms):
    jl, tl = lms["rtn"]
    rng = np.random.default_rng(6)
    reqs = [_words(rng, 5), _words(rng, 100)]
    with jmm.backend("xla"), tmm.backend("xla"):
        ref = jl.loglikelihood_rolling(reqs)
        got = tl.loglikelihood_rolling(reqs)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("weights", ["fp", "rtn"])
def test_greedy_until_matches_jaxlm(lms, weights, monkeypatch):
    """8 tokens a request (no stop string hit), and a stop string cut from
    the first request's own output."""
    jl, tl = lms[weights]
    for lm in (jl, tl):
        monkeypatch.setattr(lm, "max_gen_toks", 8)
    rng = np.random.default_rng(7)
    reqs = [(_words(rng, 6), ["\n\n"]), (_words(rng, 35), "never")]
    JT.set_decode_kernel(False)
    try:
        with jmm.backend("xla"), tmm.backend("xla"):
            ref = jl.greedy_until(reqs)
            got = tl.greedy_until(reqs)
            assert got == ref and all(len(g.split()) == 8 for g in got)
            stop = ref[0].split()[3]
            cut = [(reqs[0][0], [stop])]
            assert tl.greedy_until(cut) == jl.greedy_until(cut) == [ref[0].split(stop)[0]]
    finally:
        JT.set_decode_kernel("auto")


def test_simple_evaluate_matches_jax(lms):
    jl, tl = lms["rtn"]
    kw = dict(num_fewshot=1, bootstrap_iters=10, task_data=TASK_DATA, limit=4)
    with jmm.backend("xla"), tmm.backend("xla"):
        ref = jev.simple_evaluate(jl, ["piqa", "arc_e*"], **kw)
        got = tev.simple_evaluate(tl, ["piqa", "arc_e*"], **kw)
    assert got["config"] == ref["config"] and got["versions"] == ref["versions"]
    assert got["results"].keys() == ref["results"].keys()
    for task, row in ref["results"].items():
        assert got["results"][task] == pytest.approx(row, abs=1e-9)


def test_harness_refusals(lms):
    _, tl = lms["fp"]
    with pytest.raises(NotImplementedError, match="decontamination"):
        tev.simple_evaluate(tl, ["piqa"], task_data=TASK_DATA, decontamination_ngrams_path="x")
    for mod, lm in ((tev, tl), (jev, lms["fp"][0])):
        with pytest.raises(KeyError):
            mod.simple_evaluate(lm, ["hellaswag_x"], task_data=TASK_DATA)
    assert tl.device == torch.device("cpu") and tl.eot_token_id == 0
    assert tl.tok_encode("a b") == lms["fp"][0].tok_encode("a b")
