"""Port parity: the rest of the task harness.

- Every module copied from the JAX package (the 33 task modules and the
  registry, `text_utils`, `local_datasets`, `evaluator`, `mmlu_categories`,
  `eval/data`, the decontamination archiver, `decontaminate` and package
  init) is JAX's source once the module docstring, the package name and
  blank lines are taken out.
- The registry has JAX's 285 names, in JAX's order, each mapped to a class
  of the same name, module and dataset.
- The documents JAX's own harness tests build (`tests/test_harness.py`,
  `tests/test_tasks_extended.py`) give the same results through both
  packages' `simple_evaluate` with `DummyLM`, task by task (zero- and
  one-shot), and JAX's DummyLM tests run unchanged over both packages.
- `TorchLM` against `JAXLM` (TINY_LLAMA, fp32, the "xla" backend on both
  sides, fp and RTN W4 g32) on hellaswag, winogrande, an MMLU subject,
  lambada_openai, wikitext and gsm8k (`synthetic_task_data`): every
  log-likelihood within 1e-4 with identical greedy flags, rolling
  log-likelihoods within 1e-4, `greedy_until` strings identical under JAX's
  `set_decode_kernel(False)`, and the task metrics equal.
"""

import ast
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_harness as JH
import test_tasks_extended as JX
from llama3_quantization_tpu.eval.harness import DummyLM as JDummy
from llama3_quantization_tpu.eval.harness import JAXLM
from llama3_quantization_tpu.eval.harness import evaluator as jev
from llama3_quantization_tpu.eval.harness import tasks as jtasks
from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.models.params import quantize_model_rtn as j_rtn
from llama3_quantization_tpu.ops import matmul as jmm
from llama3_quantization_tpu.quant import QuantSpec as JSpec
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.eval.data import SyntheticTokenizer
from llama3_quantization_tpu_torch.eval.harness import DummyLM as TDummy
from llama3_quantization_tpu_torch.eval.harness import TorchLM
from llama3_quantization_tpu_torch.eval.harness import evaluator as tev
from llama3_quantization_tpu_torch.eval.harness import tasks as ttasks
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.ops import matmul as tmm
from llama3_quantization_tpu_torch.tools.reproduce_study import (
    SYNTHETIC_TASKS,
    Recorder,
    Tok,
    synthetic_task_data,
)
from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAXP, PORT = ROOT / "llama3_quantization_tpu", ROOT / "llama3_quantization_tpu_torch"

TASK_MODULES = sorted(p.stem for p in (JAXP / "eval" / "harness" / "tasks").glob("*.py"))
COPIES = ([f"eval/harness/tasks/{m}.py" for m in TASK_MODULES]
          + ["eval/harness/text_utils.py", "eval/harness/local_datasets.py",
             "eval/harness/evaluator.py", "eval/mmlu_categories.py", "eval/data.py",
             "decontamination/__init__.py", "decontamination/archiver.py",
             "decontamination/decontaminate.py"])


def _body(path):
    """The source without its module docstring and blank lines, the
    port's package name read as JAX's."""
    src = path.read_text().replace("llama3_quantization_tpu_torch", "llama3_quantization_tpu")
    first = ast.parse(src).body[0]
    lines = src.splitlines()
    if isinstance(first, ast.Expr) and isinstance(getattr(first, "value", None), ast.Constant):
        lines = lines[first.end_lineno:]
    return [line for line in lines if line.strip()]


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_jax(rel):
    assert _body(PORT / rel) == _body(JAXP / rel)


def test_copies_cover_the_task_modules():
    assert len(TASK_MODULES) == 34  # 31 new, piqa and arc, the registry
    assert sorted(p.stem for p in (PORT / "eval" / "harness" / "tasks").glob("*.py")) == \
        TASK_MODULES


def test_registry_is_jaxs():
    assert list(ttasks.TASK_REGISTRY) == list(jtasks.TASK_REGISTRY)
    assert len(ttasks.TASK_REGISTRY) == 285
    for name, cls in ttasks.TASK_REGISTRY.items():
        j = jtasks.TASK_REGISTRY[name]
        assert cls.__name__ == j.__name__, name
        assert cls.__module__.replace("_torch", "") == j.__module__, name
        assert (cls.VERSION, cls.DATASET_PATH, cls.DATASET_NAME) == (
            j.VERSION, j.DATASET_PATH, j.DATASET_NAME), name


# ------------------------------------------------------- DummyLM parity ----
def same(a, b):
    """Equal, NaN equal to NaN, through dicts, lists and tuples."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b


def evaluate_both(lm, tasks, **kw):
    """JAX's `simple_evaluate` on a JAX DummyLM and the port's on the port's
    DummyLM of the same seed: equal results (or the same exception)."""
    outs = []
    for ev, dummy in ((jev, lm), (tev, TDummy(seed=lm.seed))):
        try:
            outs.append(ev.simple_evaluate(dummy, tasks, **kw))
        except Exception as e:  # noqa: BLE001 - both must fail alike
            outs.append(e)
    ref, got = outs
    if isinstance(ref, Exception):
        assert type(got) is type(ref) and str(got) == str(ref)
        raise ref
    assert not isinstance(got, Exception), got
    assert same(got["results"], ref["results"]) and got["versions"] == ref["versions"]
    assert got["config"] == ref["config"]
    return ref


DOCS = {**JH.TASK_DATA, **JH.GLUE_SG_DATA, **JX.EXTENDED_TASK_DATA}


@pytest.mark.parametrize("num_fewshot", [0, 1])
@pytest.mark.parametrize("task", sorted(DOCS))
def test_dummy_evaluate_matches_jax(task, num_fewshot):
    try:
        evaluate_both(JDummy(seed=3), [task], task_data={task: DOCS[task]},
                      num_fewshot=num_fewshot, bootstrap_iters=20)
    except AssertionError:
        raise
    except Exception:  # noqa: BLE001 - raised alike by both packages
        assert num_fewshot == 1


JAX_DUMMY_TESTS = [
    (JH, "test_dummy_eval_all_tasks"), (JH, "test_pattern_expansion"),
    (JH, "test_extra_mc_tasks"), (JH, "test_glue_superglue_dummy_eval"),
    (JH, "test_blimp_pile_translation_crows_dummy_eval"),
    (JX, "test_dummy_eval_extended_tasks"), (JX, "test_fewshot_extended_tasks"),
    (JX, "test_crows_subset_filters"),
]


@pytest.mark.parametrize("mod,name", JAX_DUMMY_TESTS, ids=[n for _, n in JAX_DUMMY_TESTS])
def test_jax_dummy_tests_run_on_both(mod, name):
    """JAX's own DummyLM test, with every `simple_evaluate` it makes run by
    both packages (results equal) and the port's registry in place of JAX's."""
    fn = getattr(mod, name)
    env = dict(fn.__globals__, simple_evaluate=evaluate_both, TASK_REGISTRY=ttasks.TASK_REGISTRY)
    types.FunctionType(fn.__code__, env, name)()


# ------------------------------------------------------ TorchLM vs JAXLM ----
CFG, TCFG = TINY_LLAMA, tcfg.TINY_LLAMA


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
        for lm in out[name]:
            lm.max_gen_toks = 8
    return out


TINY_DATA = synthetic_task_data(seed=1, n_docs=3, page_bytes=400, n_gsm8k=2)


@pytest.mark.parametrize("weights", ["fp", "rtn"])
@pytest.mark.parametrize("task", SYNTHETIC_TASKS)
def test_torchlm_tasks_match_jaxlm(lms, task, weights):
    jl, tl = lms[weights]
    runs = []
    JT.set_decode_kernel(False)
    try:
        with jmm.backend("xla"), tmm.backend("xla"):
            for ev, lm in ((jev, jl), (tev, tl)):
                rec = Recorder(lm)
                res = ev.simple_evaluate(rec, [task], task_data={task: TINY_DATA[task]},
                                         bootstrap_iters=10)
                runs.append((rec.calls, res["results"][task]))
    finally:
        JT.set_decode_kernel("auto")
    (ref_calls, ref), (got_calls, got) = runs
    assert [(k, r) for k, r, _ in got_calls] == [(k, r) for k, r, _ in ref_calls] != []
    for (kind, _, g), (_, _, r) in zip(got_calls, ref_calls):
        if kind == "loglikelihood":
            assert [f for _, f in g] == [f for _, f in r]
            np.testing.assert_allclose([v for v, _ in g], [v for v, _ in r], rtol=0, atol=1e-4)
        elif kind == "loglikelihood_rolling":
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
        else:
            assert g == r
    assert got.keys() == ref.keys()
    for metric, val in ref.items():
        assert got[metric] == pytest.approx(val, rel=1e-4, abs=1e-4), metric
