"""Port parity: the command line (`cli.py`), the study sweep
(`tools/reproduce_study.py`) and the harness's `CachingLM`.

`build_parser` has every option of JAX's with the same default, type,
action and choices, plus `--device`; on an HF directory JAX writes from
TINY_LLAMA, `cli.main` of both packages prints the same results within
2e-3 relative (`--quant_method rtn`, then `hqq`, W4 g32, PPL over 4
windows of 64; the port on the CPU under JAX's default backend, xla);
`--save_dir` reloads in both packages; every flag the port has not yet
exits naming its ROADMAP item; tasks run offline through the port's
registry with `--use_cache`, any of JAX's names and patterns among them
(`hellaswag`, `piqa,hendrycksTest-*` with JAX's MMLU rollup), and
`--decontamination_ngrams_path` reaches `simple_evaluate`; JAX's task
names and `caching.py` are held equal; the sweep's configs and parsing are
JAX's, and it runs at its default tasks. No test reaches a tokenizer or a
dataset: both packages' `HFTokenizer` is stood in by one that finds no
files, as on a directory without them, and `datasets` cannot be imported.
"""

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import llama3_quantization_tpu.cli as jcli
import llama3_quantization_tpu.eval.data as jdata
from llama3_quantization_tpu.eval.harness import evaluator as jev
from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.models import hf_loader as JL
from llama3_quantization_tpu.tools import reproduce_study as jstudy
from llama3_quantization_tpu_torch import api, cli
from llama3_quantization_tpu_torch.eval import data as tdata
from llama3_quantization_tpu_torch.eval.harness import tasks as ttasks
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import hf_loader as TL
from llama3_quantization_tpu_torch.ops import matmul as mm
from llama3_quantization_tpu_torch.quant.quantizer import QuantSpec
from llama3_quantization_tpu_torch.tools import reproduce_study as tstudy
from llama3_quantization_tpu_torch.utils import pytree_io as TIO

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


class _NoTokenizer:
    def __init__(self, *a, **k):
        raise OSError("no tokenizer files in this directory")


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """No tokenizer lookup in either package, no dataset download; the
    port's backend restored."""
    monkeypatch.setattr(jdata, "HFTokenizer", _NoTokenizer)
    monkeypatch.setattr(tdata, "HFTokenizer", _NoTokenizer)
    monkeypatch.setitem(sys.modules, "datasets", None)
    yield
    mm.set_backend("pallas")


def _actions(parser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_mirrors_jax():
    port, ref = _actions(cli.build_parser()), _actions(jcli.build_parser())
    assert set(port) - set(ref) == {"device"} and set(ref) <= set(port)
    for dest, a in ref.items():
        b = port[dest]
        assert (b.option_strings, type(b), b.default, b.type, b.choices, b.nargs, b.const) == (
            a.option_strings, type(a), a.default, a.type, a.choices, a.nargs, a.const), dest
    assert port["device"].default == "cuda"
    assert cli.build_parser().prog == jcli.build_parser().prog


def test_task_names_and_caching_are_jaxs():
    from llama3_quantization_tpu.eval.harness.tasks import TASK_REGISTRY as JREG

    assert tuple(ttasks.TASK_REGISTRY) == tuple(JREG) and len(JREG) == 285
    for pats in (["hendrycksTest-*"], ["piqa", "arc_*"], ["blimp_*", "wmt*"]):
        assert cli.check_tasks(pats) == jev.pattern_match(pats, list(JREG))
    port = ROOT / "llama3_quantization_tpu_torch" / "eval" / "harness" / "caching.py"
    ref = ROOT / "llama3_quantization_tpu" / "eval" / "harness" / "caching.py"
    assert port.read_text() == ref.read_text()


def test_sweep_settings_are_jaxs():
    assert tstudy.STUDY_CONFIGS == jstudy.STUDY_CONFIGS
    assert tstudy.CSQA_TASKS == jstudy.CSQA_TASKS
    for c in tstudy.STUDY_CONFIGS + ["rtn:4:32_a8"]:
        assert tstudy.parse_config(c) == jstudy.parse_config(c)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """TINY_LLAMA (JAX's `init_params(PRNGKey(0), float32)`) as JAX writes it."""
    path = tmp_path_factory.mktemp("tiny_hf")
    JL.save_hf_checkpoint(init_params(TINY_LLAMA, jax.random.PRNGKey(0), dtype=jnp.float32),
                          TINY_LLAMA, str(path))
    return str(path)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


PPL_ARGS = ["--wbits", "4", "--group_size", "32", "--eval_ppl", "--ppl_datasets", "wikitext2",
            "--seqlen", "64", "--limit", "4"]


@pytest.mark.parametrize("method", ["rtn", "hqq"])
def test_cli_matches_jax(hf_dir, capsys, method):
    """Both CLIs on the JAX-written directory (bf16, as `--model` loads);
    the port under the xla backend, JAX's default (the port's is pallas)."""
    argv = ["--model", hf_dir, "--quant_method", method] + PPL_ARGS
    jres = jcli.main(argv)
    jline = _last_json(capsys)
    with mm.backend("xla"):
        tres = cli.main(argv + ["--device", "cpu"])
    tline = _last_json(capsys)
    assert jline == json.loads(json.dumps(jres)) and tline == tres
    assert set(tres) == set(jres) == {"wikitext2"}
    for k, v in jres.items():
        assert abs(tres[k] - v) <= 2e-3 * abs(v), (k, tres[k], v)


def test_cli_save_dir_reloads(hf_dir, tmp_path, capsys):
    out = tmp_path / "ckpt"
    cli.main(["--model", hf_dir, "--quant_method", "hqq", "--wbits", "4", "--group_size", "32",
              "--hqq_iters", "3", "--save_dir", str(out), "--output_json",
              str(tmp_path / "r.json"), "--device", "cpu"])
    assert _last_json(capsys) == {} and json.loads((tmp_path / "r.json").read_text()) == {}
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["config"]["hidden_size"] == TINY_LLAMA.hidden_size
    params, cfg = TL.from_hf_checkpoint(hf_dir, device="cpu")
    like = api.quantize(params, cfg, "hqq", QuantSpec(n_bits=4, group_size=32), iters=3)
    got = TL.load_checkpoint(str(out), like)
    for a, b in zip(TIO.tree_leaves(got), TIO.tree_leaves(like)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jp, _ = JL.from_hf_checkpoint(hf_dir)
    from llama3_quantization_tpu.api import quantize as jquantize
    from llama3_quantization_tpu.quant import QuantSpec as JSpec

    jlike = jquantize(jp, TINY_LLAMA, "hqq", JSpec(n_bits=4, group_size=32), iters=3)
    jgot = JL.load_checkpoint(str(out), jlike)
    assert len(jax.tree_util.tree_leaves(jgot)) == len(TIO.tree_leaves(got))


UNPORTED = [
    (["--tp", "2"], "A 5"), (["--dp", "2"], "A 5"), (["--sp", "2"], "A 5"),
    (["--moe_capacity", "1.25"], "A 4"),
    (["--net", "tiny-opt"], "A 4"), (["--net", "tiny-mixtral"], "A 4"),
    (["--tasks", "no_such_task"], "unknown tasks"),
]


@pytest.mark.parametrize("extra,item", UNPORTED)
def test_unported_flags_exit_naming_their_item(extra, item):
    argv = (["--net", "tiny-llama"] if "--net" not in extra else []) + [
        "--quant_method", "none", "--device", "cpu"] + extra
    with pytest.raises(SystemExit, match=item):
        cli.main(argv)


def test_unported_tasks_exit_before_loading(monkeypatch):
    """A task name that matches nothing in the registry stops the command
    before the model is built, quantized or evaluated (every other name of
    JAX's registry runs: `test_cli_runs_any_registry_task`)."""
    def fail(*a, **k):
        raise AssertionError("the model was loaded")

    monkeypatch.setattr(cli, "load_model", fail)
    with pytest.raises(SystemExit, match="unknown tasks"):
        cli.main(["--net", "llama3-8b", "--quant_method", "hqq", "--eval_ppl", "--tasks",
                  "hellaswag,no_such_task*x,no_such_task", "--device", "cpu"])


def test_t5_directory_waits_for_a4(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "t5"}))
    with pytest.raises(SystemExit, match="A 4"):
        cli.main(["--model", str(tmp_path), "--device", "cpu"])


def test_cli_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--net", "tiny-llama", "--quant_method", "none"])


@pytest.fixture
def offline_tasks(monkeypatch):
    """The port's registry on the study's documents; `boolq`-like names
    stay unknown to it."""
    reg = dict(ttasks.TASK_REGISTRY)
    for name in ("piqa", "arc_easy"):
        reg[name] = functools.partial(ttasks.TASK_REGISTRY[name], data=tstudy.TASK_DATA[name])

    class Unavailable:
        def __init__(self, data=None):
            raise RuntimeError("dataset arc_challenge/None unavailable offline")

    reg["arc_challenge"] = Unavailable
    monkeypatch.setattr(ttasks, "TASK_REGISTRY", reg)


def test_cli_tasks_with_cache(offline_tasks, tmp_path, capsys):
    argv = ["--net", "tiny-llama", "--quant_method", "rtn", "--group_size", "32", "--tasks",
            "piqa,arc_*", "--batch_size", "4", "--use_cache", str(tmp_path / "lm.sqlite"),
            "--device", "cpu"]
    first = cli.main(argv)
    err = capsys.readouterr().err
    assert "[cli] skipping task arc_challenge" in err
    assert set(first) == {"piqa", "arc_easy"} and 0 <= first["piqa"]["acc"] <= 1
    assert (tmp_path / "lm.sqlite").stat().st_size > 0
    assert cli.main(argv) == first  # answered from the cache


MMLU_DOCS = tstudy.synthetic_task_data(n_docs=3)["hendrycksTest-abstract_algebra"]
REGISTRY_RUNS = [
    (["--tasks", "hellaswag"], {"hellaswag"}),
    (["--tasks", "piqa,hendrycksTest-*"],
     {"piqa", "hendrycksTest-abstract_algebra", "hendrycksTest-anatomy", "mmlu_average",
      "mmlu_STEM"}),
    (["--tasks", "piqa", "--decontamination_ngrams_path", "GRAMS"], {"piqa"}),
]


@pytest.mark.parametrize("extra,keys", REGISTRY_RUNS, ids=["hellaswag", "piqa+mmlu", "decontam"])
def test_cli_runs_any_registry_task(monkeypatch, tmp_path, capsys, extra, keys):
    """Names and patterns of JAX's registry run (the documents injected;
    the tasks without any are skipped with JAX's message), MMLU subjects
    roll up as in JAX, and `--decontamination_ngrams_path` reaches
    `simple_evaluate` (no piqa goal holds the stored 13-grams, so
    `acc_decontaminate` is `acc`)."""
    from llama3_quantization_tpu_torch.decontamination import Janitor
    from llama3_quantization_tpu_torch.eval import harness

    docs = {**tstudy.synthetic_task_data(n_docs=3), **tstudy.TASK_DATA,
            "hendrycksTest-anatomy": MMLU_DOCS}
    reg = dict(ttasks.TASK_REGISTRY)
    for name, data in docs.items():
        reg[name] = functools.partial(ttasks.TASK_REGISTRY[name], data=data)
    monkeypatch.setattr(ttasks, "TASK_REGISTRY", reg)
    grams = tmp_path / "grams.pkl"
    j = Janitor()
    j.register_contaminant(" ".join(f"word{i}" for i in range(20)))
    j.save_contamination_ngrams(str(grams))
    seen = {}
    evaluate = harness.simple_evaluate
    monkeypatch.setattr(harness, "simple_evaluate",
                        lambda *a, **k: seen.update(k) or evaluate(*a, **k))
    res = cli.main(["--net", "tiny-llama", "--quant_method", "rtn", "--group_size", "32",
                    "--batch_size", "4", "--device", "cpu"]
                   + [str(grams) if a == "GRAMS" else a for a in extra])
    assert keys <= set(res), set(res)
    assert seen["decontamination_ngrams_path"] == (str(grams) if "GRAMS" in extra else None)
    if "GRAMS" in extra:
        assert res["piqa"]["acc_decontaminate"] == res["piqa"]["acc"]
    if "piqa,hendrycksTest-*" in extra:
        assert "[cli] skipping task hendrycksTest-virology" in capsys.readouterr().err
        accs = [res[f"hendrycksTest-{s}"]["acc"] for s in ("abstract_algebra", "anatomy")]
        assert res["mmlu_average"] == pytest.approx(sum(accs) / 2)


def test_cli_serving_recode_and_observe(capsys):
    res = cli.main(["--net", "tiny-llama", "--quant_method", "rtn", "--group_size", "32",
                    "--serving_recode", "--recode_head", "--fuse_decode", "--eval_ppl",
                    "--ppl_datasets", "c4", "--seqlen", "32", "--limit", "2", "--device", "cpu"])
    assert mm.get_backend() == "a8" and np.isfinite(res["c4"])
    assert "serving recode" in capsys.readouterr().err
    mm.set_backend("pallas")
    res = cli.main(["--net", "tiny-llama", "--quant_method", "gptq", "--group_size", "32",
                    "--nsamples", "2", "--seqlen", "32", "--blocksize", "32", "--observe",
                    "--calib_dataset", "synthetic", "--device", "cpu"])
    assert res == {} and "snr" in capsys.readouterr().err.lower()


def test_study_sweep_runs_the_configs(capsys):
    rows = tstudy.sweep(["--device", "cpu", "--net", "tiny-llama", "--synthetic", "--configs",
                         "rtn:4:32", "hqq:4:32", "irqlora:4:", "rtn:4:48", "--seqlen", "32",
                         "--limit", "2", "--ppl_datasets", "wikitext2"])
    assert [r[0] for r in rows] == ["rtn:4:32", "hqq:4:32", "irqlora:4:", "rtn:4:48"]
    assert all(np.isfinite(r[1]["wikitext2"]) for r in rows[:3])
    assert "not divisible" in rows[3][1]["error"]
    table = capsys.readouterr().out
    assert "| config | wikitext2 |" in table and "| hqq:4:32 |" in table


def test_study_sweep_exits_on_what_it_cannot_run(monkeypatch):
    """As JAX's sweep, a config the command line refuses stops the sweep;
    at its default tasks (the study's five) every config runs them."""
    with pytest.raises(SystemExit):
        tstudy.sweep(["--device", "cpu", "--net", "tiny-llama", "--synthetic", "--configs",
                      "bogus:4:32", "--seqlen", "32", "--limit", "2"])

    seen = []
    monkeypatch.setattr(cli, "main", lambda argv: seen.append(argv) or {"wikitext2": 9.5})
    rows = tstudy.sweep(["--device", "cpu", "--net", "tiny-llama", "--configs", "rtn:4:32",
                         "hqq:4:64"])
    assert [r[0] for r in rows] == ["rtn:4:32", "hqq:4:64"] and len(seen) == 2
    for argv in seen:
        assert argv[argv.index("--tasks") + 1] == tstudy.CSQA_TASKS == jstudy.CSQA_TASKS


def test_cli_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "llama3_quantization_tpu_torch.cli", "--device", "cpu", "--net",
         "tiny-llama", "--quant_method", "hqq", "--wbits", "4", "--group_size", "32",
         "--eval_ppl", "--ppl_datasets", "wikitext2", "--seqlen", "32", "--limit", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert np.isfinite(json.loads(out.stdout.strip().splitlines()[-1])["wikitext2"])
    assert "[cli] hqq W4g32" in out.stderr
