"""The study table on the port, in two halves.

**The golden rows** (counterpart of the root `tools/reproduce_study.py:87-229`
for every decoder row: `fp`, `rtn`, `gptq`, `awq`, `smoothquant`,
`omniquant`, `hqq`, `irqlora`, `mixed`, `rtn_s4` and `rtn_a8`; and the
seq2seq rows `seq2seq_fp`, `seq2seq_rtn` and `seq2seq_gptq`).

The same recipe as the JAX study: `TINY_LLAMA` with the parameters JAX's
`init_params(PRNGKey(0), float32)` gives (kept in `tiny_llama_init.npz`
beside this file, held equal to JAX's by `tests/test_torch_eval.py`),
`SyntheticTokenizer` over `tests/fixtures/wikitext2_slice.txt` with
calibration windows from the front half and PPL windows from the back
half, RTN `QuantSpec(4, 32)` (unpacked only under "a8"), SEQLEN 64, 8
calibration windows, a PPL limit of 24 windows, and piqa / arc_easy
zero-shot on the documents written out below, each method with the root
study's kwargs (`KWARGS`: GPTQ and mixed at blocksize 32, OmniQuant for one
epoch). `fp`, `rtn` and the calibration quantizers run under the "xla"
backend (the JAX package's default), `rtn_s4` and `rtn_a8` under "s4" and
"a8". The seq2seq rows (`SEQ2SEQ_ROWS`) take the T5 trunk of the root
study: vocab 512, d_model 32, d_kv 8, d_ff 64, 4 heads, 2 + 2 layers, 8
buckets, with the parameters of JAX's `init_seq2seq_params(PRNGKey(7))`
(`tiny_seq2seq_init.npz`), RTN and GPTQ at `QuantSpec(4, 8)` on the same
calibration windows (split by `split_calib_pairs`, batch 4), piqa and
arc_easy through `Seq2SeqTorchLM`, under "xla".

    python -m llama3_quantization_tpu_torch.tools.reproduce_study            # on the card
    python -m llama3_quantization_tpu_torch.tools.reproduce_study --device cpu --check

`--check` compares every number with `tests/fixtures/golden_study.json`
within |got - golden| <= 2e-3 * max(1, |golden|) and exits non-zero on a
miss.

**The study sweep** (port of `llama3_quantization_tpu/tools/reproduce_study.py`):
the method x bit-width matrix of the study (`STUDY_CONFIGS`, each
`method:wbits:group[_aN]`) through the port's `cli.main`, and its markdown
table. It is entered by that tool's flags (`--configs`, `--net`,
`--model`, `--synthetic`, `--tasks`, `--ppl_datasets`, `--calib_dataset`,
`--nsamples`, `--seqlen`, `--limit`, `--out`), with `--device`:

    python -m llama3_quantization_tpu_torch.tools.reproduce_study --device cpu \
        --net tiny-llama --synthetic --configs rtn:4:32 hqq:4:32 --seqlen 64 --limit 2
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
PARAMS_NPZ = HERE / "tiny_llama_init.npz"
SEQ2SEQ_NPZ = HERE / "tiny_seq2seq_init.npz"
GOLDEN = REPO / "tests" / "fixtures" / "golden_study.json"
CORPUS = REPO / "tests" / "fixtures" / "wikitext2_slice.txt"

#: the rows the port reproduces, each with its matmul backend
ROWS = {"fp": "xla", "rtn": "xla", "gptq": "xla", "awq": "xla", "smoothquant": "xla",
        "omniquant": "xla", "hqq": "xla", "irqlora": "xla", "mixed": "xla", "rtn_s4": "s4",
        "rtn_a8": "a8"}
#: the seq2seq rows (root `tools/reproduce_study.py:186-229`), under "xla"
SEQ2SEQ_ROWS = ("seq2seq_fp", "seq2seq_rtn", "seq2seq_gptq")
#: each method's kwargs, the root study's (`tools/reproduce_study.py:38-57`)
KWARGS = {"gptq": {"blocksize": 32}, "omniquant": {"epochs": 1}, "hqq": {"iters": 10},
          "irqlora": {"tau_n": 10, "blocksize2": 4}, "mixed": {"blocksize": 32}}

SEQLEN = 64
NSAMPLES_CALIB = 8
PPL_LIMIT = 24  # windows

# the root study's offline task docs (`tools/reproduce_study.py:64-84`)
PIQA_DOCS = [
    {"goal": f"how to {v} a {n}", "sol1": f"use the {a} {t}", "sol2": f"ask a {p}",
     "label": i % 2}
    for i, (v, n, a, t, p) in enumerate(
        [("clean", "window", "soft", "cloth", "neighbour"),
         ("fix", "chair", "small", "hammer", "carpenter"),
         ("open", "jar", "rubber", "grip", "friend"),
         ("plant", "seed", "garden", "trowel", "gardener"),
         ("wrap", "gift", "bright", "paper", "clerk"),
         ("store", "rice", "sealed", "jar", "grocer")])
]
ARC_DOCS = [
    {"id": str(i), "question": f"which element has number {i + 1}?",
     "choices": {"text": ["helium", "hydrogen", "carbon"], "label": ["A", "B", "C"]},
     "answerKey": "B"}
    for i in range(5)
]
TASK_DATA = {
    "piqa": {"train": PIQA_DOCS, "validation": PIQA_DOCS},
    "arc_easy": {"train": ARC_DOCS, "validation": ARC_DOCS, "test": ARC_DOCS},
}


#: the harness tasks `synthetic_task_data` writes documents for
SYNTHETIC_TASKS = ("hellaswag", "winogrande", "hendrycksTest-abstract_algebra", "lambada_openai",
                   "wikitext", "gsm8k")


def synthetic_task_data(seed: int = 0, n_docs: int = 8, n_pages: int = 2,
                        page_bytes: int = 5000, n_gsm8k: int = 2) -> Dict[str, Dict[str, list]]:
    """Seeded documents for `SYNTHETIC_TASKS`, each in its task's raw
    (HF dataset) schema, for `simple_evaluate(..., task_data=...)` where no
    dataset is at hand: words drawn with `np.random.default_rng(seed)` from
    the fixture corpus, wikitext pages cut from it at seeded offsets
    (`page_bytes` each, whole lines). `n_docs` documents a task (hellaswag
    with 4 endings, MMLU with 4 choices), `n_gsm8k` for gsm8k."""
    rng = np.random.default_rng(seed)
    text = CORPUS.read_text()
    vocab = sorted({w for w in text.split() if w.isalpha() and w.islower()})

    def words(n: int) -> str:
        return " ".join(vocab[i] for i in rng.integers(0, len(vocab), n))

    hellaswag = [{"activity_label": words(2).capitalize(), "ctx_a": words(16) + ".",
                  "ctx_b": words(6), "endings": [words(8) + "." for _ in range(4)],
                  "label": str(i % 4)} for i in range(n_docs)]
    winogrande = [{"sentence": f"{words(10).capitalize()} _ {words(8)}.", "option1": words(1),
                   "option2": words(1), "answer": str(1 + i % 2)} for i in range(n_docs)]
    mmlu = [{"question": words(12) + "?", "choices": [words(3) for _ in range(4)],
             "answer": i % 4} for i in range(n_docs)]
    lambada = [{"text": words(40)} for _ in range(n_docs)]
    pages = []
    for start in rng.integers(0, len(text) - 2 * page_bytes, n_pages):
        start = text.index("\n", int(start)) + 1
        pages.append({"page": text[start: text.index("\n", start + page_bytes) + 1]})
    gsm8k = [{"question": words(20) + "?",
              "answer": f"{words(10)}.\n#### {int(rng.integers(1, 1000))}"}
             for _ in range(n_gsm8k)]
    return {
        "hellaswag": {"train": hellaswag, "validation": hellaswag},
        "winogrande": {"train": winogrande, "validation": winogrande},
        "hendrycksTest-abstract_algebra": {"test": mmlu, "validation": mmlu, "dev": mmlu},
        "lambada_openai": {"test": lambada},
        "wikitext": {"train": pages, "validation": pages, "test": pages},
        "gsm8k": {"train": gsm8k, "test": gsm8k},
    }


class Recorder:
    """An LM answering through `lm` that keeps each call's requests and
    answers, in order (what `simple_evaluate` aggregates away)."""

    def __init__(self, lm):
        self.lm, self.calls = lm, []

    def _call(self, kind, requests):
        out = getattr(self.lm, kind)(requests)
        self.calls.append((kind, list(requests), list(out)))
        return out

    def loglikelihood(self, requests):
        return self._call("loglikelihood", requests)

    def loglikelihood_rolling(self, requests):
        return self._call("loglikelihood_rolling", requests)

    def greedy_until(self, requests):
        return self._call("greedy_until", requests)


def load_tiny_params(device="cuda"):
    """JAX's `init_params(TINY_LLAMA, PRNGKey(0), float32)`, from the npz."""
    return load_params_npz(PARAMS_NPZ, device)


def load_params_npz(path, device="cuda"):
    """A parameter tree from an npz of flattened `a/b/c` keys (JAX layout)."""
    from ..convert import params_from_numpy

    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *path, leaf = key.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    return params_from_numpy(tree, device=device)


def tiny_seq2seq_config(vocab_size: int = 512):
    """The root study's T5 trunk (`tools/reproduce_study.py:204-207`)."""
    from ..models.seq2seq import Seq2SeqConfig

    return Seq2SeqConfig(vocab_size=vocab_size, d_model=32, d_kv=8, d_ff=64, num_heads=4,
                         num_layers=2, num_decoder_layers=2, rel_buckets=8)


def load_tiny_seq2seq_params(device="cuda"):
    """JAX's `init_seq2seq_params(tiny_seq2seq_config(), PRNGKey(7))`, from
    the npz."""
    return load_params_npz(SEQ2SEQ_NPZ, device)


class Tok:
    """The study's tokenizer adapter: `SyntheticTokenizer` ids as lists,
    end of text 0."""

    eot_token_id = 0

    def __init__(self, tok):
        self.tok = tok
        self.vocab_size = tok.vocab_size

    def encode(self, s):
        return self.tok.encode(s).tolist()

    def decode(self, ids):
        return self.tok.decode(ids)


def seq2seq_rows(methods, calib, tok, device, verbose: bool = True):
    """The seq2seq rows `methods` (of SEQ2SEQ_ROWS): piqa accuracy and
    arc_easy normalized accuracy of the tiny T5 trunk, fp or quantized on
    `calib` (`tools/reproduce_study.py:195-229`)."""
    import torch

    from ..api import quantize
    from ..eval.harness import Seq2SeqTorchLM, simple_evaluate
    from ..ops import matmul as mm
    from ..quant.quantizer import QuantSpec

    cfg = tiny_seq2seq_config(tok.vocab_size)
    params = load_tiny_seq2seq_params(device)
    out = {}
    for row in methods:
        method = row[len("seq2seq_"):]
        with mm.backend("xla"), torch.inference_mode():
            qp = params if method == "fp" else quantize(
                params, cfg, method=method, spec=QuantSpec(n_bits=4, group_size=8),
                calib_tokens=calib, batch_size=4)
            lm = Seq2SeqTorchLM(qp, cfg, Tok(tok), batch_size=4, max_length=SEQLEN, device=device)
            res = simple_evaluate(lm, ["piqa", "arc_easy"], num_fewshot=0, bootstrap_iters=2,
                                  task_data=TASK_DATA)["results"]
        out[row] = {"piqa_acc": round(res["piqa"]["acc"], 4),
                    "arc_easy_acc_norm": round(res["arc_easy"]["acc_norm"], 4)}
        if verbose:
            print(f"  {row:<12} piqa={out[row]['piqa_acc']} arc={out[row]['arc_easy_acc_norm']}",
                  flush=True)
    return out


def run_study(methods: Optional[Iterable[str]] = None, device="cuda", params=None,
              verbose: bool = True) -> Dict[str, Dict[str, float]]:
    """The rows `methods` (default: all of ROWS and SEQ2SEQ_ROWS) on
    `device`: PPL on the fixture's back half, piqa accuracy and arc_easy
    normalized accuracy (the seq2seq rows: the accuracies), rounded as the
    golden JSON rounds them. `params` overrides the npz (JAX-layout
    TINY_LLAMA parameters already on `device`)."""
    import torch

    from ..api import quantize
    from ..device import resolve_device
    from ..eval.data import SyntheticTokenizer, get_loaders
    from ..eval.harness import TorchLM, simple_evaluate
    from ..eval.ppl import compute_ppl
    from ..models.configs import TINY_LLAMA
    from ..ops import matmul as mm
    from ..quant.quantizer import QuantSpec

    dev = resolve_device(device)
    methods = list(methods or (*ROWS, *SEQ2SEQ_ROWS))
    cfg = TINY_LLAMA
    tok = SyntheticTokenizer()
    text = CORPUS.read_text()
    cut = len(text) // 2
    trainloader, testenc = get_loaders(
        "wikitext2", nsamples=NSAMPLES_CALIB, seed=0, seqlen=SEQLEN,
        tokenizer=tok, train_text=text[:cut], test_text=text[cut:],
    )
    calib = np.stack([inp[0] for inp, _ in trainloader])
    spec = QuantSpec(n_bits=4, group_size=32)
    out = {}
    decoder_rows = [m for m in methods if m not in SEQ2SEQ_ROWS]
    if decoder_rows:
        params = params if params is not None else load_tiny_params(dev)
    for method in decoder_rows:
        exec_backend = ROWS[method]
        base = method.split("_")[0]
        if base == "fp":
            qp = params
        else:
            qp = quantize(params, cfg, method=base, spec=spec, calib_tokens=calib,
                          pack=exec_backend != "a8",  # a8 takes unpacked s8 containers
                          **KWARGS.get(method, {}))
        with mm.backend(exec_backend), torch.inference_mode():
            ppl = compute_ppl(qp, cfg, testenc, seqlen=SEQLEN, limit=PPL_LIMIT)
            lm = TorchLM(qp, cfg, Tok(tok), batch_size=4, max_length=SEQLEN, device=dev)
            res = simple_evaluate(lm, ["piqa", "arc_easy"], num_fewshot=0, bootstrap_iters=2,
                                  task_data=TASK_DATA)["results"]
        out[method] = {
            "ppl_wikitext2": round(ppl, 4),
            "piqa_acc": round(res["piqa"]["acc"], 4),
            "arc_easy_acc_norm": round(res["arc_easy"]["acc_norm"], 4),
        }
        if verbose:
            print(f"  {method:<8} ppl={out[method]['ppl_wikitext2']:<10} "
                  f"piqa={out[method]['piqa_acc']} arc={out[method]['arc_easy_acc_norm']}",
                  flush=True)
    s2 = [m for m in methods if m in SEQ2SEQ_ROWS]
    if s2:
        out.update(seq2seq_rows(s2, calib, tok, dev, verbose))
    return out


def golden_misses(table: Dict[str, Dict[str, float]]):
    """Every (row, column, got, golden) outside |got - golden| <= 2e-3 *
    max(1, |golden|), the bound of `tests/test_golden_study.py`."""
    golden = json.loads(GOLDEN.read_text())
    return [(m, k, v, golden[m][k]) for m, row in table.items() for k, v in row.items()
            if not abs(v - golden[m][k]) <= 2e-3 * max(1.0, abs(golden[m][k]))]


STUDY_CONFIGS = [
    "rtn:8:", "rtn:4:128", "rtn:3:128", "rtn:2:128",
    "gptq:8:", "gptq:4:128", "gptq:3:128", "gptq:2:128",
    "awq:4:128", "awq:3:128",
    "smoothquant:8:_a8",
    "hqq:4:64", "hqq:3:64", "hqq:2:64",
    "omniquant:3:128", "omniquant:2:128",
    "irqlora:4:", "mixed:2:32",
]

CSQA_TASKS = "piqa,arc_easy,arc_challenge,hellaswag,winogrande"

#: the sweep's flags (the JAX tool's); any of them selects the sweep
SWEEP_FLAGS = ("--configs", "--net", "--model", "--synthetic", "--tasks", "--ppl_datasets",
               "--calib_dataset", "--nsamples", "--seqlen", "--limit", "--out")


def parse_config(cfg_str: str):
    act = None
    if "_a" in cfg_str:
        cfg_str, a = cfg_str.rsplit("_a", 1)
        act = int(a)
    method, wbits, group = cfg_str.split(":")
    return method, int(wbits), int(group) if group else None, act


def sweep(argv=None):
    """The study sweep (`reproduce_study.py:48-118`): the tasks checked
    once, then one `cli.main` run per config, a run that raises recorded
    and the sweep continued (an exit stops it, as in JAX); prints the
    markdown table and returns the rows."""
    p = argparse.ArgumentParser("reproduce_study")
    p.add_argument("--model", default=None)
    p.add_argument("--net", default=None)
    p.add_argument("--configs", nargs="*", default=STUDY_CONFIGS)
    p.add_argument("--tasks", default=CSQA_TASKS)
    p.add_argument("--ppl_datasets", default="wikitext2,c4,ptb")
    p.add_argument("--calib_dataset", default="wikitext2")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic calib/eval data (smoke test)")
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--limit", type=int, default=-1)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..cli import check_tasks, main as cli_main

    if args.tasks and not args.synthetic:
        check_tasks([t for t in args.tasks.split(",") if t])
    rows = []
    for cfg_str in args.configs:
        method, wbits, group, act = parse_config(cfg_str)
        cli_args = [
            "--quant_method", method, "--wbits", str(wbits),
            "--calib_dataset", "synthetic" if args.synthetic else args.calib_dataset,
            "--nsamples", str(args.nsamples), "--seqlen", str(args.seqlen),
            "--eval_ppl", "--ppl_datasets", args.ppl_datasets,
            "--limit", str(args.limit), "--device", args.device,
        ]
        if group:
            cli_args += ["--group_size", str(group)]
        if act:
            cli_args += ["--abits", str(act)]
        if args.tasks and not args.synthetic:
            cli_args += ["--tasks", args.tasks]
        if args.model:
            cli_args += ["--model", args.model]
        else:
            cli_args += ["--net", args.net or "tiny-llama"]
        print(f"=== {cfg_str} ===", file=sys.stderr)
        t0 = time.time()
        try:
            results = cli_main(cli_args)
        except Exception as e:  # record and continue the sweep
            print(f"{cfg_str} FAILED: {e}", file=sys.stderr)
            rows.append((cfg_str, {"error": str(e)}))
            continue
        results["_seconds"] = round(time.time() - t0, 1)
        rows.append((cfg_str, results))

    ppl_cols = args.ppl_datasets.split(",")
    task_cols = [t for t in args.tasks.split(",") if t] if not args.synthetic else []
    header = "| config | " + " | ".join(ppl_cols + task_cols) + " |"
    sep = "|" + "---|" * (1 + len(ppl_cols) + len(task_cols))
    lines = [header, sep]
    for cfg_str, res in rows:
        cells = []
        for c in ppl_cols:
            v = res.get(c)
            cells.append(f"{v:.2f}" if isinstance(v, float) else "—")
        for t in task_cols:
            v = res.get(t, {})
            acc = v.get("acc") if isinstance(v, dict) else None
            cells.append(f"{acc*100:.1f}" if isinstance(acc, float) else "—")
        lines.append(f"| {cfg_str} | " + " | ".join(cells) + " |")
    table = "\n".join(lines)
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n\n```json\n" + json.dumps(dict(rows), default=str, indent=1)
                    + "\n```\n")
        print(f"wrote {args.out}", file=sys.stderr)
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if any(a.split("=")[0] in SWEEP_FLAGS for a in argv):
        sweep(argv)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--methods", default=",".join((*ROWS, *SEQ2SEQ_ROWS)))
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    table = run_study(args.methods.split(","), device=args.device)
    if args.check:
        misses = golden_misses(table)
        for m, k, v, g in misses:
            print(f"  {m}.{k}: got {v}, golden {g}", file=sys.stderr)
        return 1 if misses else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
