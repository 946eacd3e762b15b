"""The study table's golden rows on the port (counterpart of the root
`tools/reproduce_study.py:87-183` for the rows `fp`, `rtn`, `rtn_s4` and
`rtn_a8`).

The same recipe as the JAX study: `TINY_LLAMA` with the parameters JAX's
`init_params(PRNGKey(0), float32)` gives (kept in `tiny_llama_init.npz`
beside this file, held equal to JAX's by `tests/test_torch_eval.py`),
`SyntheticTokenizer` over `tests/fixtures/wikitext2_slice.txt` with
calibration windows from the front half and PPL windows from the back
half, RTN `QuantSpec(4, 32)` (unpacked only under "a8"), SEQLEN 64, 8
calibration windows, a PPL limit of 24 windows, and piqa / arc_easy
zero-shot on the documents written out below. `fp` and `rtn` run under the
"xla" backend (the JAX package's default), `rtn_s4` and `rtn_a8` under
"s4" and "a8".

    python -m llama3_quantization_tpu_torch.tools.reproduce_study            # on the card
    python -m llama3_quantization_tpu_torch.tools.reproduce_study --device cpu --check

`--check` compares every number with `tests/fixtures/golden_study.json`
within |got - golden| <= 2e-3 * max(1, |golden|) and exits non-zero on a
miss.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
PARAMS_NPZ = HERE / "tiny_llama_init.npz"
GOLDEN = REPO / "tests" / "fixtures" / "golden_study.json"
CORPUS = REPO / "tests" / "fixtures" / "wikitext2_slice.txt"

#: the rows the port reproduces, each with its matmul backend
ROWS = {"fp": "xla", "rtn": "xla", "rtn_s4": "s4", "rtn_a8": "a8"}

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


def load_tiny_params(device="cuda"):
    """JAX's `init_params(TINY_LLAMA, PRNGKey(0), float32)`, from the npz."""
    from ..convert import params_from_numpy

    tree: Dict = {}
    with np.load(PARAMS_NPZ) as z:
        for key in z.files:
            node = tree
            *path, leaf = key.split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    return params_from_numpy(tree, device=device)


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


def run_study(methods: Optional[Iterable[str]] = None, device="cuda", params=None,
              verbose: bool = True) -> Dict[str, Dict[str, float]]:
    """The rows `methods` (default: all of ROWS) on `device`: PPL on the
    fixture's back half, piqa accuracy and arc_easy normalized accuracy,
    rounded as the golden JSON rounds them. `params` overrides the npz
    (JAX-layout TINY_LLAMA parameters already on `device`)."""
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
    cfg = TINY_LLAMA
    params = params if params is not None else load_tiny_params(dev)
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
    for method in methods or ROWS:
        exec_backend = ROWS[method]
        base = method.split("_")[0]
        if base == "fp":
            qp = params
        else:
            qp = quantize(params, cfg, method=base, spec=spec, calib_tokens=calib,
                          pack=exec_backend != "a8")  # a8 takes unpacked s8 containers
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
    return out


def golden_misses(table: Dict[str, Dict[str, float]]):
    """Every (row, column, got, golden) outside |got - golden| <= 2e-3 *
    max(1, |golden|), the bound of `tests/test_golden_study.py`."""
    golden = json.loads(GOLDEN.read_text())
    return [(m, k, v, golden[m][k]) for m, row in table.items() for k, v in row.items()
            if not abs(v - golden[m][k]) <= 2e-3 * max(1.0, abs(golden[m][k]))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--methods", default=",".join(ROWS))
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
