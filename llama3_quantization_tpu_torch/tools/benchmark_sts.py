"""Bi-encoder STS benchmark tool — the `benchmark_mteb.py` CLI
equivalent (the reference's `benchmark_mteb.py:284-368`): quantize a model,
embed sentence pairs with the decoder trunk's last-token hidden state, and
report Spearman of cosine similarity vs gold scores.

Data: a TSV of `score\tsentence1\tsentence2` (STS-B style) per task, or
`--synthetic N` pairs so the pipeline runs anywhere.

Port of `llama3_quantization_tpu/tools/benchmark_sts.py`: the same flags, plus
`--device` (default `cuda`; the CPU only when asked), and the same JSON
last on stdout (`tests/test_torch_retrieval_sts.py` holds it to JAX's).
"""

from __future__ import annotations

import argparse
import json
import sys


def load_sts_tsv(path: str):
    pairs, gold = [], []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            gold.append(float(parts[0]))
            pairs.append((parts[1], parts[2]))
    return pairs, gold


def synthetic_sts(n: int, seed: int = 0):
    import random

    rnd = random.Random(seed)
    words = [f"tok{i}" for i in range(40)]
    pairs, gold = [], []
    for i in range(n):
        a = rnd.choices(words, k=8)
        overlap = rnd.randint(0, 8)
        b = a[:overlap] + rnd.choices(words, k=8 - overlap)
        pairs.append((" ".join(a), " ".join(b)))
        gold.append(overlap / 8 * 5.0)
    return pairs, gold


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="")
    p.add_argument("--net", default="tiny-llama")
    p.add_argument("--data_tsv", default="", help="score\\ts1\\ts2 file")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--wbits", type=int, default=16)
    p.add_argument("--group_size", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--output_json", default="")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (the default) or cpu")
    args = p.parse_args(argv)

    from ..cli import load_model
    from ..eval.data import ByteTokenizer, HFTokenizer
    from ..eval.sts import STSEncoder, evaluate_sts

    params, cfg = load_model(args)
    if args.wbits < 16:
        from ..models.params import quantize_model_rtn
        from ..quant.quantizer import QuantSpec

        params = quantize_model_rtn(
            params, cfg, QuantSpec(n_bits=args.wbits, group_size=args.group_size)
        )
        print(f"[sts] quantized W{args.wbits}", file=sys.stderr)
    try:
        tokenizer = HFTokenizer(args.model) if args.model else ByteTokenizer()
    except Exception:
        tokenizer = ByteTokenizer()

    if args.data_tsv:
        pairs, gold = load_sts_tsv(args.data_tsv)
    else:
        pairs, gold = synthetic_sts(args.synthetic or 32)
    print(f"[sts] {len(pairs)} pairs", file=sys.stderr)

    enc = STSEncoder(params, cfg, tokenizer)
    results = evaluate_sts(enc, pairs, gold, batch_size=args.batch_size)
    for k, v in results.items():
        print(f"[sts] {k} = {v:.4f}", file=sys.stderr)
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
