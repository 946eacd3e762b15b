"""Cross-encoder IR benchmark tool — the `benchmark_beir.py` CLI
equivalent (the reference's `benchmark_beir.py:272-374`): quantize a model,
BM25 first-stage retrieval, UPR rerank of the top-k, NDCG/MAP/Recall/P for
both stages.

Data: a BEIR-format directory (`corpus.jsonl` with _id/title/text,
`queries.jsonl` with _id/text, `qrels/test.tsv` query-id\tcorpus-id\tscore)
— or `--synthetic N` which fabricates a tiny corpus so the full pipeline
runs anywhere (the reference needs an Elasticsearch server; the BM25 here
is in-process, `eval/retrieval.py`).

Port of `llama3_quantization_tpu/tools/benchmark_ir.py`: the same flags, plus
`--device` (default `cuda`; the CPU only when asked), and the same JSON
last on stdout (`tests/test_torch_retrieval_sts.py` holds it to JAX's).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def load_beir_dir(path: str):
    corpus, queries, qrels = {}, {}, {}
    with open(os.path.join(path, "corpus.jsonl")) as f:
        for line in f:
            d = json.loads(line)
            corpus[str(d["_id"])] = (d.get("title", "") + " " + d.get("text", "")).strip()
    with open(os.path.join(path, "queries.jsonl")) as f:
        for line in f:
            d = json.loads(line)
            queries[str(d["_id"])] = d["text"]
    qrels_path = os.path.join(path, "qrels", "test.tsv")
    with open(qrels_path) as f:
        next(f)  # header
        for line in f:
            qid, did, score = line.strip().split("\t")
            qrels.setdefault(qid, {})[did] = int(score)
    return corpus, queries, qrels


def synthetic_beir(n_docs: int, n_queries: int = 8, seed: int = 0):
    import random

    rnd = random.Random(seed)
    words = [f"w{i}" for i in range(50)]
    corpus = {
        f"d{i}": " ".join(rnd.choices(words, k=20)) + f" topic{i % n_queries}"
        for i in range(n_docs)
    }
    queries = {f"q{j}": f"about topic{j}" for j in range(n_queries)}
    qrels = {
        f"q{j}": {f"d{i}": 1 for i in range(n_docs) if i % n_queries == j}
        for j in range(n_queries)
    }
    return corpus, queries, qrels


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="")
    p.add_argument("--net", default="tiny-llama")
    p.add_argument("--data_dir", default="", help="BEIR-format dataset directory")
    p.add_argument("--synthetic", type=int, default=0, help="fabricate N docs instead")
    p.add_argument("--wbits", type=int, default=16)
    p.add_argument("--group_size", type=int, default=None)
    p.add_argument("--quant_method", default="rtn")
    p.add_argument("--top_k", type=int, default=10, help="rerank depth (`--top_k`)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--output_json", default="")
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (the default) or cpu")
    args = p.parse_args(argv)

    from ..cli import load_model
    from ..eval.data import ByteTokenizer, HFTokenizer
    from ..eval.retrieval import BM25Index, UPRReranker, evaluate_retrieval

    params, cfg = load_model(args)
    if args.wbits < 16:
        from ..models.params import quantize_model_rtn
        from ..quant.quantizer import QuantSpec

        params = quantize_model_rtn(
            params, cfg, QuantSpec(n_bits=args.wbits, group_size=args.group_size)
        )
        print(f"[ir] quantized W{args.wbits}", file=sys.stderr)
    try:
        tokenizer = HFTokenizer(args.model) if args.model else ByteTokenizer()
    except Exception:
        tokenizer = ByteTokenizer()

    if args.data_dir:
        corpus, queries, qrels = load_beir_dir(args.data_dir)
    else:
        corpus, queries, qrels = synthetic_beir(args.synthetic or 32)
    print(f"[ir] {len(corpus)} docs, {len(queries)} queries", file=sys.stderr)

    bm25 = BM25Index(corpus)
    first_stage = {qid: bm25.search(q, top_k=100) for qid, q in queries.items()}
    bm25_metrics = evaluate_retrieval(qrels, first_stage)

    reranker = UPRReranker(params, cfg, tokenizer)
    reranked = reranker.rerank(
        corpus, queries, first_stage, top_k=args.top_k, batch_size=args.batch_size
    )
    upr_metrics = evaluate_retrieval(qrels, reranked)

    results = {"bm25": bm25_metrics, "upr": upr_metrics}
    for stage, m in results.items():
        for k, v in sorted(m.items()):
            print(f"[ir] {stage} {k} = {v:.4f}", file=sys.stderr)
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
