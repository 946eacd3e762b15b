"""The system's command line on the port (port of
`llama3_quantization_tpu/cli.py`): load a model, quantize it, evaluate it,
save it.

    python -m llama3_quantization_tpu_torch.cli --net llama3-8b \\
        --quant_method hqq --wbits 4 --group_size 128 --eval_ppl
    python -m llama3_quantization_tpu_torch.cli --device cpu --net tiny-llama \\
        --quant_method hqq --wbits 4 --group_size 32 --eval_ppl --seqlen 64 --limit 2

`build_parser` has JAX's options, types, defaults and actions, and one
more: `--device` (default `cuda`; the CPU only when asked). `--model` reads
a local HF directory in bf16; `--net` builds the named config's random
parameters in fp32 from a `torch.Generator` seeded with `--seed` (the
port's values, not `jax.random`'s). Without a tokenizer the PPL streams are
JAX's `np.random.default_rng(0)` ids. The results JSON is the last line
of stdout; the `[cli]` lines go to stderr, as JAX prints them.

The matmul backend is the port's default, `pallas` (JAX's default is
`xla`; `ops.matmul.backend("xla")` around `main` gives JAX's route).
`--tasks` takes any of JAX's registry names and patterns
(`eval/harness/tasks`), rolls MMLU subjects up as JAX does, and passes
`--decontamination_ngrams_path` to `simple_evaluate`. What the port cannot
do yet exits with the ROADMAP item it waits for, before any model is
loaded: `--tp`, `--dp`, `--sp` (A 5), `--moe_capacity` and non-llama
models (A 4).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("llama3_quantization_tpu")
    p.add_argument("--model", type=str, default=None, help="local HF checkpoint dir")
    p.add_argument("--net", type=str, default=None, help="named config (tiny-llama, opt-125m, …)")
    p.add_argument("--quant_method", default="rtn",
                   choices=["rtn", "gptq", "awq", "smoothquant", "hqq", "omniquant", "irqlora", "mixed", "none"])
    p.add_argument("--wbits", type=int, default=4)
    p.add_argument("--abits", type=int, default=16)
    p.add_argument("--group_size", type=int, default=None)
    p.add_argument("--symmetric", action="store_true")
    p.add_argument("--disable_zero_point", action="store_true")
    p.add_argument("--calib_dataset", default="wikitext2",
                   choices=["wikitext2", "ptb", "c4", "mix", "pile",
                            "ptb-new", "c4-new", "synthetic"])
    p.add_argument("--pile_data_file", default=None,
                   help="local val.jsonl(.zst) for --calib_dataset pile "
                        "(the reference hard-codes a cluster path)")
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--eval_ppl", action="store_true")
    p.add_argument("--ppl_datasets", default="wikitext2,c4,ptb")
    p.add_argument("--tasks", default="")
    p.add_argument("--num_fewshot", type=int, default=0)
    p.add_argument("--limit", type=int, default=-1)
    p.add_argument("--batch_size", type=int, default=8)
    # omniquant
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--lwc", action="store_true")
    p.add_argument("--let", action="store_true")
    p.add_argument("--lwc_lr", type=float, default=1e-2)
    p.add_argument("--let_lr", type=float, default=5e-3)
    p.add_argument("--aug_loss", action="store_true")
    # gptq
    p.add_argument("--percdamp", type=float, default=0.01)
    p.add_argument("--act_order", action="store_true")
    p.add_argument("--blocksize", type=int, default=128)
    p.add_argument("--true_sequential", action="store_true")
    p.add_argument("--observe", action="store_true",
                   help="per-linear SNR diagnostics table (reference llama.py --observe)")
    # hqq
    p.add_argument("--hqq_iters", type=int, default=20)
    # distribution
    p.add_argument("--tp", type=int, default=None, help="tensor-parallel size")
    p.add_argument("--dp", type=int, default=None, help="data-parallel size")
    p.add_argument("--sp", type=int, default=None,
                   help="sequence-parallel size for PPL (ring attention)")
    # io
    p.add_argument("--save_dir", default=None)
    p.add_argument("--output_json", default=None)
    p.add_argument("--real_quant", action="store_true", default=True,
                   help="always on: weights are stored packed/int8 (reference "
                        "needs this flag to opt into AutoGPTQ kernels)")
    p.add_argument("--use_cache", default=None, help="sqlite LM response cache path")
    p.add_argument("--decontamination_ngrams_path", default=None)
    p.add_argument("--serving_recode", action="store_true",
                   help="recode weights to per-column s8 + a8 backend (fast decode)")
    p.add_argument("--mixed_topk", type=int, default=4,
                   help="worst linears upgraded to W8 for --quant_method mixed")
    p.add_argument("--recode_head", action="store_true",
                   help="with --serving_recode: also recode lm_head to s8")
    p.add_argument("--fuse_decode", action="store_true",
                   help="with --serving_recode: horizontally fuse qkv and "
                        "gate/up projections (single-replica decode)")
    p.add_argument("--moe_capacity", type=float, default=None,
                   help="GShard-style MoE capacity factor (e.g. 1.25); "
                        "default dense exact routing")
    # the port's own
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (the default) or cpu")
    return p


#: flags whose paths the port does not have yet -> the ROADMAP item they wait for
UNPORTED_FLAGS = {
    "tp": "A 5 (parallelism)",
    "dp": "A 5 (parallelism)",
    "sp": "A 5 (parallelism)",
    "moe_capacity": "A 4 (other architectures: Mixtral's MoE dispatch)",
}


def refuse_unported(args) -> None:
    """Exit before any work on a flag the port cannot run yet, or on a task
    name that matches nothing."""
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag} is not ported yet: it waits for ROADMAP {item}")
    if args.tasks:
        check_tasks([t for t in args.tasks.split(",") if t])


def load_model(args):
    """(params, cfg): `--model <dir>` through `from_hf_checkpoint` (bf16),
    `--net <name>` from `init_params` in fp32 (`cli.py:94-122`)."""
    import torch

    from .device import resolve_device
    from .models.configs import NAMED_CONFIGS
    from .models.hf_loader import config_from_hf, from_hf_checkpoint
    from .models.params import init_params

    dev = resolve_device(args.device)
    if args.model:
        import os

        try:
            with open(os.path.join(args.model, "config.json")) as f:
                mt = json.load(f).get("model_type")
        except OSError:
            mt = None
        if mt in ("t5", "mt5", "longt5"):
            raise SystemExit(f"model_type {mt!r} (the T5 trunk) waits for ROADMAP A 4")
        cfg = config_from_hf(args.model)
        if cfg.arch != "llama":
            raise SystemExit(f"model_type {mt!r} ({cfg.arch}) waits for ROADMAP A 4 "
                             "(other architectures)")
        return from_hf_checkpoint(args.model, cfg, device=dev)
    if args.net:
        cfg = NAMED_CONFIGS[args.net]
        if cfg.arch != "llama":
            raise SystemExit(f"--net {args.net} ({cfg.arch}) waits for ROADMAP A 4 "
                             "(other architectures)")
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return init_params(cfg, gen, dtype=torch.float32, device=dev), cfg
    raise SystemExit("pass --model <dir> or --net <named-config>")


def get_calib(args, tokenizer, vocab_size: int) -> np.ndarray:
    if args.calib_dataset == "synthetic" or tokenizer is None:
        rng = np.random.default_rng(args.seed)
        return rng.integers(0, vocab_size, (args.nsamples, args.seqlen))
    from .eval.data import get_loaders

    kw = {}
    if args.calib_dataset == "pile" and getattr(args, "pile_data_file", None):
        kw["data_file"] = args.pile_data_file
    loader, _ = get_loaders(
        args.calib_dataset, nsamples=args.nsamples, seed=args.seed,
        seqlen=args.seqlen, tokenizer=tokenizer, **kw,
    )
    return np.concatenate([inp for inp, _ in loader], axis=0)


def check_tasks(requested):
    """JAX's task-name checks (`cli.py:365-371`): names and patterns that
    match nothing in the registry exit. Returns the matched names."""
    from .eval.harness.evaluator import pattern_match
    from .eval.harness.tasks import TASK_REGISTRY

    names = pattern_match(requested, list(TASK_REGISTRY))
    unknown = set(requested) - set(names) - {
        t for t in requested if any(c in t for c in "*?[")
    }
    if unknown:
        raise SystemExit(f"unknown tasks: {sorted(unknown)}")
    return names


def task_dict_for(requested):
    """The checked tasks built; a task whose dataset is not available
    offline is skipped with a warning."""
    from .eval.harness.tasks import TASK_REGISTRY

    names = check_tasks(requested)
    task_dict = {}
    for name in names:
        try:
            task_dict[name] = TASK_REGISTRY[name]()
        except RuntimeError as e:
            print(f"[cli] skipping task {name}: {e}", file=sys.stderr)
    return task_dict


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    t0 = time.time()
    params, cfg = load_model(args)
    print(f"[cli] model ready ({cfg.arch}, {cfg.num_layers}L) in {time.time()-t0:.1f}s",
          file=sys.stderr)
    if args.seqlen > cfg.max_position_embeddings:
        # the reference pins seqlen to the model's position table
        print(f"[cli] seqlen {args.seqlen} > max_position_embeddings "
              f"{cfg.max_position_embeddings}; clamping", file=sys.stderr)
        args.seqlen = cfg.max_position_embeddings

    tokenizer = None
    if args.model:
        from .eval.data import HFTokenizer

        try:
            tokenizer = HFTokenizer(args.model)
        except Exception as e:
            print(f"[cli] tokenizer unavailable: {e}", file=sys.stderr)

    from .models.transformer import RuntimeQuantConfig
    from .quant.quantizer import QuantSpec

    rq = RuntimeQuantConfig(act=QuantSpec(n_bits=args.abits) if args.abits < 16 else None)

    if args.quant_method not in ("none",) and args.wbits < 16:
        spec = QuantSpec(
            n_bits=args.wbits,
            group_size=args.group_size,
            symmetric=args.symmetric,
            disable_zero_point=args.disable_zero_point,
        )
        calib = None
        if args.quant_method in ("gptq", "awq", "smoothquant", "omniquant", "mixed"):
            calib = get_calib(args, tokenizer, cfg.vocab_size)
        from .api import quantize

        kw = {}
        snr_rows: list = []
        if args.quant_method == "gptq":
            kw = dict(blocksize=args.blocksize, percdamp=args.percdamp,
                      actorder=args.act_order, true_sequential=args.true_sequential)
            if args.observe:
                kw["snr_log"] = snr_rows
        elif args.quant_method == "omniquant":
            kw = dict(epochs=args.epochs, lwc_lr=args.lwc_lr, aug_loss=args.aug_loss,
                      let=args.let, let_lr=args.let_lr)
        elif args.quant_method == "hqq":
            kw = dict(iters=args.hqq_iters)
        elif args.quant_method == "mixed":
            # observer-driven mixed precision needs unpacked containers
            kw = dict(pack=False, blocksize=args.blocksize, topk=args.mixed_topk)
        t0 = time.time()
        params = quantize(params, cfg, args.quant_method, spec, calib, **kw)
        print(f"[cli] {args.quant_method} W{args.wbits}"
              f"{'g'+str(args.group_size) if args.group_size else ''} "
              f"in {time.time()-t0:.1f}s", file=sys.stderr)
        if snr_rows:
            from .quant.gptq import format_snr_table

            print(format_snr_table(snr_rows), file=sys.stderr)

    if args.serving_recode:
        from .ops import matmul as mm
        from .quant.serving import recode_model_s8

        params = recode_model_s8(params, cfg, include_head=args.recode_head)
        mm.set_backend("a8")
        print("[cli] serving recode: per-column s8 weights, a8 backend", file=sys.stderr)
        if args.fuse_decode:
            from .quant.serving import fuse_for_decode

            params = fuse_for_decode(params, cfg)
            print("[cli] fused qkv + gate/up projections", file=sys.stderr)

    results = {}
    if args.eval_ppl:
        from .eval.data import get_loaders
        from .eval.ppl import eval_ppl_suite

        streams = {}
        for ds in args.ppl_datasets.split(","):
            if tokenizer is None:
                rng = np.random.default_rng(0)
                streams[ds] = rng.integers(0, cfg.vocab_size, (1, args.seqlen * 4))
            else:
                _, testenc = get_loaders(ds, seed=args.seed, seqlen=args.seqlen,
                                         tokenizer=tokenizer)
                streams[ds] = np.asarray(testenc)
        limit = None if args.limit == -1 else args.limit
        results.update(eval_ppl_suite(params, cfg, streams, seqlen=args.seqlen, rq=rq,
                                      limit=limit))
        for k, v in results.items():
            print(f"[cli] {k} ppl = {v:.4f}", file=sys.stderr)

    if args.tasks:
        from .eval.data import ByteTokenizer
        from .eval.harness import TorchLM, make_table, simple_evaluate

        task_dict = task_dict_for([t for t in args.tasks.split(",") if t])
        lm = TorchLM(params, cfg, tokenizer or ByteTokenizer(), rq=rq,
                     batch_size=args.batch_size)
        if args.use_cache:
            from .eval.harness import CachingLM

            lm = CachingLM(lm, args.use_cache)
        t_res = simple_evaluate(
            lm, tasks=task_dict, num_fewshot=args.num_fewshot,
            limit=None if args.limit == -1 else args.limit,
            decontamination_ngrams_path=args.decontamination_ngrams_path,
        )
        results.update(t_res["results"])
        print(make_table(t_res), file=sys.stderr)
        if any(t.startswith("hendrycksTest") for t in args.tasks.split(",")):
            from .eval.mmlu_categories import mmlu_rollup

            roll = mmlu_rollup(t_res["results"])
            results.update(roll)
            for k, v in roll.items():
                print(f"[cli] {k} = {v:.4f}", file=sys.stderr)

    if args.save_dir:
        from .models.hf_loader import save_checkpoint

        save_checkpoint(params, cfg, args.save_dir)
        print(f"[cli] saved to {args.save_dir}", file=sys.stderr)

    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(results, f, indent=2, default=str)
        print(f"[cli] results written to {args.output_json}", file=sys.stderr)

    print(json.dumps(results, default=str))
    return results


if __name__ == "__main__":
    main()
