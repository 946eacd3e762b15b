"""Write SmoothQuant / LET activation statistics (port of
`llama3_quantization_tpu/tools/generate_act_stats.py`).

Per layer and per linear, the input's |max| and mean over a calibration
stream, in the npz layout both packages read (`quant/smoothquant.
save_act_stats`). JAX's command line, plus `--device` (default `cuda`; the
CPU only when asked): the model comes from `cli.load_model` (`--model
<HF dir>` in bf16, or `--net <name>` with random fp32 parameters seeded by
`--seed`), the windows from `cli.get_calib` (`--calib_dataset`; without a
tokenizer in the directory, or with `synthetic`, `default_rng(seed)` ids):

    python -m llama3_quantization_tpu_torch.tools.generate_act_stats \\
        --model /ckpt/Meta-Llama-3-8B --calib_dataset wikitext2 --out act_stats.npz
    python -m llama3_quantization_tpu_torch.tools.generate_act_stats --device cpu \\
        --net tiny-llama --calib_dataset synthetic --nsamples 8 --seqlen 64 --out s.npz
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser("generate_act_stats")
    p.add_argument("--model", default=None)
    p.add_argument("--net", default=None)
    p.add_argument("--calib_dataset", default="wikitext2",
                   choices=["wikitext2", "ptb", "c4", "synthetic"])
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda",
                   help="where the model runs: cuda (the default) or cpu")
    args = p.parse_args(argv)

    from ..cli import get_calib, load_model
    from ..quant.smoothquant import collect_act_stats, save_act_stats

    params, cfg = load_model(args)
    args.seqlen = min(args.seqlen, cfg.max_position_embeddings)
    tokenizer = None
    if args.model:
        from ..eval.data import HFTokenizer

        try:
            tokenizer = HFTokenizer(args.model)
        except Exception as e:
            print(f"tokenizer unavailable: {e}", file=sys.stderr)
    calib = get_calib(args, tokenizer, cfg.vocab_size)
    stats = collect_act_stats(params, cfg, calib)
    save_act_stats(stats, args.out)
    print(f"wrote {args.out} ({cfg.num_layers} layers)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
