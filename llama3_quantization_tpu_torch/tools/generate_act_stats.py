"""Write SmoothQuant / LET activation statistics (port of
`llama3_quantization_tpu/tools/generate_act_stats.py`).

Per layer and per linear, the input's |max| and mean over a calibration
stream, in the npz layout both packages read (`quant/smoothquant.
save_act_stats`). The port has no checkpoint loader or CLI yet (ROADMAP A
3), so the model is a named configuration with seeded random parameters
(`--net`, `--seed`) or a parameter npz of flattened `a/b/c` keys in JAX's
layout (`--params`, as `tools/tiny_llama_init.npz`), and the calibration
windows are `--nsamples` of `--seqlen` tokens drawn from the synthetic
tokenizer's encoding of `--text` (or uniform random ids without it):

    python -m llama3_quantization_tpu_torch.tools.generate_act_stats \\
        --net llama3-8b --num-layers 2 --nsamples 4 --out act_stats.npz      # on the card
    python -m llama3_quantization_tpu_torch.tools.generate_act_stats --device cpu \\
        --params llama3_quantization_tpu_torch/tools/tiny_llama_init.npz --net tiny-llama \\
        --nsamples 8 --seqlen 64 --out act_stats_tiny.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def calibration_tokens(vocab: int, nsamples: int, seqlen: int, seed: int, text=None):
    """[nsamples, seqlen] ids: windows of the synthetic tokenizer's encoding
    of `text`, at offsets from `seed`, or uniform random ids."""
    rng = np.random.default_rng(seed)
    if text is None:
        return rng.integers(0, vocab, (nsamples, seqlen))
    from ..eval.data import SyntheticTokenizer

    ids = np.asarray(SyntheticTokenizer().encode(text)) % vocab
    if len(ids) <= seqlen:
        raise ValueError(f"the text encodes to {len(ids)} tokens, fewer than seqlen {seqlen}")
    starts = rng.integers(0, len(ids) - seqlen, nsamples)
    return np.stack([ids[s : s + seqlen] for s in starts])


def main(argv=None):
    p = argparse.ArgumentParser("generate_act_stats")
    p.add_argument("--net", default="tiny-llama", help="a name of models.configs.NAMED_CONFIGS")
    p.add_argument("--params", default=None, help="parameter npz (flattened JAX layout)")
    p.add_argument("--num-layers", type=int, default=None, help="cut the depth (random params)")
    p.add_argument("--text", default=None, help="calibration text file")
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from ..models.configs import NAMED_CONFIGS
    from ..models.params import init_params
    from ..quant.smoothquant import collect_act_stats, save_act_stats

    cfg = NAMED_CONFIGS[args.net]
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    if args.params:
        from .reproduce_study import load_params_npz

        params = load_params_npz(args.params, args.device)
    else:
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        params = init_params(cfg, gen, dtype=getattr(torch, cfg.dtype), device=args.device)
    text = open(args.text).read() if args.text else None
    seqlen = min(args.seqlen, cfg.max_position_embeddings)
    calib = calibration_tokens(cfg.vocab_size, args.nsamples, seqlen, args.seed, text)
    stats = collect_act_stats(params, cfg, calib)
    save_act_stats(stats, args.out)
    print(f"wrote {args.out} ({cfg.num_layers} layers)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
