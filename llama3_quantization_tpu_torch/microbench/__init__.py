"""Weight-stream microbenches of the port: one module per JAX probe script
(`scripts/microbench_*.py`), each with `main(argv)` taking that script's
positional arguments and defaults (Llama-3-8B widths), plus `--device`
(the card unless `--device cpu` is given) and, where the script times a
number of steps, `--steps`:

    python -m llama3_quantization_tpu_torch.microbench.w4_variants [K] [N] [BK] [BN] [variant...]
    python -m llama3_quantization_tpu_torch.microbench.w4_tiled [K] [N] [BK] [BN] [dma|bd4 ...]
    python -m llama3_quantization_tpu_torch.microbench.w4_multidma [K] [N] [BK] [BN] [S...]
    python -m llama3_quantization_tpu_torch.microbench.dma_depth [MB] [CHUNK_KB] [DEPTH...]
    python -m llama3_quantization_tpu_torch.microbench.w4_v4 [K] [N] [BK] [BN]
    python -m llama3_quantization_tpu_torch.microbench.unpack [K] [N] [reps]

They run kernels B8 (`ops/w4_stream.py`), B9 (`ops/w4_bd.py`) and B10
(`ops/qmm_u8.py`), and `unpack` also B1 and B3. Each prints the script's
lines (us/call, GB/s of packed bytes) and, on the card, the share of its
3.35 TB/s; `main` returns the seconds per call by variant.
"""

MODULES = ("w4_variants", "w4_tiled", "w4_multidma", "dma_depth", "w4_v4", "unpack")
