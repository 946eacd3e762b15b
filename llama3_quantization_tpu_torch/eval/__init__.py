"""Evaluation: data pipelines, perplexity, and the task harness (port of
`llama3_quantization_tpu/eval`)."""

from .data import ByteTokenizer, HFTokenizer, SyntheticTokenizer, bucket_pow2, get_loaders  # noqa: F401
from .ppl import compute_ppl, eval_ppl_suite, windowed_nll_fn  # noqa: F401
