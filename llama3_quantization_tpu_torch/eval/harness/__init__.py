"""Task-evaluation harness (port of `llama3_quantization_tpu/eval/harness`).

The reference's request semantics (`loglikelihood`,
`loglikelihood_rolling`, `greedy_until`) and seeded doc sampling, over
`TorchLM`. The framework-free modules are copies of the JAX package's.
"""

from .base import (  # noqa: F401
    LM,
    MultipleChoiceTask,
    PerplexityTask,
    Request,
    Task,
    rf,
)
from .caching import CachingLM  # noqa: F401
from .evaluator import evaluate, make_table, pattern_match, simple_evaluate  # noqa: F401
from .lm import BaseLM, TorchLM  # noqa: F401
from .tasks import TASK_REGISTRY, get_task_dict  # noqa: F401
