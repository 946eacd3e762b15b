"""Task-evaluation harness (port of `llama3_quantization_tpu/eval/harness`).

The reference's request semantics (`loglikelihood`,
`loglikelihood_rolling`, `greedy_until`) and seeded doc sampling, over
`TorchLM` (and `Seq2SeqTorchLM` for the T5 trunk, outside `MODEL_REGISTRY`
as `Seq2SeqJAXLM` is outside JAX's). The framework-free modules are copies of the JAX package's.
"""

from .base import (  # noqa: F401
    LM,
    MultipleChoiceTask,
    PerplexityTask,
    Request,
    Task,
    rf,
)
from .lm import BaseLM, DummyLM, Seq2SeqTorchLM, TorchLM  # noqa: F401
from .models import GPT3LM, HFCausalLM, HFSeq2SeqLM, TextSynthLM  # noqa: F401
from .caching import CachingLM  # noqa: F401
from .evaluator import evaluate, make_table, pattern_match, simple_evaluate  # noqa: F401
from .tasks import TASK_REGISTRY, get_task_dict  # noqa: F401

#: pluggable LM adapters (`lm_eval/models/__init__.py MODEL_REGISTRY`): the
#: JAX package's keys, with "torch" (`TorchLM`) where it has "jax" (`JAXLM`)
MODEL_REGISTRY = {
    "torch": TorchLM,
    "dummy": DummyLM,
    "hf-causal": HFCausalLM,
    "gpt2": HFCausalLM,
    "hf-seq2seq": HFSeq2SeqLM,
    "gpt3": GPT3LM,
    "textsynth": TextSynthLM,
}


def get_model(name: str):
    return MODEL_REGISTRY[name]
