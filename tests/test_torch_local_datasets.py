"""Port parity: the offline raw-file loaders (`eval/harness/local_datasets.py`).

Each test of the JAX package's `tests/test_local_datasets.py` runs as
written, over the raw files it writes, with every loader call answered by
both packages' loaders (their outputs equal) and every `simple_evaluate`
run by both packages on their own `DummyLM` (results equal).
"""

import types

import pytest
import torch

import test_local_datasets as JLD
from llama3_quantization_tpu.eval.harness import local_datasets as jlds
from llama3_quantization_tpu_torch.eval.harness import local_datasets as tlds
from test_torch_tasks import evaluate_both

torch.set_num_threads(1)

JAX_TESTS = sorted(n for n in vars(JLD) if n.startswith("test_"))


class BothLoaders:
    """`local_datasets` of both packages: a loader call returns JAX's output
    after checking the port's is equal; `LOADERS` maps the same names to the
    same loaders."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        ref, got = getattr(jlds, name), getattr(tlds, name)
        if name == "LOADERS":
            assert list(got) == list(ref)
            assert [f.__name__ for f in got.values()] == [f.__name__ for f in ref.values()]
            return ref
        assert callable(ref) and got.__name__ == ref.__name__

        def call(*a, **k):
            want = ref(*a, **k)
            assert got(*a, **k) == want, name
            self.called.append(name)
            return want

        return call


def test_covers_every_jax_test_and_loader():
    assert len(JAX_TESTS) == 12
    assert sorted(n for n in vars(tlds) if n.startswith("load_")) == sorted(
        n for n in vars(jlds) if n.startswith("load_"))


@pytest.mark.parametrize("name", JAX_TESTS)
def test_jax_loader_test_runs_on_both(name, tmp_path):
    fn = getattr(JLD, name)
    both = BothLoaders()
    env = dict(fn.__globals__, lds=both, simple_evaluate=evaluate_both)
    args = [tmp_path] if fn.__code__.co_argcount else []
    types.FunctionType(fn.__code__, env, name)(*args)
    assert both.called or name == "test_loader_registry_covers_builder_families"
