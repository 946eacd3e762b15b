"""The gap between the kernel route and the xla route is the reference's
own.

The study's 27 piqa / arc_easy loglikelihood requests (zero-shot) on
TINY_LLAMA, RTN W4 g32 packed, fp32, scored under the "pallas" backend (the
fused dequant-matmul kernels: JAX's Pallas kernels interpreted on the CPU
inside `pltpu.force_tpu_interpret_mode()`, the port's plain versions of B1
and B2) and under "xla" (dequantize, then matmul), in JAX (`JAXLM`) and in
the port (`TorchLM`). Per continuation token, the port is within 1e-5 of
JAX on each route, so whatever separates the two routes (the kernels round
group scales and activations to bf16, the xla route dequantizes in fp32
once) is JAX's own gap, which the port reproduces.

One exception is allowed on the kernel route, and read: the kernels round
each activation to bf16, and where an fp32 input lies within an ulp or two
of a bf16 rounding tie, the two frameworks' fp32 sums in other orders
upstream (RMSNorm, attention) can put it on either side. One of the 27
requests does this here (1.1e-4 a token); scored alone, request 7 shows
the same in layer 0's gate/up input: every linear agrees within 2.4e-7 on
identical inputs, and the flipped element moves layer 0's output by 1e-3. So on the kernel route at most
MAX_FLIPS requests may exceed 1e-5 a token, each by no more than 2e-4.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from llama3_quantization_tpu.eval.harness import JAXLM
from llama3_quantization_tpu.models import TINY_LLAMA, init_params, quantize_model_rtn
from llama3_quantization_tpu.ops import matmul as jmm
from llama3_quantization_tpu.quant import QuantSpec
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.eval.data import SyntheticTokenizer
from llama3_quantization_tpu_torch.eval.harness import TorchLM, get_task_dict
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.ops import matmul as tmm
from llama3_quantization_tpu_torch.tools import reproduce_study as study

from test_torch_model import to_numpy_tree

torch.set_num_threads(1)


def _requests(tok):
    reqs = []
    for task in get_task_dict(["piqa", "arc_easy"], study.TASK_DATA).values():
        docs = task.test_docs() if task.has_test_docs() else task.validation_docs()
        for doc in docs:
            ctx = task.fewshot_context(doc, 0, random.Random(42))
            reqs += [r.args for r in task.construct_requests(doc, ctx)]
    return reqs


@pytest.fixture(scope="module")
def scored():
    params = init_params(TINY_LLAMA, jax.random.PRNGKey(0), dtype=jnp.float32)
    jq = quantize_model_rtn(params, TINY_LLAMA, QuantSpec(n_bits=4, group_size=32), pack=True)
    tq = convert.params_from_numpy(to_numpy_tree(jq), device="cpu")
    tok = study.Tok(SyntheticTokenizer())
    reqs = _requests(tok)
    ntok = np.array([len(tok.encode(cont)) for _, cont in reqs])
    out = {}
    for route in ("pallas", "xla"):
        with jmm.backend(route), pltpu.force_tpu_interpret_mode():
            jlm = JAXLM(jq, TINY_LLAMA, tok, batch_size=4, max_length=study.SEQLEN)
            out[("jax", route)] = np.array([ll for ll, _ in jlm.loglikelihood(reqs)])
        with tmm.backend(route), torch.inference_mode():
            tlm = TorchLM(tq, tcfg.TINY_LLAMA, tok, batch_size=4, max_length=study.SEQLEN,
                          device="cpu")
            out[("port", route)] = np.array([ll for ll, _ in tlm.loglikelihood(reqs)])
    return out, ntok


def test_the_study_has_27_requests(scored):
    out, ntok = scored
    assert len(ntok) == 27 and all(len(v) == 27 for v in out.values()) and ntok.min() >= 1


#: requests whose kernel-route log-likelihood may move by a bf16 rounding
#: flip of one activation (see the module docstring), and how far a token
MAX_FLIPS, FLIP_LIMIT = 2, 2e-4


def _within(per_token, route):
    over = per_token > 1e-5
    if route == "xla":
        return not over.any()
    return over.sum() <= MAX_FLIPS and per_token.max() <= FLIP_LIMIT


@pytest.mark.parametrize("route", ["pallas", "xla"])
def test_port_tracks_jax_on_each_route(scored, route):
    out, ntok = scored
    per_token = np.abs(out[("port", route)] - out[("jax", route)]) / ntok
    assert _within(per_token, route), per_token


def test_the_routes_gap_is_jax_s_own(scored):
    """The port's gap between the routes is JAX's, request by request, and
    larger than what separates the port from JAX on either route."""
    out, ntok = scored
    jgap = (out[("jax", "pallas")] - out[("jax", "xla")]) / ntok
    pgap = (out[("port", "pallas")] - out[("port", "xla")]) / ntok
    assert _within(np.abs(pgap - jgap), "pallas")
    assert np.median(np.abs(jgap)) > 10 * np.median(np.abs(pgap - jgap))
