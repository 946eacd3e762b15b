"""The plain reference against the port's forward at tiny shapes on the
CPU: the port in fp32 on the same seeded codes, under its "xla" backend
(dequantize, then an fp32 matmul: the kernels' plain versions round their
input to bf16, as the kernels do), so the two differ by the order of sums
alone."""

import numpy as np
import pytest
import torch

from llama3_quantization_tpu_torch.eval.ppl import windowed_nll_fn
from llama3_quantization_tpu_torch.models.transformer import forward_logits
from llama3_quantization_tpu_torch.ops.matmul import backend

from portbench import program
from portbench.reference.decoder import Reference
from portbench.tests.tiny import CONFIGS

SEQ = [16, 160]  # eager attention, and the flash route's length (S >= 128)


def _tokens(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg["model"]["vocab_size"], (2, s)))


@pytest.mark.parametrize("s", SEQ)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_logits_match_port(name, s):
    cfg = CONFIGS[name]
    params = program.build_params(cfg, 7, "cpu", dtype=torch.float32)
    toks = _tokens(cfg, s)
    with backend("xla"):
        got = forward_logits(params, toks, program.model_config(cfg)).float()
    ref = Reference(cfg, 7, "cpu")
    want = ref.logits(ref.hidden(toks))
    err = (got - want).abs().max().item() / want.abs().max().item()
    assert err < 1e-5, err


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_nll_matches_port_ppl_step(name):
    cfg = CONFIGS[name]
    params = program.build_params(cfg, 3, "cpu", dtype=torch.float32)
    toks = _tokens(cfg, 128, seed=1)[:1]
    with backend("xla"):
        nll = windowed_nll_fn(program.model_config(cfg), chunk=32)(params, toks).item() / 128
    want = Reference(cfg, 3, "cpu").mean_nll(toks).item()
    assert abs(nll - want) < 1e-5


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_sees_a_changed_weight(name):
    """A reference on another seed's weights reads far from the port."""
    cfg = CONFIGS[name]
    params = program.build_params(cfg, 7, "cpu", dtype=torch.float32)
    toks = _tokens(cfg, 16)
    with backend("xla"):
        got = forward_logits(params, toks, program.model_config(cfg)).float()
    ref = Reference(cfg, 8, "cpu")
    want = ref.logits(ref.hidden(toks))
    assert (got - want).abs().max().item() / want.abs().max().item() > 1e-2


def test_moe_routes_top_k_renormalised():
    """The reference's MoE against a hand-rolled top-2 mixture of the same
    experts on a few tokens."""
    cfg = CONFIGS["tiny-mixtral"]
    ref = Reference(cfg, 5, "cpu")
    from portbench import weights as W

    fp = W.layer_fp(cfg, 5, 0, "cpu")
    x = torch.randn(3, 1, cfg["model"]["hidden_size"])
    got = ref._mlp(x, 0, fp)
    codes = {n: W.quant_linear(cfg, 5, 0, n, "cpu") for n in ("gate", "up", "down")}
    want = torch.zeros_like(x)
    for t in range(3):
        probs = (x[t, 0] @ fp["router"].float()).softmax(-1)
        top = probs.topk(2)
        for p, e in zip(top.values / top.values.sum(), top.indices.tolist()):
            g, u, d = (W.dequant(*(c[e] for c in codes[n])) for n in ("gate", "up", "down"))
            want[t, 0] += p * ((torch.nn.functional.silu(x[t, 0] @ g) * (x[t, 0] @ u)) @ d)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
