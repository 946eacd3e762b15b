"""Port parity: B7's gradient (B7.stats, B7.dkv, B7.dq).

The port's plain versions (what its wrappers run on CPU tensors) against
the Pallas TPU library's own kernels, run interpreted on the CPU inside
`pltpu.force_tpu_interpret_mode()`: `attention_stats_plain` against
`_flash_attention(..., save_residuals=True)` (o, and the residuals l and
m), and `flash_attention_bwd_plain` against the VJP of the JAX package's
`_flash_attention` (`transformer.py:168-181`: the library's forward and its
`custom_vjp`, with K/V repeated per head and the repeat's transpose summing
dk/dv). fp32, S = 128 and 256, rep 2 and 3, D = 16: o, m, dq, dk and dv
within 1e-5, l (a sum of up to S terms near 1) within 1e-5 * max(1, l).
Gradients through the autograd Function (`flash_attention` with inputs
requiring grad) are the plain backward's, and agree with autograd through
the eager attention.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as LF

from llama3_quantization_tpu.models import TINY_LLAMA
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models.params import init_params
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.ops import flash_attention as fa
from llama3_quantization_tpu_torch.ops import launches

torch.set_num_threads(1)

B, G, D = 1, 2, 16


def _inputs(s, rep, seed):
    rng = np.random.default_rng(seed)
    h = G * rep
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, s, h, D), (B, s, G, D), (B, s, G, D), (B, s, h, D))]


@pytest.fixture(scope="module", params=[(128, 2), (256, 3)], ids=["S128-rep2", "S256-rep3"])
def case(request):
    """The library's forward with residuals and the JAX package's VJP, both
    interpreted, on one set of inputs."""
    s, rep = request.param
    q, k, v, do = _inputs(s, rep, s + rep)
    h = G * rep
    with pltpu.force_tpu_interpret_mode():
        qh = jnp.asarray(q).transpose(0, 2, 1, 3)
        kh, vh = (jnp.repeat(jnp.asarray(x).transpose(0, 2, 1, 3), rep, axis=1) for x in (k, v))
        bs = LF.BlockSizes.get_default(B, h, s, s, D)
        o, l, m = LF._flash_attention(qh, kh, vh, None, None, True, True, 1.0 / math.sqrt(D), bs,
                                      False)
        _, vjp = jax.vjp(lambda a, b, c: JT._flash_attention(a, b, c, TINY_LLAMA),
                         *(jnp.asarray(x) for x in (q, k, v)))
        grads = vjp(jnp.asarray(do))
    ref = {"o": np.asarray(o).transpose(0, 2, 1, 3), "l": np.asarray(l), "m": np.asarray(m),
           "dq": np.asarray(grads[0]), "dk": np.asarray(grads[1]), "dv": np.asarray(grads[2])}
    return (q, k, v, do), ref


def test_stats_match_the_library_forward(case):
    (q, k, v, _), ref = case
    o, m, l = fa.attention_stats_plain(*(torch.from_numpy(x) for x in (q, k, v)))
    assert m.shape == l.shape == ref["m"].shape and m.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), ref["o"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), ref["m"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), ref["l"], rtol=0,
                               atol=1e-5 * np.maximum(1.0, np.abs(ref["l"])).max())
    assert np.all(np.abs(l.numpy() - ref["l"]) <= 1e-5 * np.maximum(1.0, np.abs(ref["l"])))


def test_backward_matches_the_library_vjp(case):
    (q, k, v, do), ref = case
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, m, l = fa.attention_stats_plain(tq, tk, tv)
    dq, dk, dv = fa.flash_attention_bwd_plain(tq, tk, tv, o, tdo, m, l)
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert got.shape == ref[name].shape
        np.testing.assert_allclose(got.numpy(), ref[name], rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("s,rep", [(130, 2), (64, 3)])
def test_autograd_function_is_the_plain_backward(s, rep):
    """Gradients through `flash_attention` under autograd are exactly the
    plain backward's on the plain statistics, and within 1e-5 of autograd
    through the eager attention; without grad the route is unchanged."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(s, rep, 7))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    o, m, l = fa.attention_stats_plain(q, k, v)
    assert torch.equal(out.detach(), o)
    for g, r in zip(got, fa.flash_attention_bwd_plain(q, k, v, o, do, m, l)):
        assert torch.equal(g, r)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    eager = torch.autograd.grad(fa.attention_plain(*leaves), leaves, do)
    for g, r in zip(got, eager):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    with torch.no_grad():
        assert torch.equal(fa.flash_attention(q, k, v), fa.attention_plain(q, k, v))


def test_decoder_layer_grad_takes_the_eager_route_where_b7_does_not():
    """D = 16 (TINY_LLAMA): B7 turns the shape away under autograd too, and
    the layer's gradient flows through the eager attention (counted)."""
    cfg = tcfg.TINY_LLAMA
    gen = torch.Generator().manual_seed(0)
    params = TT._layer_params(init_params(cfg, gen, dtype=torch.float32, device="cpu")["layers"],
                              0)
    w = params["q"]["w"].clone().requires_grad_(True)
    params["q"] = {"w": w}
    h = torch.randn((1, 128, cfg.hidden_size), generator=gen)
    cos_sin = TT.rope_cos_sin(torch.arange(128)[None], cfg.head_dim_, cfg.rope_theta,
                              torch.float32, cfg.rope_scaling_)
    launches.reset()
    out = TT.decoder_layer(params, h, cfg, TT.NO_QUANT, cos_sin, fa.causal_mask(128))
    (g,) = torch.autograd.grad(out.square().mean(), [w])
    assert launches.COUNTS["B7.eager"] == 1 and bool(g.isfinite().all()) and float(g.abs().max()) > 0


def test_backward_wrapper_raises_on_its_predicate_and_device():
    q, kv = torch.randn(1, 8, 4, 16), torch.randn(1, 8, 2, 16)
    m = l = torch.ones(1, 4, 8)
    with pytest.raises(ValueError, match="b7_takes"):
        fa.flash_attention_bwd_cuda(q, kv, kv, q, q, m, l)
    with pytest.raises(ValueError, match="b7_takes"):
        fa.flash_attention_stats_cuda(q, kv, kv)
    q, kv = torch.randn(1, 8, 4, 64), torch.randn(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, kv, kv, q, q, m, l)
