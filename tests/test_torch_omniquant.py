"""Port parity: OmniQuant's block training (`quant/omniquant.py`), with the
LWC quantizer (`quant/quantizer.py`) and `utils/pytree_io.py`.

- `init_layer_lwc` / `init_layer_let` (with activation stats) equal JAX's.
- One training step's loss and LWC/LET gradients against `jax.value_and_grad`
  of JAX's block loss: within 1e-5 relative on the eager route at S = 64;
  at S = 128 on a llama of head dim 64 (which B7 takes) the port's step goes
  through B7's autograd Function (its plain versions here) and JAX's through
  the Pallas library's flash forward and `custom_vjp` under `set_flash(True)`
  inside `pltpu.force_tpu_interpret_mode()`: within 1e-4 relative.
- `omniquant_model(epochs=1)` (LWC, and LWC + LET with aug loss): its
  trained LWC parameters, read from the resume directories both write,
  within 1e-4 of JAX's, and its codes over 99% JAX's; `epochs=0` is RTN
  under the initial clipping; a resume directory JAX wrote is read back
  (no training: the same codes).
- The LWC `quantize_rtn` and `fake_quant_dynamic` match JAX's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.quant import QuantSpec as JSpec
from llama3_quantization_tpu.quant import calibration as JC
from llama3_quantization_tpu.quant import omniquant as JO
from llama3_quantization_tpu.quant import qtensor as JQT
from llama3_quantization_tpu.quant import quantizer as JQ
from llama3_quantization_tpu.quant import smoothquant as JSQ
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.models.params import linear_names
from llama3_quantization_tpu_torch.ops import launches
from llama3_quantization_tpu_torch.quant import calibration as TC
from llama3_quantization_tpu_torch.quant import omniquant as TO
from llama3_quantization_tpu_torch.quant import qtensor as TQT
from llama3_quantization_tpu_torch.quant import quantizer as TQ
from llama3_quantization_tpu_torch.quant import smoothquant as TSQ
from llama3_quantization_tpu_torch.utils import pytree_io

from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

SPEC = dict(n_bits=3, group_size=32, lwc=True)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _leaves(tree):
    return [x for k in sorted(tree) for x in
            (_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _close(got, ref, rel, what=""):
    """Every leaf of `got` within `rel` of the largest |leaf| of `ref` (a
    tree's gradient: a leaf whose own gradient is rounding noise, as the
    q <-> k pair scales' is, is held to the tree's scale)."""
    got, ref = _np(got), _np(ref)
    if not isinstance(ref, dict):
        got, ref = {"": got}, {"": ref}
    assert sorted(got) == sorted(ref), what
    scale = max(float(np.abs(x).max()) for x in _leaves(ref))
    for g, r in zip(_leaves(got), _leaves(ref)):
        assert g.shape == r.shape, what
        assert np.abs(g - r).max() <= rel * max(scale, 1e-30), what


def test_lwc_quantizer_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    up, low = (rng.standard_normal((48, 2, 1)).astype(np.float32) + 2 for _ in range(2))
    j = JQT.quantize_rtn(jnp.asarray(w), JSpec(n_bits=4, group_size=32, lwc=True),
                         lwc_up=jnp.asarray(up), lwc_low=jnp.asarray(low))
    t = TQT.quantize_rtn(torch.from_numpy(w), TQ.QuantSpec(n_bits=4, group_size=32, lwc=True),
                         lwc_up=torch.from_numpy(up), lwc_low=torch.from_numpy(low))
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale), rtol=1e-6)
    fj = JQ.fake_quant_dynamic(jnp.asarray(w.T), JSpec(n_bits=4, group_size=32, lwc=True),
                               jnp.asarray(up), jnp.asarray(low))
    ft = TQ.fake_quant_dynamic(torch.from_numpy(w.T.copy()), TQ.QuantSpec(n_bits=4, group_size=32,
                                                                          lwc=True),
                               torch.from_numpy(up), torch.from_numpy(low))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="lwc_up"):
        TQ.fake_quant_dynamic(torch.from_numpy(w), TQ.QuantSpec(n_bits=4, lwc=True))


def _models(cfg_j, cfg_t, seed=0):
    params = init_params(cfg_j, jax.random.PRNGKey(seed), dtype=jnp.float32)
    return params, convert.params_from_numpy(to_numpy_tree(params), device="cpu")


@pytest.fixture(scope="module")
def tiny():
    jp, tp = _models(TINY_LLAMA, tcfg.TINY_LLAMA)
    calib = np.random.default_rng(1).integers(0, TINY_LLAMA.vocab_size, (4, 64))
    return jp, tp, calib


def test_init_lwc_and_let_match_jax(tiny):
    jp, tp, calib = tiny
    jl, tl = JC._layer_slice(jp["layers"], 1), TC._layer_slice(tp["layers"], 1)
    _close(TO.init_layer_lwc(tl, tcfg.TINY_LLAMA, TQ.QuantSpec(**SPEC)),
           JO.init_layer_lwc(jl, TINY_LLAMA, JSpec(**SPEC)), 0)
    jstats = JSQ.collect_act_stats(jp, TINY_LLAMA, calib)
    tstats = TSQ.collect_act_stats(tp, tcfg.TINY_LLAMA, calib)
    _close(TO.init_layer_let(tl, tcfg.TINY_LLAMA, tstats[1]),
           JO.init_layer_let(jl, TINY_LLAMA, jstats[1]), 1e-5)
    _close(TO.init_layer_let(tl, tcfg.TINY_LLAMA), JO.init_layer_let(jl, TINY_LLAMA), 0)


def _step_inputs(jp, tp, cfg_j, cfg_t, s, let):
    """Layer 0, its LWC (and LET) aux moved off init, a batch of 2 random
    hidden states and a target."""
    rng = np.random.default_rng(s)
    jl, tl = JC._layer_slice(jp["layers"], 0), TC._layer_slice(tp["layers"], 0)
    aux = {"lwc": _np(JO.init_layer_lwc(jl, cfg_j, JSpec(**SPEC)))}
    if let:
        aux["let"] = _np(JO.init_layer_let(jl, cfg_j))
    aux = jax.tree_util.tree_map(
        lambda a: (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32), aux)
    h = rng.standard_normal((2, s, cfg_j.hidden_size)).astype(np.float32)
    target = rng.standard_normal((2, s, cfg_j.hidden_size)).astype(np.float32)
    return jl, tl, aux, h, target


def _jax_step(jl, aux, h, target, cfg_j, s, ocfg):
    positions = jnp.arange(s)[None, :]
    cos_sin = JT.rope_cos_sin(positions, cfg_j.head_dim_, cfg_j.rope_theta, jnp.float32,
                              cfg_j.rope_scaling_)
    mask = JT.causal_mask(s)

    def loss_fn(a):
        eff = JO.apply_let(jl, a["let"], cfg_j) if "let" in a else jl
        eff = JO.apply_lwc(eff, a["lwc"], cfg_j, ocfg.wspec)
        out = JT.decoder_layer(eff, jnp.asarray(h), cfg_j, JT.NO_QUANT, cos_sin, mask)[0]
        return jnp.mean((out - jnp.asarray(target)) ** 2)

    return jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, aux))


def _port_step(tl, aux, h, target, cfg_t, s, ocfg):
    cos_sin = TT.rope_cos_sin(torch.arange(s)[None, :], cfg_t.head_dim_, cfg_t.rope_theta,
                              torch.float32, cfg_t.rope_scaling_)
    taux = convert.params_from_numpy(aux, device="cpu")
    th, tt = torch.from_numpy(h), torch.from_numpy(target)
    return TO.omni_loss_and_grads(taux, tl, th, tt, tt, cfg_t, ocfg, TT.NO_QUANT, cos_sin,
                                  TT.causal_mask(s))


@pytest.mark.parametrize("let", [False, True])
def test_training_step_matches_jax_eager(tiny, let):
    jp, tp, _ = tiny
    jl, tl, aux, h, target = _step_inputs(jp, tp, TINY_LLAMA, tcfg.TINY_LLAMA, 64, let)
    jloss, jgrads = _jax_step(jl, aux, h, target, TINY_LLAMA, 64,
                              JO.OmniConfig(wspec=JSpec(**SPEC)))
    loss, grads = _port_step(tl, aux, h, target, tcfg.TINY_LLAMA, 64,
                             TO.OmniConfig(wspec=TQ.QuantSpec(**SPEC)))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _close(grads["lwc"], jgrads["lwc"], 1e-5, "lwc")
    if let:
        _close(grads["let"], jgrads["let"], 1e-5, "let")
        # the q <-> k pair scales leave q k^T, and so the loss, unchanged:
        # their gradient is rounding noise in both
        assert float(grads["let"]["qkt_scale"].abs().max()) < 1e-6 * float(loss)


def test_training_step_through_flash_matches_jax_flash():
    """S = 128, head dim 64: the port's B7 Function against the library's
    flash forward and custom_vjp, interpreted."""
    kw = dict(hidden_size=128, num_heads=2, num_kv_heads=1)
    cfg_j, cfg_t = dataclasses.replace(TINY_LLAMA, **kw), dataclasses.replace(tcfg.TINY_LLAMA, **kw)
    jp, tp = _models(cfg_j, cfg_t, seed=2)
    jl, tl, aux, h, target = _step_inputs(jp, tp, cfg_j, cfg_t, 128, False)
    JT.set_flash(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            jloss, jgrads = _jax_step(jl, aux, h, target, cfg_j, 128,
                                      JO.OmniConfig(wspec=JSpec(**SPEC)))
    finally:
        JT.set_flash("auto")
    launches.reset()
    loss, grads = _port_step(tl, aux, h, target, cfg_t, 128,
                             TO.OmniConfig(wspec=TQ.QuantSpec(**SPEC)))
    assert launches.COUNTS["B7.eager"] == 0
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    _close(grads["lwc"], jgrads["lwc"], 1e-4, "lwc")


def _aux_files(path, like, layers):
    return [pytree_io.load_pytree_npz(os.path.join(path, f"omni_layer_{l}.npz"), like)
            for l in range(layers)]


@pytest.mark.parametrize("let", [False, True])
def test_omniquant_model_matches_jax(tiny, tmp_path, let):
    jp, tp, calib = tiny
    kw = dict(epochs=1, batch_size=2, let=let, aug_loss=let)
    jq = JO.omniquant_model(jp, TINY_LLAMA, calib,
                            JO.OmniConfig(wspec=JSpec(**SPEC), resume_dir=str(tmp_path / "j"),
                                          **kw))
    tq = TO.omniquant_model(tp, tcfg.TINY_LLAMA, calib,
                            TO.OmniConfig(wspec=TQ.QuantSpec(**SPEC),
                                          resume_dir=str(tmp_path / "t"), **kw))
    tl = TC._layer_slice(tp["layers"], 0)
    like = {"lwc": TO.init_layer_lwc(tl, tcfg.TINY_LLAMA, TQ.QuantSpec(**SPEC))}
    if let:
        like["let"] = TO.init_layer_let(tl, tcfg.TINY_LLAMA)
    for jf, tf in zip(_aux_files(tmp_path / "j", like, 2), _aux_files(tmp_path / "t", like, 2)):
        for g, r in zip(_leaves(tf["lwc"]), _leaves(jf["lwc"])):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-4)
        if let:
            # Adam's first steps are +-lr for any gradient sign, so the pair
            # scales, whose gradient is rounding noise, go their own ways
            for key in ("qkv_scale", "fc1_scale", "out_scale"):
                np.testing.assert_allclose(tf["let"][key].numpy(), jf["let"][key].numpy(),
                                           rtol=0, atol=1e-4, err_msg=key)
    for name in linear_names(tcfg.TINY_LLAMA):
        agree = np.asarray(jq["layers"][name]["w"].data) == tq["layers"][name]["w"].data.numpy()
        assert agree.mean() > 0.99, name


def test_epochs0_is_rtn_and_resume_reads_jax(tiny, tmp_path):
    jp, tp, calib = tiny
    spec = TQ.QuantSpec(**SPEC)
    tq = TO.omniquant_model(tp, tcfg.TINY_LLAMA, calib, TO.OmniConfig(wspec=spec, epochs=0))
    for name in linear_names(tcfg.TINY_LLAMA):
        w = tp["layers"][name]["w"][1]
        init = TQ.lwc_init(tuple(w.T.shape), spec)
        ref = TQT.quantize_rtn(w, spec, lwc_up=init["up"], lwc_low=init["low"])
        assert torch.equal(tq["layers"][name]["w"].data[1], ref.data)
    # a resume directory JAX wrote: the port trains nothing and bakes JAX's aux
    jq = JO.omniquant_model(jp, TINY_LLAMA, calib,
                            JO.OmniConfig(wspec=JSpec(**SPEC), epochs=2, resume_dir=str(tmp_path)))
    tr = TO.omniquant_model(tp, tcfg.TINY_LLAMA, calib,
                            TO.OmniConfig(wspec=spec, epochs=50, resume_dir=str(tmp_path)))
    for name in linear_names(tcfg.TINY_LLAMA):
        agree = np.asarray(jq["layers"][name]["w"].data) == tr["layers"][name]["w"].data.numpy()
        assert agree.mean() > 0.99, name


def test_pytree_npz_round_trips_with_jax(tmp_path):
    from llama3_quantization_tpu.utils import pytree_io as jio

    rng = np.random.default_rng(3)
    tree = {"lwc": {"q": {"up": rng.standard_normal((4, 2, 1)).astype(np.float32),
                          "low": rng.standard_normal((4, 2, 1)).astype(np.float32)}},
            "let": {"qkv_scale": rng.standard_normal(8).astype(np.float32)}}
    jio.save_pytree_npz(str(tmp_path / "j.npz"), jax.tree_util.tree_map(jnp.asarray, tree))
    like = convert.params_from_numpy(jax.tree_util.tree_map(np.zeros_like, tree), device="cpu")
    back = pytree_io.load_pytree_npz(str(tmp_path / "j.npz"), like)
    _close(back, tree, 0)
    pytree_io.save_pytree_npz(str(tmp_path / "t.npz"), back)
    again = jio.load_pytree_npz(str(tmp_path / "t.npz"), jax.tree_util.tree_map(jnp.asarray, tree))
    _close(again, tree, 0)
