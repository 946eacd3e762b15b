"""Port parity: OPT and Falcon (`TINY_OPT`, `TINY_FALCON`).

Both packages run the same weights: JAX's `init_params` (PRNGKey 0, fp32)
with every norm weight and bias redrawn from numpy's `default_rng` (so
that LayerNorm's bias, OPT's linear biases and the learned positions all
carry values), carried into the port by `convert.params_from_numpy`.
Tolerances:

- fp32 forward and decode, fp weights: within 1e-5 of max|logit| of JAX's
  (the port under JAX's default "xla" backend), the decode also within JAX's
  own 2e-4 of the forward (`tests/test_models.py`);
- W4 g32 packed, the port's default kernel route (the plain versions on the
  CPU) against JAX's kernel route (`jax_kernel_route`): forward within 2e-2
  of max|logit| (tests/test_torch_model.py), greedy token streams on the
  int8 and fp caches identical, and OPT's int8 serving windows identical
  and windowed on both sides;
- integer codes exact (RTN, `recode_model_s8`); GPTQ, AWQ and OmniQuant
  codes agree on more than 99% of entries (tests/test_torch_gptq.py);
  SmoothQuant's weights within 1e-5 of their scale; HQQ and IR-QLoRA
  logits within 1e-4 and 1e-5 (tests/test_torch_hqq.py,
  tests/test_torch_nf4_irqlora.py);
- the loader's trees bit-equal to JAX's on Falcon HF directories written
  here (Falcon-7B's multi-query, Falcon-40B's grouped and RefinedWeb's
  interleaved layouts, `tests/test_io.py`; OPT's directories are in
  tests/test_torch_checkpoint.py);
- the calibration capture within 1e-5, with JAX's alias table.

Mirrored quirks (ROADMAP C): Falcon-7B's K = 4544 is no whole number of
128-groups, so RTN, GPTQ and HQQ raise JAX's ValueError at g128 (g64
quantizes, codes equal); AWQ has no `ln2` to fold into on Falcon's
parallel block, a KeyError in both packages.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import configs as JCF
from llama3_quantization_tpu.models import hf_loader as JL
from llama3_quantization_tpu.models import params as JP
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.quant import QuantSpec as JSpec
from llama3_quantization_tpu.quant import awq as JA
from llama3_quantization_tpu.quant import calibration as JC
from llama3_quantization_tpu.quant import gptq as JG
from llama3_quantization_tpu.quant import hqq as JH
from llama3_quantization_tpu.quant import irqlora as JI
from llama3_quantization_tpu.quant import omniquant as JO
from llama3_quantization_tpu.quant import qtensor as JQ
from llama3_quantization_tpu.quant import serving as JS
from llama3_quantization_tpu.quant import smoothquant as JSQ
from llama3_quantization_tpu.serving import ServingEngine as JEngine
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as TCF
from llama3_quantization_tpu_torch.models import hf_loader as TL
from llama3_quantization_tpu_torch.models import params as TP
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.models import windowed as TW
from llama3_quantization_tpu_torch.ops import matmul as mm
from llama3_quantization_tpu_torch.quant import awq as TA
from llama3_quantization_tpu_torch.quant import calibration as TC
from llama3_quantization_tpu_torch.quant import gptq as TG
from llama3_quantization_tpu_torch.quant import hqq as TH
from llama3_quantization_tpu_torch.quant import irqlora as TI
from llama3_quantization_tpu_torch.quant import omniquant as TO
from llama3_quantization_tpu_torch.quant import qtensor as TQ
from llama3_quantization_tpu_torch.quant import serving as TS
from llama3_quantization_tpu_torch.quant import smoothquant as TSQ
from llama3_quantization_tpu_torch.quant.quantizer import QuantSpec
from llama3_quantization_tpu_torch.serving import ServingEngine as TEngine

from test_torch_model import jax_kernel_route, to_numpy_tree  # noqa: F401  (fixture)

torch.set_num_threads(1)

ARCHS = ("opt", "falcon")
SPEC = dict(n_bits=4, group_size=32)


def configs(arch):
    name = {"opt": "tiny-opt", "falcon": "tiny-falcon", "mixtral": "tiny-mixtral",
            "llama": "tiny-llama"}[arch]
    return JCF.NAMED_CONFIGS[name], TCF.NAMED_CONFIGS[name]


def arch_trees(jcfg, seed=0):
    """(JAX params, port params, numpy tree): JAX's init with norm weights
    1 + 0.1 N(0, 1) and every bias 0.05 N(0, 1) from `default_rng(seed + 10)`."""
    tree = to_numpy_tree(JP.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jnp.float32))
    rng = np.random.default_rng(seed + 10)

    def redraw(node, norm=False):
        for key, val in node.items():
            if isinstance(val, dict):
                redraw(val, key.startswith("ln") or key == "norm")
            elif key == "b":
                node[key] = (0.05 * rng.standard_normal(val.shape)).astype(np.float32)
            elif norm and key == "w":
                node[key] = (1 + 0.1 * rng.standard_normal(val.shape)).astype(np.float32)

    redraw(tree)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_numpy(tree, device="cpu"), tree)


@pytest.fixture(scope="module")
def trees():
    return {arch: arch_trees(configs(arch)[0]) for arch in ARCHS}


def tokens(vocab, b=2, s=24, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def close_to_scale(got, ref, rel, what=""):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= rel * float(np.abs(ref).max()), (what, err, float(np.abs(ref).max()))


def codes_agree(jq, tq, names, floor=0.99):
    for name in names:
        agree = np.asarray(jq["layers"][name]["w"].data) == tq["layers"][name]["w"].data.numpy()
        assert agree.mean() > floor, (name, agree.mean())


# ---------------------------------------------------------------- models ----
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_and_forward_match_jax(trees, arch):
    jcfg, tcfg = configs(arch)
    jp, tp, _ = trees[arch]
    gen = torch.Generator().manual_seed(0)
    own = TP.init_params(tcfg, gen, dtype=torch.float32, device="cpu")
    shape = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shape(to_numpy_tree(jp)) == shape({k: v for k, v in _np_tree(own).items()})
    toks = tokens(jcfg.vocab_size)
    ref = np.asarray(JT.forward_logits(jp, jnp.asarray(toks), jcfg))
    with mm.backend("xla"):
        got = TT.forward_logits(tp, torch.from_numpy(toks), tcfg).numpy()
    close_to_scale(got, ref, 1e-5)
    assert got.shape == (2, 24, jcfg.vocab_size) and np.isfinite(got).all()


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_causality(trees, arch):
    """A changed last token changes only the last position's logits
    (`tests/test_models.py`)."""
    _, tcfg = configs(arch)
    _, tp, _ = trees[arch]
    toks = torch.from_numpy(tokens(tcfg.vocab_size))
    a = TT.forward_logits(tp, toks, tcfg)
    toks2 = toks.clone()
    toks2[:, -1] = (toks2[:, -1] + 1) % tcfg.vocab_size
    b = TT.forward_logits(tp, toks2, tcfg)
    torch.testing.assert_close(a[:, :-1], b[:, :-1], rtol=0, atol=1e-5)
    assert float((a[:, -1] - b[:, -1]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_and_jax(trees, arch):
    """Prefill 16 and 8 single steps into an fp32 cache: JAX's decode within
    1e-5 of scale, the port's forward within JAX's own 2e-4."""
    jcfg, tcfg = configs(arch)
    jp, tp, _ = trees[arch]
    toks = tokens(jcfg.vocab_size)
    full = TT.forward_logits(tp, torch.from_numpy(toks), tcfg).numpy()
    jc = JT.init_kv_cache(jcfg, 2, 32, dtype=jnp.float32)
    tc = TT.init_kv_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    jl, jc = JT.decode_step(jp, jc, jnp.asarray(toks[:, :16]), jnp.int32(0), jcfg)
    tl, tc = TT.decode_step(tp, tc, torch.from_numpy(toks[:, :16]), 0, tcfg)
    close_to_scale(tl.numpy(), jl, 1e-5)
    np.testing.assert_allclose(tl.numpy(), full[:, :16], rtol=2e-4, atol=2e-4)
    for i in range(16, 24):
        jl, jc = JT.decode_step(jp, jc, jnp.asarray(toks[:, i : i + 1]), jnp.int32(i), jcfg)
        tl, tc = TT.decode_step(tp, tc, torch.from_numpy(toks[:, i : i + 1]), i, tcfg)
        close_to_scale(tl.numpy(), jl, 1e-5)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, i], rtol=2e-4, atol=2e-4)


def test_opt_positions_clip_and_length_check(trees):
    """OPT's learned positions: a decode past the table clips (JAX
    mode="clip"); a sequence longer than max_position_embeddings raises."""
    jcfg, tcfg = configs("opt")
    jp, tp, _ = trees["opt"]
    pos = jcfg.max_position_embeddings + 5
    tok = np.array([[7]])
    ref = np.asarray(JT.embed(jp, jnp.asarray(tok), jcfg, jnp.asarray([[pos]])))
    got = TT.embed(tp, torch.from_numpy(tok), tcfg, torch.tensor([[pos]])).numpy()
    np.testing.assert_array_equal(got, ref)
    long = torch.zeros((1, tcfg.max_position_embeddings + 1), dtype=torch.long)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        TT.forward_logits(tp, long, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantization_degrades_monotonically_as_jax(trees, arch):
    """W8 < W4 < W2 mean |d logit| (`tests/test_models.py`), each within
    1e-4 of JAX's own."""
    jcfg, tcfg = configs(arch)
    jp, tp, _ = trees[arch]
    toks = tokens(jcfg.vocab_size)
    jfp = JT.forward_logits(jp, jnp.asarray(toks), jcfg)
    with mm.backend("xla"):
        tfp = TT.forward_logits(tp, torch.from_numpy(toks), tcfg)
    errs = []
    for bits in (8, 4, 2):
        jq = JP.quantize_model_rtn(jp, jcfg, JSpec(n_bits=bits, group_size=32), pack=True)
        tq = TP.quantize_model_rtn(tp, tcfg, QuantSpec(n_bits=bits, group_size=32), pack=True)
        for name in TP.linear_names(tcfg):
            np.testing.assert_array_equal(tq["layers"][name]["w"].data.numpy(),
                                          np.asarray(jq["layers"][name]["w"].data))
        jerr = float(jnp.mean(jnp.abs(JT.forward_logits(jq, jnp.asarray(toks), jcfg) - jfp)))
        with mm.backend("xla"):
            terr = float((TT.forward_logits(tq, torch.from_numpy(toks), tcfg) - tfp).abs().mean())
        assert abs(terr - jerr) <= 1e-4 * max(jerr, 1e-3), (bits, terr, jerr)
        errs.append(terr)
    assert errs[0] < errs[1] < errs[2] and errs[0] < 0.05


@pytest.fixture(scope="module")
def w4(trees):
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = configs(arch)
        jp, tp, _ = trees[arch]
        out[arch] = (JP.quantize_model_rtn(jp, jcfg, JSpec(**SPEC), pack=True),
                     TP.quantize_model_rtn(tp, tcfg, QuantSpec(**SPEC), pack=True))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_w4_forward_on_the_kernel_routes(w4, jax_kernel_route, arch):
    jcfg, tcfg = configs(arch)
    jq, tq = w4[arch]
    toks = tokens(jcfg.vocab_size, b=1, s=130)  # S >= 128: B7's route in the port
    ref = np.asarray(JT.forward_logits(jq, jnp.asarray(toks), jcfg))
    got = TT.forward_logits(tq, torch.from_numpy(toks), tcfg).float().numpy()
    close_to_scale(got, ref, 2e-2)


@pytest.mark.parametrize("arch,bits", [(a, b) for a in ARCHS for b in (8, False)])
def test_greedy_streams_match_jax(w4, jax_kernel_route, arch, bits):
    """12-token prefill, then 10 greedy steps: identical tokens on the int8
    and the fp cache (JAX's interpreted decode kernel against the port's
    B5 and B6 plain versions)."""
    jcfg, tcfg = configs(arch)
    jq, tq = w4[arch]
    toks = tokens(jcfg.vocab_size, b=2, s=12, seed=3)
    jc = JT.init_kv_cache(jcfg, 2, 64, dtype=jnp.float32, quantized=bits)
    tc = TT.init_kv_cache(tcfg, 2, 64, dtype=torch.float32, quantized=bits, device="cpu")
    jl, jc = JT.decode_step(jq, jc, jnp.asarray(toks), jnp.int32(0), jcfg)
    tl, tc = TT.decode_step(tq, tc, torch.from_numpy(toks), 0, tcfg)
    first = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
    assert np.array_equal(tl[:, -1].argmax(-1).numpy()[:, None], first)
    jout, _ = JT.greedy_generate(jq, jc, jnp.asarray(first), jnp.int32(12), 10, jcfg)
    tout, _ = TT.greedy_generate(tq, tc, torch.from_numpy(first), 12, 10, tcfg)
    assert tout.tolist() == np.asarray(jout).tolist()


def test_opt_int8_serving_is_windowed_on_both_sides(w4, jax_kernel_route, monkeypatch):
    """OPT's int8 engine windows (JAX's gate, `windowed.py:107`: no arch
    test): `step_n` windows of 4 give identical streams, and both engines
    went through `decode_window` (JAX's counted where the engine calls it)."""
    from llama3_quantization_tpu.models import windowed as JW

    jcfg, tcfg = configs("opt")
    jq, tq = w4["opt"]
    prompts, lens = [[3, 5, 7], [11, 2], list(range(1, 20))], [7, 3, 10]
    jwin = []
    orig = JW.decode_window
    monkeypatch.setattr(JW, "decode_window", lambda *a, **k: jwin.append(1) or orig(*a, **k))

    def drive(eng):
        rids = eng.add_requests([(p, n, None) for p, n in zip(prompts, lens)])
        eng.run(max_steps=50, step_tokens=4)
        return [list(eng.requests[r].generated) for r in rids]

    ref = drive(JEngine(jq, jcfg, max_slots=4, max_len=64, quantized_cache=8))
    teng = TEngine(tq, tcfg, max_slots=4, max_len=64, quantized_cache=8, device="cpu")
    assert TW.windowed_ok(tcfg, teng.cache)
    got = drive(teng)
    assert got == ref and [len(g) for g in got] == lens
    assert jwin and teng.dispatches["windowed"] > 0


# ------------------------------------------------------------ quantizers ----
@pytest.mark.parametrize("arch", ("llama", "opt", "falcon", "mixtral"))
def test_capture_and_aliases_match_jax(arch):
    """`layer_linear_inputs` within 1e-5 of JAX's, with JAX's alias table
    (`tests/test_gptq.py:436-460`)."""
    jcfg, tcfg = configs(arch)
    jp, tp, _ = arch_trees(jcfg)
    toks = tokens(jcfg.vocab_size, s=16)
    jh, jcs, jmask = JC.embed_calibration(jp, jcfg, jnp.asarray(toks))
    th, tcs, tmask = TC.embed_calibration(tp, tcfg, torch.from_numpy(toks))
    jcaps = JC.layer_linear_inputs(JC._layer_slice(jp["layers"], 0), jh, jcfg, JT.NO_QUANT, jcs,
                                   jmask)
    tcaps = TC.layer_linear_inputs(TC._layer_slice(tp["layers"], 0), th, tcfg, TT.NO_QUANT, tcs,
                                   tmask)
    assert sorted(tcaps) == sorted(jcaps)
    for key in jcaps:
        close_to_scale(tcaps[key].numpy(), jcaps[key], 1e-5, key)
    assert TC.capture_aliases(tcfg) == JC.capture_aliases(jcfg)
    for alias, canon in TC.capture_aliases(tcfg).items():
        if alias in tcaps:
            assert tcaps[alias] is tcaps[canon]


def _calib(vocab, n=4, s=16):
    return np.random.default_rng(1).integers(0, vocab, (n, s))


@pytest.mark.parametrize("arch,true_seq", [("opt", False), ("opt", True), ("falcon", False)])
def test_gptq_matches_jax(trees, arch, true_seq):
    """8 x 64 calibration tokens, more than fc2's K = 256, so every Hessian
    has full rank. (On 64 tokens Falcon's rank-deficient fc2 Hessian turns
    the packages' fp32 rounding, 1.7e-7 of its scale, into 0.2% of layer
    0's fc2 codes, which layer 1's inputs then carry; on one Hessian the
    two solves give equal codes, `test_gptq_solve_on_one_hessian_is_jaxs`.)"""
    jcfg, tcfg = configs(arch)
    jp, tp, _ = trees[arch]
    calib = _calib(jcfg.vocab_size, n=8, s=64)
    jq = JC.gptq_quantize_model(jp, jcfg, calib, JSpec(**SPEC), blocksize=32,
                                true_sequential=true_seq)
    tq = TC.gptq_quantize_model(tp, tcfg, calib, QuantSpec(**SPEC), blocksize=32,
                                true_sequential=true_seq)
    codes_agree(jq, tq, TP.linear_names(tcfg))


def test_gptq_solve_on_one_hessian_is_jaxs(trees):
    """Falcon's layer-0 fc2 on a rank-deficient Hessian (64 tokens), JAX's
    own: the port's codes and loss are JAX's."""
    jcfg, _ = configs("falcon")
    jp, tp, _ = trees["falcon"]
    jh, jcs, jm = JC.embed_calibration(jp, jcfg, jnp.asarray(_calib(jcfg.vocab_size)))
    jl = JC._layer_slice(jp["layers"], 0)
    x = JC.layer_linear_inputs(jl, jh, jcfg, JT.NO_QUANT, jcs, jm)["fc2"]
    H = JG.hessian_update(JG.hessian_init(x.shape[-1]), x).H
    jqt, jerr = JG.gptq_quantize_weight(jl["fc2"]["w"], H, JSpec(**SPEC), blocksize=32)
    tqt, terr = TG.gptq_quantize_weight(TC._layer_slice(tp["layers"], 0)["fc2"]["w"],
                                        torch.from_numpy(np.array(H)), QuantSpec(**SPEC),
                                        blocksize=32)
    np.testing.assert_array_equal(tqt.data.numpy(), np.asarray(jqt.data))
    assert abs(float(terr) - float(jerr)) <= 1e-5 * abs(float(jerr))


def test_awq_matches_jax_on_opt(trees):
    jcfg, tcfg = configs("opt")
    jp, tp, _ = trees["opt"]
    calib = _calib(jcfg.vocab_size)
    jq = JA.awq_quantize_model(jp, jcfg, calib, JSpec(**SPEC), n_grid=6, sample_tokens=64)
    tq = TA.awq_quantize_model(tp, tcfg, calib, QuantSpec(**SPEC), n_grid=6, sample_tokens=64)
    for name in ("ln1", "ln2"):
        for key in ("w", "b"):
            np.testing.assert_allclose(tq["layers"][name][key].numpy(),
                                       np.asarray(jq["layers"][name][key]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name}.{key}")
    codes_agree(jq, tq, TP.linear_names(tcfg))


def test_awq_falcon_has_no_ln2_in_either_package(trees):
    """Mirrored quirk: Falcon's parallel block has one shared norm, and
    AWQ's second fold reads `ln2` (`awq.py:128`)."""
    jcfg, tcfg = configs("falcon")
    jp, tp, _ = trees["falcon"]
    calib = _calib(jcfg.vocab_size, n=2)
    with pytest.raises(KeyError, match="ln2"):
        JA.awq_quantize_model(jp, jcfg, calib, JSpec(**SPEC), n_grid=2, sample_tokens=16)
    with pytest.raises(KeyError, match="ln2"):
        TA.awq_quantize_model(tp, tcfg, calib, QuantSpec(**SPEC), n_grid=2, sample_tokens=16)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoothquant_matches_jax_and_is_fp_neutral(trees, arch):
    """OPT folds with shifts (the reference's default), Falcon's shared norm
    folds into q/k/v and fc1 at once (`smoothquant.py:139-148`)."""
    jcfg, tcfg = configs(arch)
    jp, tp, _ = trees[arch]
    calib = _calib(jcfg.vocab_size)
    js = JSQ.smoothquant_model(jp, jcfg, calib, alpha=0.5)
    ts = TSQ.smoothquant_model(tp, tcfg, calib, alpha=0.5)
    for (path, ref), got in zip(jax.tree_util.tree_leaves_with_path(js["layers"]),
                                jax.tree_util.tree_leaves(_np_tree(ts["layers"]))):
        close_to_scale(got, ref, 1e-5, jax.tree_util.keystr(path))
    toks = torch.from_numpy(calib[:2])
    ref = TT.forward_logits(tp, toks, tcfg).numpy()
    np.testing.assert_allclose(TT.forward_logits(ts, toks, tcfg).numpy(), ref, rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_omniquant_let_matches_jax(trees, tmp_path, arch):
    """One epoch of LWC + LET (`tests/test_torch_omniquant.py`'s bounds): the
    clipping logits and the LET scales within 1e-4 of JAX's, > 99% of the
    codes equal."""
    from llama3_quantization_tpu.utils import pytree_io as jio

    jcfg, tcfg = configs(arch)
    jp, tp, _ = trees[arch]
    calib = _calib(jcfg.vocab_size, n=2)
    kw = dict(epochs=1, batch_size=2, let=True)
    jq = JO.omniquant_model(jp, jcfg, calib, JO.OmniConfig(
        wspec=JSpec(**SPEC), resume_dir=str(tmp_path / "j"), **kw))
    tq = TO.omniquant_model(tp, tcfg, calib, TO.OmniConfig(
        wspec=QuantSpec(**SPEC), resume_dir=str(tmp_path / "t"), **kw))
    jl = JC._layer_slice(jp["layers"], 0)
    like = {"lwc": JO.init_layer_lwc(jl, jcfg, JSpec(**SPEC)), "let": JO.init_layer_let(jl, jcfg)}
    for l in range(jcfg.num_layers):
        jf = jio.load_pytree_npz(str(tmp_path / "j" / f"omni_layer_{l}.npz"), like)
        tf = jio.load_pytree_npz(str(tmp_path / "t" / f"omni_layer_{l}.npz"), like)
        for g, r in zip(jax.tree_util.tree_leaves(tf["lwc"]), jax.tree_util.tree_leaves(jf["lwc"])):
            np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=0, atol=1e-4)
        for key in ("qkv_scale", "fc1_scale", "out_scale"):
            np.testing.assert_allclose(np.asarray(tf["let"][key]), np.asarray(jf["let"][key]),
                                       rtol=0, atol=1e-4, err_msg=f"{l} {key}")
    codes_agree(jq, tq, TP.linear_names(tcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_let_fold_with_shifts_matches_jax(trees, arch):
    """The LET parameters with channel shifts (OPT and Falcon under
    activation quantization, `omniquant.py:67-141`): JAX's keys; random
    scales and shifts fold as JAX folds them (1e-6 of each leaf's scale) and
    leave the fp layer's output unchanged (2e-4, `tests/test_moe.py`)."""
    jcfg, tcfg = configs(arch)
    jp, tp, _ = trees[arch]
    jl, tl = JC._layer_slice(jp["layers"], 0), TC._layer_slice(tp["layers"], 0)
    jlet = JO.init_layer_let(jl, jcfg, use_shift=True)
    tlet = TO.init_layer_let(tl, tcfg, use_shift=True)
    assert sorted(tlet) == sorted(jlet) and "fc1_shift" in tlet
    rng = np.random.default_rng(7)
    vals = {k: (np.exp(0.3 * rng.standard_normal(v.shape)) if "scale" in k
                else 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in jlet.items()}
    jf = JO.apply_let(jl, {k: jnp.asarray(v) for k, v in vals.items()}, jcfg)
    tf = TO.apply_let(tl, {k: torch.from_numpy(v) for k, v in vals.items()}, tcfg)
    for (path, ref), got in zip(jax.tree_util.tree_leaves_with_path(jf),
                                jax.tree_util.tree_leaves(_np_tree(tf))):
        close_to_scale(got, ref, 1e-6, jax.tree_util.keystr(path))
    toks = torch.from_numpy(tokens(tcfg.vocab_size, s=8))
    h, cos_sin, mask = TC.embed_calibration(tp, tcfg, toks)
    base = TT.decoder_layer(tl, h, tcfg, TT.NO_QUANT, cos_sin, mask)
    close_to_scale(TT.decoder_layer(tf, h, tcfg, TT.NO_QUANT, cos_sin, mask), base, 2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_hqq_irqlora_and_recode_match_jax(trees, arch):
    jcfg, tcfg = configs(arch)
    jp, tp, _ = trees[arch]
    toks = tokens(jcfg.vocab_size, s=16)
    jh = JH.hqq_quantize_model(jp, jcfg, JSpec(**SPEC), iters=5, pack=True)
    th = TH.hqq_quantize_model(tp, tcfg, QuantSpec(**SPEC), iters=5, pack=True)
    ref = np.asarray(JT.forward_logits(jh, jnp.asarray(toks), jcfg))
    with mm.backend("xla"):
        got = TT.forward_logits(th, torch.from_numpy(toks), tcfg).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    ji = JI.irqlora_quantize_model(jp, jcfg, tau_n=4, blocksize2=4)
    ti = TI.irqlora_quantize_model(tp, tcfg, tau_n=4, blocksize2=4)
    ref = np.asarray(JT.forward_logits(ji, jnp.asarray(toks), jcfg))
    np.testing.assert_allclose(TT.forward_logits(ti, torch.from_numpy(toks), tcfg).numpy(), ref,
                               rtol=0, atol=1e-5)
    jr = JS.recode_model_s8(JP.quantize_model_rtn(jp, jcfg, JSpec(**SPEC)), jcfg)
    tr = TS.recode_model_s8(TP.quantize_model_rtn(tp, tcfg, QuantSpec(**SPEC)), tcfg)
    for name in TP.linear_names(tcfg):
        np.testing.assert_array_equal(tr["layers"][name]["w"].data.numpy(),
                                      np.asarray(jr["layers"][name]["w"].data))
        np.testing.assert_array_equal(tr["layers"][name]["w"].scale.numpy(),
                                      np.asarray(jr["layers"][name]["w"].scale))


def test_falcon7b_k_refuses_g128_and_quantizes_at_g64():
    """Mirrored quirk: Falcon-7B's K = 4544 = 71 x 64 (its k/v weight
    [4544, 64] here) raises JAX's ValueError at g128 in RTN, GPTQ and HQQ;
    at g64 the RTN codes are equal."""
    w = np.random.default_rng(5).standard_normal((4544, 64)).astype(np.float32)
    h = np.eye(4544, dtype=np.float32)
    for gs in (128,):
        calls = (
            (lambda: JQ.quantize_rtn(jnp.asarray(w), JSpec(n_bits=4, group_size=gs)),
             lambda: TQ.quantize_rtn(torch.from_numpy(w), QuantSpec(n_bits=4, group_size=gs))),
            (lambda: JG.gptq_quantize_weight(jnp.asarray(w), jnp.asarray(h),
                                             JSpec(n_bits=4, group_size=gs)),
             lambda: TG.gptq_quantize_weight(torch.from_numpy(w), torch.from_numpy(h),
                                             QuantSpec(n_bits=4, group_size=gs))),
            (lambda: JH.hqq_quantize_weight(jnp.asarray(w), JSpec(n_bits=4, group_size=gs)),
             lambda: TH.hqq_quantize_weight(torch.from_numpy(w),
                                            QuantSpec(n_bits=4, group_size=gs))),
        )
        for jcall, tcall in calls:
            for call in (jcall, tcall):
                with pytest.raises(ValueError, match="K=4544 not divisible by group_size=128"):
                    call()
    jq = JQ.quantize_rtn(jnp.asarray(w), JSpec(n_bits=4, group_size=64), pack=True)
    tq = TQ.quantize_rtn(torch.from_numpy(w), QuantSpec(n_bits=4, group_size=64), pack=True)
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))


# ---------------------------------------------------------------- loader ----
def _trees_equal(got, ref, path=""):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            _trees_equal(got[k], ref[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32),
                                  err_msg=path)


def _falcon_dir(path, cfg, layout):
    """A Falcon HF directory (`tests/test_io.py:125-260`): "multi_query"
    (Falcon-7B), "new_decoder" (Falcon-40B: grouped QKV rows, ln_attn and
    ln_mlp) or "mha" (RefinedWeb's per-head interleaved rows)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    d, hd, h, hkv = cfg.hidden_size, cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads

    def n(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    tensors = {"transformer.word_embeddings.weight": n(cfg.vocab_size, d, s=0.02),
               "transformer.ln_f.weight": 1 + n(d), "transformer.ln_f.bias": n(d),
               "lm_head.weight": n(cfg.vocab_size, d, s=0.02)}
    norms = ("ln_attn", "ln_mlp") if layout == "new_decoder" else ("input_layernorm",)
    for l in range(cfg.num_layers):
        p = f"transformer.h.{l}"
        for name in norms:
            tensors[f"{p}.{name}.weight"], tensors[f"{p}.{name}.bias"] = 1 + n(d), n(d)
        tensors.update({
            f"{p}.self_attention.query_key_value.weight": n((h + 2 * hkv) * hd, d),
            f"{p}.self_attention.dense.weight": n(d, h * hd),
            f"{p}.mlp.dense_h_to_4h.weight": n(cfg.intermediate_size, d),
            f"{p}.mlp.dense_4h_to_h.weight": n(d, cfg.intermediate_size),
        })
    path.mkdir()
    save_file(tensors, str(path / "model.safetensors"))
    config = {"model_type": "falcon", "vocab_size": cfg.vocab_size, "hidden_size": d,
              "num_hidden_layers": cfg.num_layers, "num_attention_heads": h,
              "parallel_attn": True, "max_position_embeddings": cfg.max_position_embeddings}
    config.update({
        "multi_query": {"multi_query": True},
        "new_decoder": {"n_head_kv": hkv, "multi_query": False, "new_decoder_architecture": True},
        "mha": {"model_type": "RefinedWeb", "multi_query": False},
    }[layout])
    (path / "config.json").write_text(json.dumps(config))


@pytest.mark.parametrize("layout,kv", [("multi_query", 1), ("new_decoder", 2), ("mha", 4)])
def test_falcon_hf_dirs_load_as_jax(tmp_path, layout, kv):
    """`_split_falcon_qkv`'s three layouts and `_falcon_layers`: the tree
    bit-equal to JAX's, `ln2` only from Falcon-40B's ln_mlp, the forward
    within 1e-5 of JAX's."""
    import dataclasses

    jcfg, _ = configs("falcon")
    cfg = dataclasses.replace(jcfg, num_kv_heads=kv)
    _falcon_dir(tmp_path / "hf", cfg, layout)
    jp, jc = JL.from_hf_checkpoint(str(tmp_path / "hf"), dtype=jnp.float32)
    tp, tc = TL.from_hf_checkpoint(str(tmp_path / "hf"), dtype=torch.float32, device="cpu")
    assert (tc.arch, tc.num_kv_heads, tc.parallel_block) == ("falcon", kv, True)
    assert jc.num_kv_heads == kv and ("ln2" in tp["layers"]) == (layout == "new_decoder")
    _trees_equal(tp, jp)
    toks = tokens(cfg.vocab_size, s=8)
    ref = np.asarray(JT.forward_logits(jp, jnp.asarray(toks), jc))
    close_to_scale(TT.forward_logits(tp, torch.from_numpy(toks), tc).numpy(), ref, 1e-5)


def test_save_hf_refuses_falcon_and_mixtral_as_jax(tmp_path, trees):
    _, tp, _ = trees["falcon"]
    for arch in ("falcon", "mixtral"):
        jcfg, tcfg = configs(arch)
        with pytest.raises(NotImplementedError, match=arch):
            JL.save_hf_checkpoint({}, jcfg, str(tmp_path / "j"))
        with pytest.raises(NotImplementedError, match=arch):
            TL.save_hf_checkpoint(tp, tcfg, str(tmp_path / "t"))
