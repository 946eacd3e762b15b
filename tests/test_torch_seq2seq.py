"""Port parity: the T5 encoder-decoder trunk (`models/seq2seq.py`), its GPTQ
(`quant/seq2seq_calibration.py`), the API's and CLI's seq2seq branches,
`Seq2SeqTorchLM` and the study's `seq2seq_*` golden rows.

The cases of JAX's `tests/test_seq2seq.py` (but its mesh test, which waits
for ROADMAP A 5) run on the port: HF transformers parity for the v1.1
(gated-gelu, untied) and v1.0 (relu, tied) variants, greedy against HF
`generate`, RTN degrading with fewer bits, the LM's requests, the CLI's
RTN and GPTQ routes, the cached decode against the re-forward, GPTQ for
both MLPs and the API's refusal. Then the port against the JAX functions
on the same numpy inputs (weights carried by `convert.params_from_numpy`):

- relative-position bucket ids bit-equal for every rel in [-4096, 4096]
  at (32 buckets, 128) and (8, 32), both directions;
- RTN codes, scales and zeros bit-equal;
- `forward_logits_seq2seq`, the re-forward and cached streams and each
  `decode_step_seq2seq` under the "xla" backend on both sides: fp32 logits
  within XLA_TOL * max(1, max|ref|) (readings: at most 7.2e-7 of a max
  |logit| of 3.2), streams identical;
- the port's default "pallas" backend (B1's and B2's plain versions on the
  CPU) against JAX's Pallas kernels interpreted on the CPU: the same bound
  (readings: at most 9.5e-7), streams identical;
- GPTQ codes against JAX's at `tests/test_torch_gptq.py`'s bounds (codes
  agree on > 99%, scales within rtol 1e-4), and `split_calib_pairs`'
  quirk (a decoder stream without a start token) on both sides;
- `Seq2SeqTorchLM` against `Seq2SeqJAXLM` on the study's 27 requests:
  log-likelihoods within 1e-5 a token, greedy flags equal, `greedy_until`
  strings equal;
- `tiny_seq2seq_init.npz` equal to JAX's `init_seq2seq_params(PRNGKey(7))`,
  and the three `seq2seq_*` golden rows.
"""

import dataclasses
import json
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from llama3_quantization_tpu import api as japi
from llama3_quantization_tpu.eval.harness.lm import Seq2SeqJAXLM
from llama3_quantization_tpu.models import seq2seq as J
from llama3_quantization_tpu.ops import matmul as jmm
from llama3_quantization_tpu.quant import QuantSpec as JQS
from llama3_quantization_tpu.quant import seq2seq_calibration as JC
from llama3_quantization_tpu_torch import api, cli, convert
from llama3_quantization_tpu_torch.eval import data as tdata
from llama3_quantization_tpu_torch.eval.data import SyntheticTokenizer
from llama3_quantization_tpu_torch.eval.harness import Seq2SeqTorchLM, get_task_dict
from llama3_quantization_tpu_torch.models import seq2seq as T
from llama3_quantization_tpu_torch.ops import matmul as tmm
from llama3_quantization_tpu_torch.quant import seq2seq_calibration as TC
from llama3_quantization_tpu_torch.quant.qtensor import QuantizedTensor
from llama3_quantization_tpu_torch.quant.quantizer import QuantSpec
from llama3_quantization_tpu_torch.tools import reproduce_study as study

from test_torch_model import to_numpy_tree

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

#: the bound on fp32 logits against JAX's: XLA_TOL * max(1, max|ref|)
XLA_TOL = 1e-5


def _tiny_t5(tie=False, gated=True):
    cfg = transformers.T5Config(
        vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2,
        num_heads=4, relative_attention_num_buckets=8, relative_attention_max_distance=32,
        feed_forward_proj="gated-gelu" if gated else "relu", tie_word_embeddings=tie,
        decoder_start_token_id=0, pad_token_id=0, eos_token_id=1,
    )
    torch.manual_seed(0)
    return transformers.T5ForConditionalGeneration(cfg).eval().float()


def _hf_dir(tmp_path, tie=False, gated=True):
    model = _tiny_t5(tie=tie, gated=gated)
    model.save_pretrained(str(tmp_path))
    return model


def _tiny_cfgs(tie=False, gated=True):
    jc = J.Seq2SeqConfig(vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_heads=4, num_layers=2,
                         num_decoder_layers=2, rel_buckets=8, rel_max_distance=32,
                         gated_act=gated, tie_word_embeddings=tie)
    return jc, T.Seq2SeqConfig(**dataclasses.asdict(jc))


def _carry(jtree):
    return convert.params_from_numpy(to_numpy_tree(jtree), device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max())
    assert err <= XLA_TOL * max(1.0, float(np.abs(ref).max())), err


@pytest.fixture(autouse=True)
def _no_tokenizer(monkeypatch):
    """No test reaches a tokenizer: the HF directories here have none."""
    class NoTokenizer:
        def __init__(self, *a, **k):
            raise OSError("no tokenizer files in this directory")

    monkeypatch.setattr(tdata, "HFTokenizer", NoTokenizer)


# ---------------------------------------------- JAX's tests/test_seq2seq.py ----
@pytest.mark.parametrize("tie,gated", [(False, True), (True, False)])
def test_t5_hf_parity(tmp_path, tie, gated):
    """fp32 teacher-forced logits match HF transformers (v1.1 and v1.0), and
    the config read is JAX's."""
    model = _hf_dir(tmp_path, tie, gated)
    params, cfg = T.from_hf_seq2seq(str(tmp_path), device="cpu")
    assert cfg.gated_act == gated and cfg.tie_word_embeddings == tie
    assert dataclasses.asdict(cfg) == dataclasses.asdict(J.config_from_hf_seq2seq(str(tmp_path)))
    rng = np.random.default_rng(0)
    enc = rng.integers(2, cfg.vocab_size, (2, 12))
    enc[1, 9:] = 0  # padding on row 1 exercises the encoder mask
    dec = rng.integers(2, cfg.vocab_size, (2, 7))
    dec[:, 0] = cfg.decoder_start_token_id
    with torch.no_grad():
        ref = model(input_ids=_t(enc), attention_mask=_t((enc != 0).astype(np.int64)),
                    decoder_input_ids=_t(dec)).logits.numpy()
    ours = T.forward_logits_seq2seq(params, _t(enc), _t(dec), cfg).numpy()
    np.testing.assert_allclose(ours, ref, atol=3e-4, rtol=1e-3)


def test_t5_greedy_matches_hf_generate(tmp_path):
    model = _hf_dir(tmp_path)
    params, cfg = T.from_hf_seq2seq(str(tmp_path), device="cpu")
    enc = np.array([[5, 9, 17, 3, 2, 11]], np.int64)
    n = 6
    with torch.no_grad():
        ref = model.generate(input_ids=_t(enc), max_new_tokens=n, do_sample=False, num_beams=1,
                             eos_token_id=None, min_new_tokens=n).numpy()[0, 1:]
    ours = T.greedy_generate_seq2seq(params, _t(enc), n, cfg).numpy()[0]
    np.testing.assert_array_equal(ours, ref)


def test_t5_rtn_quantization_degrades_monotonically(tmp_path):
    _hf_dir(tmp_path)
    params, cfg = T.from_hf_seq2seq(str(tmp_path), device="cpu")
    rng = np.random.default_rng(1)
    enc = _t(rng.integers(2, cfg.vocab_size, (2, 10)))
    dec = _t(rng.integers(2, cfg.vocab_size, (2, 5)))
    fp = T.forward_logits_seq2seq(params, enc, dec, cfg)
    errs = []
    for bits in (8, 4, 2):
        qp = T.quantize_seq2seq_rtn(params, cfg, QuantSpec(n_bits=bits, group_size=8))
        errs.append(float((T.forward_logits_seq2seq(qp, enc, dec, cfg) - fp).abs().mean()))
    assert errs[0] < errs[1] < errs[2], errs


class _IdTok:
    """Tokenizer stub: strings are space-joined int ids."""

    def encode(self, s, add_special_tokens=False):
        return [int(x) for x in s.split()]

    def decode(self, toks):
        return " ".join(str(int(t)) for t in toks)


def test_seq2seq_torchlm_requests(tmp_path):
    """loglikelihood ranks the greedy continuation above an alternative, and
    greedy_until returns the greedy string."""
    _hf_dir(tmp_path)
    params, cfg = T.from_hf_seq2seq(str(tmp_path), device="cpu")
    lm = Seq2SeqTorchLM(params, cfg, _IdTok(), batch_size=4, max_length=32)
    ctx = "5 9 17 3"
    gen = T.greedy_generate_seq2seq(params, torch.tensor([[5, 9, 17, 3]]), 3, cfg)[0].tolist()
    best = " ".join(str(t) for t in gen)
    worse = " ".join(str((t + 7) % cfg.vocab_size) for t in gen)
    (ll_best, ok_best), (ll_worse, _) = lm.loglikelihood([(ctx, " " + best), (ctx, " " + worse)])
    assert ll_best > ll_worse
    assert ok_best
    out = lm.greedy_until([(ctx, ["zzz"])])[0]
    assert out.split()[:3] == best.split()[:3]
    with pytest.raises(NotImplementedError, match="seq2seq scores"):
        lm._score_tokens(None, None, None)


def test_cli_routes_t5_checkpoint(tmp_path, capsys):
    _hf_dir(tmp_path)
    cli.main(["--model", str(tmp_path), "--quant_method", "rtn", "--wbits", "4",
              "--group_size", "8", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "t5-seq2seq" in err
    assert "rtn W4 g8 applied (seq2seq)" in err


def test_cached_greedy_matches_reforward(tmp_path):
    for tie in (False, True):
        path = tmp_path / ("t" if tie else "u")
        _hf_dir(path, tie=tie)
        params, cfg = T.from_hf_seq2seq(str(path), device="cpu")
        enc = torch.tensor([[5, 9, 17, 3, 2, 11], [8, 4, 30, 0, 0, 0]])
        ref = T.greedy_generate_seq2seq(params, enc, 7, cfg)
        got = T.greedy_generate_seq2seq_cached(params, enc, 7, cfg)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("gated", [True, False])
def test_t5_gptq_quantization(tmp_path, gated):
    """Every block linear becomes a QuantizedTensor and W4 GPTQ beats W2 RTN."""
    _hf_dir(tmp_path, gated=gated)
    params, cfg = T.from_hf_seq2seq(str(tmp_path), device="cpu")
    rng = np.random.default_rng(2)
    calib = rng.integers(2, cfg.vocab_size, (4, 16))
    qp = api.quantize(params, cfg, method="gptq", spec=QuantSpec(n_bits=4, group_size=8),
                      calib_tokens=calib, batch_size=2)
    for side, names in (("enc", TC._enc_names(cfg)), ("dec", TC._dec_names(cfg))):
        for m in names:
            assert isinstance(qp[side]["layers"][m], QuantizedTensor), (side, m)
    enc = _t(rng.integers(2, cfg.vocab_size, (2, 10)))
    dec = _t(rng.integers(2, cfg.vocab_size, (2, 5)))
    fp = T.forward_logits_seq2seq(params, enc, dec, cfg)
    q4 = T.forward_logits_seq2seq(qp, enc, dec, cfg)
    assert bool(q4.isfinite().all())
    rp2 = T.quantize_seq2seq_rtn(params, cfg, QuantSpec(n_bits=2, group_size=8))
    err_rtn2 = float((T.forward_logits_seq2seq(rp2, enc, dec, cfg) - fp).abs().mean())
    assert float((q4 - fp).abs().mean()) < err_rtn2


def test_seq2seq_api_rejects_decoder_only_methods(tmp_path):
    _hf_dir(tmp_path)
    params, cfg = T.from_hf_seq2seq(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="seq2seq supports"):
        api.quantize(params, cfg, method="awq", spec=QuantSpec(4, 8),
                     calib_tokens=np.zeros((2, 8), np.int64))


def test_cli_seq2seq_gptq_route(tmp_path, capsys):
    _hf_dir(tmp_path)
    cli.main(["--model", str(tmp_path), "--quant_method", "gptq", "--wbits", "4",
              "--group_size", "8", "--calib_dataset", "synthetic", "--nsamples", "2",
              "--seqlen", "16", "--device", "cpu"])
    assert "gptq W4 g8 applied (seq2seq)" in capsys.readouterr().err


# ------------------------------------------------------ parity against JAX ----
def test_config_defaults_are_jaxs():
    assert dataclasses.asdict(T.Seq2SeqConfig()) == dataclasses.asdict(J.Seq2SeqConfig())


@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 32)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_bucket_ids_bit_equal(buckets, max_distance, bidirectional):
    rel = np.arange(-4096, 4097, dtype=np.int32)
    ref = np.asarray(J._relative_position_bucket(jnp.asarray(rel), bidirectional, buckets,
                                                 max_distance))
    got = T._relative_position_bucket(_t(rel), bidirectional, buckets, max_distance)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_position_bias_and_pad_mask_are_jaxs():
    jc, tc = _tiny_cfgs()
    emb = np.random.default_rng(5).normal(size=(8, 4)).astype(np.float32)
    for q, k, bi in ((12, 12, True), (7, 7, False), (1, 9, False)):
        np.testing.assert_array_equal(
            T._position_bias(_t(emb), q, k, bi, tc, torch.float32).numpy(),
            np.asarray(J._position_bias(jnp.asarray(emb), q, k, bi, jc, jnp.float32)))
    toks = np.array([[3, 0, 5], [0, 0, 1]])
    np.testing.assert_array_equal(T._pad_mask(_t(toks), 0).numpy(),
                                  np.asarray(J._pad_mask(jnp.asarray(toks), 0)))


@pytest.mark.parametrize("pack", [True, False])
def test_rtn_codes_bit_equal(pack):
    jc, tc = _tiny_cfgs()
    jp = J.init_seq2seq_params(jc, jax.random.PRNGKey(3))
    spec = dict(n_bits=4, group_size=8)
    ref = to_numpy_tree(J.quantize_seq2seq_rtn(jp, jc, JQS(**spec), pack=pack))
    got = T.quantize_seq2seq_rtn(_carry(jp), tc, QuantSpec(**spec), pack=pack)
    for side in ("enc", "dec"):
        for name, leaf in got[side]["layers"].items():
            r = ref[side]["layers"][name]
            if name.startswith("ln"):
                np.testing.assert_array_equal(leaf.numpy(), r)
                continue
            assert isinstance(leaf, QuantizedTensor) and (leaf.k, leaf.n) == (r["k"], r["n"])
            for field in ("data", "scale", "zero"):
                np.testing.assert_array_equal(getattr(leaf, field).numpy(), r[field],
                                              err_msg=f"{side}.{name}.{field}")
    assert "lm_head" in got and not isinstance(got["lm_head"], QuantizedTensor)


def _inputs():
    rng = np.random.default_rng(0)
    enc = rng.integers(2, 96, (2, 12))
    enc[1, 9:] = 0
    dec = rng.integers(2, 96, (2, 7))
    dec[:, 0] = 0
    return enc, dec


def _route_parity(route, tie, gated, quantized, n=6):
    jc, tc = _tiny_cfgs(tie, gated)
    jp = J.init_seq2seq_params(jc, jax.random.PRNGKey(3))
    if quantized:
        jp = J.quantize_seq2seq_rtn(jp, jc, JQS(n_bits=4, group_size=8))
    tp = _carry(jp)
    enc, dec = _inputs()
    with jmm.backend(route), pltpu.force_tpu_interpret_mode():
        ref = J.forward_logits_seq2seq(jp, jnp.asarray(enc), jnp.asarray(dec), jc)
        ref_cached = J.greedy_generate_seq2seq_cached(jp, jnp.asarray(enc), n, jc)
        ref_reforward = J.greedy_generate_seq2seq(jp, jnp.asarray(enc), n, jc)
    with tmm.backend(route):
        got = T.forward_logits_seq2seq(tp, _t(enc), _t(dec), tc)
        cached = T.greedy_generate_seq2seq_cached(tp, _t(enc), n, tc)
        reforward = T.greedy_generate_seq2seq(tp, _t(enc), n, tc)
    _close(got.numpy(), ref)
    np.testing.assert_array_equal(cached.numpy(), np.asarray(ref_cached))
    np.testing.assert_array_equal(reforward.numpy(), np.asarray(ref_reforward))
    return jp, tp, jc, tc, enc


@pytest.mark.parametrize("tie,gated", [(False, True), (True, False)])
@pytest.mark.parametrize("quantized", [False, True])
def test_xla_route_matches_jax(tie, gated, quantized):
    """Teacher-forced logits, both streams and each cached step under "xla"."""
    jp, tp, jc, tc, enc = _route_parity("xla", tie, gated, quantized)
    n = 5
    toks = np.random.default_rng(9).integers(2, 96, (2, n))
    js = J.init_seq2seq_state(jp, jnp.asarray(enc), n, jc)
    with tmm.backend("xla"):
        ts = T.init_seq2seq_state(tp, _t(enc), n, tc)
        for key in ("enc_h", "cross_k", "cross_v"):
            _close(ts[key].numpy(), js[key])
        for i in range(n):
            jl, js = J.decode_step_seq2seq(jp, js, jnp.asarray(toks[:, i : i + 1]), i, jc)
            tl, ts = T.decode_step_seq2seq(tp, ts, _t(toks[:, i : i + 1]), i, tc)
            _close(tl.numpy(), jl)
    _close(ts["self_k"].numpy(), js["self_k"])
    _close(ts["self_v"].numpy(), js["self_v"])


@pytest.mark.parametrize("tie,gated", [(False, True), (True, False)])
def test_pallas_plain_versions_match_jax_interpret(tie, gated):
    """The port's default backend on the CPU (B1's and B2's plain versions)
    against JAX's Pallas kernels interpreted, on RTN W4 g8 weights."""
    _route_parity("pallas", tie, gated, quantized=True)


def test_quantized_shared_is_refused_on_both_sides():
    jc, tc = _tiny_cfgs()
    jp = J.init_seq2seq_params(jc, jax.random.PRNGKey(3))
    tp = _carry(jp)
    from llama3_quantization_tpu.quant.qtensor import quantize_rtn as jq
    from llama3_quantization_tpu_torch.quant.qtensor import quantize_rtn as tq

    toks = np.array([[3, 4, 5]])
    with pytest.raises(ValueError, match="dense array"):
        J.encode(dict(jp, shared=jq(jp["shared"], JQS(4, 8))), jnp.asarray(toks), jc)
    with pytest.raises(ValueError, match="dense array"):
        T.encode(dict(tp, shared=tq(tp["shared"], QuantSpec(4, 8))), _t(toks), tc)


def test_init_params_tree_is_jaxs():
    for tie, gated in ((False, True), (True, False)):
        jc, tc = _tiny_cfgs(tie, gated)
        ref = to_numpy_tree(J.init_seq2seq_params(jc, jax.random.PRNGKey(0)))
        got = T.init_seq2seq_params(tc, torch.Generator().manual_seed(0), device="cpu")

        def walk(r, g, path=""):
            if isinstance(r, dict):
                assert set(r) == set(g), path
                for k in r:
                    walk(r[k], g[k], f"{path}/{k}")
            else:
                assert tuple(g.shape) == r.shape and g.dtype == torch.float32, path

        walk(ref, got)


@pytest.mark.parametrize("gated", [True, False])
def test_gptq_codes_match_jax(gated):
    jc, tc = _tiny_cfgs(gated=gated)
    jp = J.init_seq2seq_params(jc, jax.random.PRNGKey(3))
    calib = np.random.default_rng(2).integers(2, 96, (4, 16))
    spec = dict(n_bits=4, group_size=8)
    with jmm.backend("xla"):
        ref = to_numpy_tree(japi.quantize(jp, jc, "gptq", JQS(**spec), calib_tokens=calib,
                                          pack=False, batch_size=2))
    got = api.quantize(_carry(jp), tc, "gptq", QuantSpec(**spec), calib_tokens=calib,
                       pack=False, batch_size=2)
    for side, names in (("enc", TC._enc_names(tc)), ("dec", TC._dec_names(tc))):
        assert names == (JC._enc_names(jc) if side == "enc" else JC._dec_names(jc))
        for m in names:
            g, r = got[side]["layers"][m], ref[side]["layers"][m]
            agree = (g.data.numpy() == r["data"]).mean()
            assert agree > 0.99, (side, m, agree)
            np.testing.assert_allclose(g.scale.numpy(), r["scale"], rtol=1e-4, atol=1e-6)
    assert TC.seq2seq_capture_aliases(tc) == JC.seq2seq_capture_aliases(jc)


def test_split_calib_pairs_quirk_on_both_sides():
    """As in JAX, the decoder stream is the raw second half: no start token
    is prepended, though `gptq_quantize_seq2seq` documents start-shifted ids
    (ROADMAP C, reference quirks mirrored)."""
    calib = np.random.default_rng(4).integers(2, 96, (3, 15))
    for frac in (0.5, 0.3, 0.01):
        te, td = TC.split_calib_pairs(calib, frac)
        je, jd = JC.split_calib_pairs(calib, frac)
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(td, jd)
        cut = max(1, int(15 * frac))
        np.testing.assert_array_equal(td, calib[:, cut:])
        assert td.shape == (3, 15 - cut) and not (td[:, 0] == 0).any()


def _study_requests(tok):
    reqs = []
    for task in get_task_dict(["piqa", "arc_easy"], study.TASK_DATA).values():
        docs = task.test_docs() if task.has_test_docs() else task.validation_docs()
        for doc in docs:
            ctx = task.fewshot_context(doc, 0, random.Random(42))
            reqs += [r.args for r in task.construct_requests(doc, ctx)]
    return reqs


def test_torchlm_matches_seq2seq_jaxlm():
    """The study's tiny T5 (RTN W4 g8) on the 27 piqa / arc_easy requests
    under "xla", and greedy_until on two contexts."""
    tok = study.Tok(SyntheticTokenizer())
    tc = study.tiny_seq2seq_config(tok.vocab_size)
    jc = J.Seq2SeqConfig(**dataclasses.asdict(tc))
    jp = J.quantize_seq2seq_rtn(J.init_seq2seq_params(jc, jax.random.PRNGKey(7)), jc,
                                JQS(n_bits=4, group_size=8))
    tp = _carry(jp)
    reqs = _study_requests(tok)
    assert len(reqs) == 27
    jlm = Seq2SeqJAXLM(jp, jc, tok, batch_size=4, max_length=study.SEQLEN)
    with tmm.backend("xla"):
        tlm = Seq2SeqTorchLM(tp, tc, tok, batch_size=4, max_length=study.SEQLEN)
        got = tlm.loglikelihood(reqs)
        gen_reqs = [(reqs[0][0], ["\n"]), (reqs[-1][0] + reqs[-1][1], ["."])]
        tlm.max_gen_toks = jlm.max_gen_toks = 12
        tgen = tlm.greedy_until(gen_reqs)
    ref = jlm.loglikelihood(reqs)
    ntok = np.array([len(tok.encode(cont)) for _, cont in reqs])
    d = np.abs(np.array([g[0] for g in got]) - np.array([r[0] for r in ref])) / ntok
    assert d.max() <= 1e-5, d.max()
    assert [g[1] for g in got] == [r[1] for r in ref]
    assert tgen == jlm.greedy_until(gen_reqs)


def test_tiny_seq2seq_npz_is_jax_init():
    tok = SyntheticTokenizer()
    jc = J.Seq2SeqConfig(vocab_size=tok.vocab_size, d_model=32, d_kv=8, d_ff=64, num_heads=4,
                         num_layers=2, num_decoder_layers=2, rel_buckets=8)
    assert dataclasses.asdict(study.tiny_seq2seq_config(tok.vocab_size)) == dataclasses.asdict(jc)
    ref = to_numpy_tree(J.init_seq2seq_params(jc, jax.random.PRNGKey(7)))
    got = study.load_tiny_seq2seq_params("cpu")

    def walk(r, g, path=""):
        if isinstance(r, dict):
            assert set(r) == set(g), path
            for k in r:
                walk(r[k], g[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=path)

    walk(ref, got)


@pytest.fixture(scope="module")
def golden():
    with open(study.GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize("row", study.SEQ2SEQ_ROWS)
def test_seq2seq_golden_row(golden, row):
    table = study.run_study([row], device="cpu", verbose=False)
    assert set(table) == {row} and set(table[row]) == set(golden[row])
    assert study.golden_misses(table) == []
