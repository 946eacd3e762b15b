"""The port stands alone: it imports neither JAX nor the JAX package (a
forward, serving engines on the int4 and the default fp cache, the W·A8
backends, sampled and speculative decoding, a hooked decode, the decode
routes and a microbench entry point run with both blocked), and an entry
point called
without `device` on a machine without CUDA raises instead of running on
the CPU."""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "llama3_quantization_tpu_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|llama3_quantization_tpu)\b", re.M)


def test_no_jax_import_in_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_port_runs_with_jax_blocked():
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["llama3_quantization_tpu"] = None
        import torch
        torch.set_num_threads(1)
        import llama3_quantization_tpu_torch as P

        cfg = P.TINY_LLAMA
        gen = torch.Generator().manual_seed(0)
        params = P.init_params(cfg, gen, dtype=torch.float32, device="cpu")
        params = P.quantize_model_rtn(params, cfg, P.QuantSpec(n_bits=4, group_size=32), pack=True)
        toks = torch.randint(0, cfg.vocab_size, (1, 12), generator=gen)
        logits = P.forward_logits(params, toks, cfg)
        assert logits.shape == (1, 12, cfg.vocab_size) and bool(logits.isfinite().all())
        from llama3_quantization_tpu_torch.models import windowed
        from llama3_quantization_tpu_torch.serving import ServingEngine
        eng = ServingEngine(params, cfg, max_slots=2, max_len=64, quantized_cache=4, device="cpu")
        eng.submit([1, 2, 3], 6)
        eng.submit([4, 5], 9)
        eng.run_pipelined(4)
        assert sorted(len(r.generated) for r in eng.requests.values()) == [6, 9]
        assert eng.dispatches["windowed"] > 0 and windowed.windowed_ok(cfg, eng.cache)
        # the W·A8 backends: s4 decode on fused weights, a8 serving on recodes
        with P.backend("s4"):
            fused = P.fuse_for_decode(params, cfg)
            cache = P.init_kv_cache(cfg, 1, 32, quantized=8, device="cpu")
            out, _ = P.greedy_generate(fused, cache, toks[:, -1:], 12, 4, cfg)
            assert out.shape == (1, 4)
        with P.backend("a8"):
            rec = P.recode_model_s8(params, cfg, include_head=True)
            eng = ServingEngine(rec, cfg, max_slots=2, max_len=64, quantized_cache=8, fuse=True,
                                device="cpu")
            eng.submit([1, 2, 3], 5)
            eng.run_pipelined(4)
            assert [len(r.generated) for r in eng.requests.values()] == [5]
        # the fp cache (the default), sampled and speculative decoding, the hooks
        eng = ServingEngine(params, cfg, max_slots=2, max_len=64, device="cpu")
        eng.submit([1, 2, 3], 5)
        eng.run_pipelined(4)
        assert sorted(eng.cache) == ["k", "v"] and eng.dispatches["windowed"] == 0
        fp = lambda: P.init_kv_cache(cfg, 1, 32, device="cpu")  # noqa: E731
        out, _ = P.sample_generate(params, fp(), toks[:, -1:], 0, 4, cfg,
                                   torch.Generator().manual_seed(1), temperature=0.8, top_p=0.9)
        assert out.shape == (1, 4)
        spec, counts, _, _, pos = P.speculative_generate(params, params, fp(), fp(), toks[:, -1:],
                                                         0, 3, 2, cfg)
        assert len(P.flatten_speculative(spec, counts)) == pos
        rq = P.RuntimeQuantConfig(act=P.QuantSpec(n_bits=8), k=P.QuantSpec(n_bits=4),
                                  v=P.QuantSpec(n_bits=4))
        out, _ = P.greedy_generate(params, fp(), toks[:, -1:], 0, 4, cfg, rq)
        assert out.shape == (1, 4) and P.fake_quant_dynamic(toks.float(), rq.k).shape == toks.shape
        # the decode routes: eager with the kernels off, the codes-direct int8 route
        try:
            P.set_decode_kernel(False)
            eng = ServingEngine(params, cfg, max_slots=2, max_len=64, quantized_cache=8,
                                device="cpu")
            eng.submit([1, 2, 3], 5)
            eng.run_pipelined(4)
            assert eng.dispatches["windowed"] == 0 and not windowed.windowed_ok(cfg, eng.cache)
        finally:
            P.set_decode_kernel("auto")
        try:
            P.set_decode_attn("xla")
            cache = P.init_kv_cache(cfg, 1, 32, quantized=8, device="cpu")
            out, _ = P.greedy_generate(params, cache, toks[:, -1:], 0, 4, cfg)
            assert out.shape == (1, 4)
        finally:
            P.set_decode_attn("auto")
        from llama3_quantization_tpu_torch.microbench import w4_v4
        from llama3_quantization_tpu_torch.quant import smoothquant
        res = w4_v4.main(["512", "256", "256", "128", "--device", "cpu", "--steps", "1"])
        assert res["max_rel_err"] < 1e-5
        assert not any(m == "jax" or m.startswith(("jax.", "llama3_quantization_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)

        # without CUDA, an entry point left at its default device raises
        torch.cuda.is_available = lambda: False
        for call in (lambda: P.init_kv_cache(cfg, 1, 8),
                     lambda: P.init_kv_cache(cfg, 1, 8, quantized=4),
                     lambda: ServingEngine(params, cfg),
                     lambda: P.init_quantized_params(cfg, P.QuantSpec(n_bits=4, group_size=32)),
                     lambda: P.init_params(cfg, gen),
                     lambda: P.params_from_numpy({}),
                     lambda: smoothquant.load_act_stats("stats.npz"),
                     lambda: w4_v4.main(["512", "256", "256", "128"])):
            try:
                call()
            except RuntimeError as e:
                assert "CUDA is not available" in str(e)
            else:
                raise AssertionError("entry point ran without CUDA")
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_quantizers_run_with_jax_blocked(tmp_path):
    """The calibration quantizers (GPTQ, mixed, SmoothQuant, AWQ,
    OmniQuant with LWC and LET), B7's gradient, `utils/pytree_io` and the
    act-stats tool run with JAX and the JAX package blocked."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["llama3_quantization_tpu"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import llama3_quantization_tpu_torch as P
        from llama3_quantization_tpu_torch import api
        from llama3_quantization_tpu_torch.ops import flash_attention as fa
        from llama3_quantization_tpu_torch.quant import (awq, calibration, gptq, mixed, omniquant,
                                                          smoothing, smoothquant)
        from llama3_quantization_tpu_torch.tools import generate_act_stats
        from llama3_quantization_tpu_torch.utils import pytree_io

        cfg = P.TINY_LLAMA
        params = P.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                               device="cpu")
        calib = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
        spec = P.QuantSpec(n_bits=4, group_size=32)
        for method, kw in (("gptq", {{"blocksize": 32}}), ("mixed", {{"blocksize": 32}}),
                           ("awq", {{}}), ("smoothquant", {{}}),
                           ("omniquant", {{"epochs": 1, "let": True}})):
            out = api.quantize(params, cfg, method, spec, calib_tokens=calib, **kw)
            assert isinstance(out["layers"]["down"]["w"], P.QuantizedTensor), method
        q = torch.randn(1, 128, 4, 64, requires_grad=True)
        k = torch.randn(1, 128, 2, 64, requires_grad=True)
        fa.flash_attention(q, k, k).sum().backward()
        assert q.grad is not None and k.grad is not None
        tree = {{"a": torch.ones(2), "b": {{"c": torch.zeros(3)}}}}
        pytree_io.save_pytree_npz("{tmp_path}/t.npz", tree)
        assert torch.equal(pytree_io.load_pytree_npz("{tmp_path}/t.npz", tree)["b"]["c"],
                           tree["b"]["c"])
        generate_act_stats.main(["--device", "cpu", "--nsamples", "2", "--seqlen", "16",
                                 "--out", "{tmp_path}/s.npz"])
        assert len(smoothquant.load_act_stats("{tmp_path}/s.npz", device="cpu")) == cfg.num_layers
        assert not any(m == "jax" or m.startswith(("jax.", "llama3_quantization_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_gemv_plans_and_wrappers_run_with_jax_blocked():
    """The GEMV forms' plans, their CPU routes and the wrappers' checks (B1
    in `ops/fused_qmatmul.py`, B3's GEMV form in `ops/qmatmul_a8.py`, the
    shared tiling in `ops/_build.py`) need neither JAX nor the JAX package."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["llama3_quantization_tpu"] = None
        import torch
        torch.set_num_threads(1)
        import llama3_quantization_tpu_torch as P
        from llama3_quantization_tpu_torch.ops import _build, fused_qmatmul as fq, qmatmul_a8 as qa

        for k, n in ((4096, 14336), (4096, 1024), (14336, 4096)):
            assert fq.gemv_plan(k, n, 128, 2).bn in _build.GEMV_TILES
            assert qa.gemv_plan(k, n, k, 1).ksplit >= 1
        qt = P.quantize_rtn(torch.randn(256, 64), P.QuantSpec(n_bits=4, group_size=64), pack=True)
        x = torch.randn(5, 256)
        y = fq.fused_dequant_matmul(x, qt, out_dtype=torch.float32)  # B1's plain version
        assert y.shape == (5, 64) and bool(y.isfinite().all())
        y = fq.fused_dequant_matmul(x, qt, out_dtype=torch.float32, version=3)  # B3's
        assert y.shape == (5, 64) and bool(y.isfinite().all())
        assert not any(m == "jax" or m.startswith(("jax.", "llama3_quantization_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_s8_split_runs_with_jax_blocked():
    """B4/B5's split plan and its algorithm in PyTorch (`s8_split_plan`,
    `decode_s8_split_plain` in `ops/decode_attention.py`) need neither JAX
    nor the JAX package."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["llama3_quantization_tpu"] = None
        import torch
        torch.set_num_threads(1)
        import llama3_quantization_tpu_torch as P
        from llama3_quantization_tpu_torch.ops import decode_attention as da

        assert da.s8_split_plan(512, 512, 128, True) == (8, 64)
        kq, ks = P.kv4_quantize(torch.randn(1, 2, 64, 32))
        vq, vs = P.kv4_quantize(torch.randn(1, 2, 64, 32))
        q, mask = torch.randn(1, 1, 4, 32), torch.zeros(1, 64)
        o, m, l = da.decode_s8_split_plain(q, kq, ks, vq, vs, mask, torch.float32, 32, True)
        ref = da.decode_s8_plain(q, kq, ks, vq, vs, mask, torch.float32, 32, True)
        assert torch.equal(m, ref[1]) and bool(torch.allclose(o, ref[0], rtol=0, atol=1e-5))
        assert not any(m_ == "jax" or m_.startswith(("jax.", "llama3_quantization_tpu."))
                       for m_ in sys.modules if sys.modules[m_] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_eval_runs_with_jax_blocked():
    """The eval front end (`eval`, `api`, `tools.reproduce_study`) needs
    neither JAX nor the JAX package: one `compute_ppl` and one
    `simple_evaluate` through `TorchLM` on the study's parameters."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["llama3_quantization_tpu"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import llama3_quantization_tpu_torch as P
        from llama3_quantization_tpu_torch import api, eval as E
        from llama3_quantization_tpu_torch.eval.harness import TorchLM, simple_evaluate
        from llama3_quantization_tpu_torch.tools import reproduce_study as R

        cfg = P.TINY_LLAMA
        params = api.quantize(R.load_tiny_params("cpu"), cfg, "rtn",
                              P.QuantSpec(n_bits=4, group_size=32))
        tok = E.SyntheticTokenizer()
        _, enc = E.get_loaders("wikitext2", nsamples=1, seed=0, seqlen=32, tokenizer=tok,
                               train_text=R.CORPUS.read_text()[:20000],
                               test_text=R.CORPUS.read_text()[-20000:])
        ppl = E.compute_ppl(params, cfg, enc, seqlen=32, limit=3)
        assert np.isfinite(ppl) and ppl > 1
        lm = TorchLM(params, cfg, R.Tok(tok), batch_size=4, max_length=32)
        res = simple_evaluate(lm, ["piqa"], bootstrap_iters=2, task_data=R.TASK_DATA)
        assert 0 <= res["results"]["piqa"]["acc"] <= 1
        assert not any(m == "jax" or m.startswith(("jax.", "llama3_quantization_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_cli_slice_runs_with_jax_and_hf_packages_blocked(tmp_path):
    """The CLI, the HF loader and checkpoints, HQQ, NF4 and IR-QLoRA need
    neither JAX, the JAX package, `safetensors` nor `transformers`: the
    CLI quantizes with HQQ, evaluates and saves; the checkpoint and an HF
    directory round-trip; IR-QLoRA and NF4 run."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "llama3_quantization_tpu", "safetensors", "transformers"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)
        import llama3_quantization_tpu_torch as P
        from llama3_quantization_tpu_torch import api, cli
        from llama3_quantization_tpu_torch.models import hf_loader
        from llama3_quantization_tpu_torch.quant import hqq, irqlora, nf4
        from llama3_quantization_tpu_torch.utils import pytree_io

        res = cli.main(["--device", "cpu", "--net", "tiny-llama", "--quant_method", "hqq",
                        "--wbits", "4", "--group_size", "32", "--eval_ppl", "--ppl_datasets",
                        "wikitext2", "--seqlen", "32", "--limit", "1", "--save_dir",
                        "{tmp_path}/ck"])
        assert res["wikitext2"] > 1
        cfg = P.TINY_LLAMA
        fp = P.init_params(cfg, torch.Generator().manual_seed(2), dtype=torch.float32,
                           device="cpu")
        hq = api.quantize(fp, cfg, "hqq", P.QuantSpec(n_bits=4, group_size=32))
        back = hf_loader.load_checkpoint("{tmp_path}/ck", hq)
        assert all(torch.equal(a, b) for a, b in zip(pytree_io.tree_leaves(back),
                                                     pytree_io.tree_leaves(hq)))
        hf_loader.save_hf_checkpoint(fp, cfg, "{tmp_path}/hf")
        again, _ = hf_loader.from_hf_checkpoint("{tmp_path}/hf", dtype=torch.float32,
                                                device="cpu")
        assert torch.equal(again["layers"]["q"]["w"], fp["layers"]["q"]["w"])
        ir = api.quantize(fp, cfg, "irqlora", tau_n=2, blocksize2=4)
        assert not torch.equal(ir["layers"]["q"]["w"], fp["layers"]["q"]["w"])
        t = nf4.nf4_quantize(torch.randn(70, 9))
        assert nf4.nf4_dequantize(t).shape == (70, 9)
        assert not any(m in ("jax", "safetensors", "transformers")
                       or m.startswith(("jax.", "llama3_quantization_tpu.", "safetensors.",
                                        "transformers."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_harness_ir_sts_run_with_jax_and_hf_packages_blocked(tmp_path):
    """The rest of the harness needs neither JAX, the JAX package,
    `transformers` nor `datasets`: every task module and the registry, the
    local loaders, the adapters (`hf-causal` over a plain module), DummyLM,
    decontamination (the native janitor and the Python one, the archiver,
    `get_pile(data_file=)`), `simple_evaluate` with an n-gram pickle,
    retrieval, STS and both benchmark tools; an HF adapter left to find its
    model raises for want of `transformers`."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "llama3_quantization_tpu", "transformers", "datasets"):
            sys.modules[name] = None
        import importlib, pkgutil
        import torch
        torch.set_num_threads(1)
        import llama3_quantization_tpu_torch as P
        from llama3_quantization_tpu_torch import decontamination, eval as E
        from llama3_quantization_tpu_torch.decontamination import archiver, janitor
        from llama3_quantization_tpu_torch.eval import harness as H, mmlu_categories, retrieval, sts
        from llama3_quantization_tpu_torch.eval.harness import local_datasets, tasks, text_utils
        from llama3_quantization_tpu_torch.tools import (benchmark_ir, benchmark_sts,
                                                          reproduce_study as R)

        for m in pkgutil.iter_modules(tasks.__path__):
            importlib.import_module(f"{{tasks.__name__}}.{{m.name}}")
        assert len(tasks.TASK_REGISTRY) == 285 and len(local_datasets.LOADERS) > 10
        assert janitor.native_used()
        j = janitor.Janitor()
        j.register_contaminant(" ".join(f"w{{i}}" for i in range(14)))
        j.save_contamination_ngrams("{tmp_path}/g.pkl")
        a = archiver.Archive("{tmp_path}/p.jsonl")
        a.add_data("some pile text " * 20)
        a.commit()
        from llama3_quantization_tpu_torch.eval.data import get_pile
        assert get_pile(1, 0, 8, E.SyntheticTokenizer(), data_file="{tmp_path}/p.jsonl")[0]
        docs = R.synthetic_task_data(n_docs=2, page_bytes=300)
        res = H.simple_evaluate(H.DummyLM(), list(docs), task_data=docs, bootstrap_iters=2,
                                decontamination_ngrams_path="{tmp_path}/g.pkl")
        assert "acc_decontaminate" in res["results"]["hellaswag"]
        assert mmlu_categories.mmlu_rollup(res["results"])["mmlu_average"] >= 0

        cfg = P.TINY_LLAMA
        params = P.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
                               device="cpu")

        class Causal(torch.nn.Module):
            def forward(self, ids):
                return type("Out", (), {{"logits": P.forward_logits(params, ids % 512, cfg)}})

        hf = H.get_model("hf-causal")(model=Causal(), tokenizer=R.Tok(E.SyntheticTokenizer()),
                                      device="cpu")
        assert len(hf.loglikelihood([("a b", " c d")])) == 1
        for name in ("hf-causal", "hf-seq2seq"):
            try:
                H.get_model(name)(pretrained="some/dir", device="cpu")
            except ImportError:
                pass
            else:
                raise AssertionError("an HF adapter ran without transformers")
        up = retrieval.UPRReranker(params, cfg, R.Tok(E.SyntheticTokenizer()), max_length=64)
        assert len(up.score_pairs([("q a", "a passage here"), ("b", "c")])) == 2
        enc = sts.STSEncoder(params, cfg, R.Tok(E.SyntheticTokenizer()), max_length=64)
        assert enc.encode(["one", "two words"]).shape == (2, cfg.hidden_size)
        ir = benchmark_ir.main(["--device", "cpu", "--synthetic", "8", "--top_k", "2"])
        st = benchmark_sts.main(["--device", "cpu", "--synthetic", "4"])
        assert set(ir) == {{"bm25", "upr"}} and st["n_pairs"] == 4
        assert not any(m in ("jax", "transformers", "datasets")
                       or m.startswith(("jax.", "llama3_quantization_tpu.", "transformers.",
                                        "datasets."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("name", ["qmatmul", "qmatmul_a8", "decode_attention", "decode_fp",
                                  "flash_attention", "w4_stream", "w4_bd", "qmm_u8"])
def test_kernel_sources_ship(name):
    """Every kernel source the build names is in the package (and in the
    wheel's package data)."""
    from llama3_quantization_tpu_torch.ops import _build

    assert name in _build.SOURCES
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert 'extern "C"' in src and "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "llama3_quantization_tpu_torch" in (ROOT / "pyproject.toml").read_text()


def test_ablation_switch_stays_out_of_the_normal_build(monkeypatch):
    """`L3Q_ABLATE` (phases removed, for timing only) reaches nvcc only when
    the environment sets it, and such a build gets its own library name."""
    from llama3_quantization_tpu_torch.ops import _build

    monkeypatch.delenv("L3Q_ABLATE", raising=False)
    assert _build._flags() == _build.NVCC_FLAGS
    normal = _build._lib_path("flash_attention")
    monkeypatch.setenv("L3Q_ABLATE", "9")
    assert _build._flags()[-1] == "-DL3Q_ABLATE=9"
    assert _build._lib_path("flash_attention") != normal
    src = (_build.CSRC / "common.cuh").read_text()
    assert "#ifndef L3Q_ABLATE\n#define L3Q_ABLATE 0" in src
