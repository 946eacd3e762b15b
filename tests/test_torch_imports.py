"""The port stands alone: it imports neither JAX nor the JAX package (a
forward, serving engines on the int4 and the default fp cache, the W·A8
backends, sampled and speculative decoding, a hooked decode and a
microbench entry point run with both blocked), and an entry point called
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
        from llama3_quantization_tpu_torch.microbench import w4_v4
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
