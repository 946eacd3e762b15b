"""Port parity: the switches and knobs of the JAX package that the ported
modules had left out.

- `set_flash(True | False | "auto")` (JAX `models/transformer.py:150-165`):
  False sends full-sequence attention to the eager path, "auto" and True
  keep B7 where `b7_takes` holds (True never forces it onto D = 16);
  logits equal JAX's (its eager route on the CPU) within 1e-5 of
  max|logit|, greedy tokens identical; invalid modes raise on both sides.
- `set_stacked_decode` and `_stacked_decode_ok` (JAX `:394-431`), twins of
  `tests/test_stacked_decode.py`'s five tests: the stacked and per-layer
  forms give the same bits on the int8, int4 and fp caches and in
  multi-slot decode (so the port's switch only checks its mode), the
  predicate routes as JAX's, and greedy tokens under both of JAX's forms
  equal the port's (JAX's interpreted kernel route).
- `L3Q_DECODE_ATTN` (JAX `:304`): the default of `set_decode_attn`, read at
  import on both sides; a greedy stream on an int8 cache under the knob
  equals JAX's under "xla".
- JAX's `L3Q_WINDOW_MERGE=gather` (`models/windowed.py:263-440`), which the
  port does not read: its one merge writes the same bytes as JAX's piece
  merge and, under the knob, its gather merge.
- `L3Q_SERVE_DEBUG=1` (JAX `serving/engine.py:462,576-581`): the same
  number of windows as JAX's engine, printed by the debug line, and
  identical streams; JAX's `L3Q_SERVE_CLAMP=min` (`:523-524`), which the
  port does not read, changes JAX's window count but not its streams.
"""

import dataclasses
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA, init_params
from llama3_quantization_tpu.models import transformer as JT
from llama3_quantization_tpu.models import windowed as JW
from llama3_quantization_tpu.ops import kvcache as jkv
from llama3_quantization_tpu_torch import convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.models import windowed as TW
from llama3_quantization_tpu_torch.ops import decode_attention as da
from llama3_quantization_tpu_torch.ops import kvcache as tkv
from llama3_quantization_tpu_torch.ops import launches
from test_torch_model import jax_kernel_route, models, to_numpy_tree  # noqa: F401  (fixtures)
from test_torch_serving import run_both, streams

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CFG, TCFG = TINY_LLAMA, tcfg.TINY_LLAMA


@pytest.fixture(scope="module")
def fp32():
    params = init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return params, convert.params_from_numpy(to_numpy_tree(params), device="cpu")


@pytest.fixture(autouse=True)
def _restore_switches():
    yield
    for mod in (JT, TT):
        mod.set_flash("auto")
        mod.set_stacked_decode("auto")
        mod.set_decode_kernel("auto")
        mod.set_decode_attn("auto")


class Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


# ------------------------------------------------------------- set_flash ----
@pytest.mark.parametrize("mode", ["on", None, 2])
def test_set_flash_rejects_invalid_modes(mode):
    for mod in (JT, TT):
        with pytest.raises(ValueError):
            mod.set_flash(mode)


#: a llama of TINY_LLAMA's depth with head dim 64, which B7 takes
D64 = dict(hidden_size=128, num_heads=2, num_kv_heads=1)


@pytest.mark.parametrize("mode", [True, False, "auto"])
@pytest.mark.parametrize("d64", [True, False])
def test_set_flash_routes_and_matches_jax(monkeypatch, mode, d64):
    jc = dataclasses.replace(CFG, **D64) if d64 else CFG
    tc = dataclasses.replace(TCFG, **D64) if d64 else TCFG
    jparams = init_params(jc, jax.random.PRNGKey(2), dtype=jnp.float32)
    tparams = convert.params_from_numpy(to_numpy_tree(jparams), device="cpu")
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, (1, 128))
    JT.set_flash(False if mode is True else mode)  # JAX's True runs the TPU kernel
    ref = np.asarray(JT.forward_logits(jparams, jnp.asarray(toks), jc))
    spy = Spy(TT.flash_attention)
    monkeypatch.setattr(TT, "flash_attention", spy)
    TT.set_flash(mode)
    launches.reset()
    got = TT.forward_logits(tparams, torch.from_numpy(toks), tc).numpy()
    flash = mode is not False
    assert spy.calls == (jc.num_layers if flash and d64 else 0)
    assert launches.COUNTS["B7.eager"] == (jc.num_layers if flash and not d64 else 0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


# ---------------------------------------------------- set_stacked_decode ----
def _run_steps(params, cache, tok, n=4, multi=False, pos0=0):
    if multi:
        pos = torch.as_tensor(pos0)
        for _ in range(n):
            lg, cache = TT.decode_step_multi(params, cache, tok, pos, TCFG)
            pos = pos + 1
    else:
        for i in range(n):
            lg, cache = TT.decode_step(params, cache, tok, pos0 + i, TCFG)
    return lg, cache


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _assert_same(a, b):
    lg_a, c_a = a
    lg_b, c_b = b
    assert torch.equal(lg_a, lg_b)
    for k in c_a:
        assert torch.equal(c_a[k], c_b[k]), k


def _per_layer_s8(q, k_q, k_s, v_q, v_s, mask, layer, out_dtype=torch.bfloat16, block_t=1024):
    """The layer-stacked int8/int4 decode through the per-layer form."""
    return da.flash_decode_gqa_s8(q, k_q[layer], k_s[layer], v_q[layer], v_s[layer], mask,
                                  out_dtype=out_dtype, block_t=block_t)


def _per_layer_fp(q, k, v, mask, layer, block_t):
    """The layer-stacked fp decode through the per-layer form."""
    return da.flash_decode_gqa(q, k[layer], v[layer], mask, block_t)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_stacked_matches_per_layer_kernel(fp32, kv_bits, monkeypatch):
    tok = torch.tensor([[3], [5]])
    cache0 = TT.init_kv_cache(TCFG, 2, 64, quantized=kv_bits, device="cpu")
    a = _run_steps(fp32[1], _clone(cache0), tok)
    spy = Spy(_per_layer_s8)
    monkeypatch.setattr(TT, "flash_decode_gqa_s8_stacked", spy)
    TT.set_stacked_decode(False)  # JAX's per-layer switch: checks its mode only
    b = _run_steps(fp32[1], _clone(cache0), tok)
    assert spy.calls == 4 * TCFG.num_layers
    _assert_same(a, b)


def test_stacked_fp_cache_matches_per_layer(fp32, monkeypatch):
    tok = torch.tensor([[3], [5]])
    cache0 = TT.init_kv_cache(TCFG, 2, 64, dtype=torch.float32, device="cpu")
    assert TT._stacked_decode_ok(TT.NO_QUANT, cache0, 1, TCFG.num_heads)
    a = _run_steps(fp32[1], _clone(cache0), tok)
    spy = Spy(_per_layer_fp)
    monkeypatch.setattr(TT, "flash_decode_gqa_stacked", spy)
    b = _run_steps(fp32[1], _clone(cache0), tok)
    assert spy.calls == 4 * TCFG.num_layers
    _assert_same(a, b)


def test_stacked_multi_slot_matches(fp32, monkeypatch):
    """Per-row positions on the int8 cache take the stacked form (JAX
    takes it there under `set_stacked_decode(True)`, `transformer.py:
    1017`): the same bits as the per-layer form."""
    tok = torch.tensor([[3], [5]])
    cache0 = TT.init_kv_cache(TCFG, 2, 64, quantized=8, device="cpu")
    pos = torch.tensor([5, 9])
    spy = Spy(TT.flash_decode_gqa_s8_stacked)
    monkeypatch.setattr(TT, "flash_decode_gqa_s8_stacked", spy)
    a = TT.decode_step_multi(fp32[1], _clone(cache0), tok, pos, TCFG)
    assert spy.calls == TCFG.num_layers
    monkeypatch.setattr(TT, "flash_decode_gqa_s8_stacked", _per_layer_s8)
    b = TT.decode_step_multi(fp32[1], _clone(cache0), tok, pos, TCFG)
    _assert_same(a, b)


def test_predicate_routing():
    """`_stacked_decode_ok` as JAX's (`test_stacked_decode.py:
    test_predicate_routing`); at "auto" the port keeps its kernels on the
    CPU too, where JAX's "auto" gate is off."""
    hq = TCFG.num_heads
    cache_q = TT.init_kv_cache(TCFG, 2, 64, quantized=8, device="cpu")
    cache_fp = TT.init_kv_cache(TCFG, 2, 64, dtype=torch.float32, device="cpu")
    TT.set_decode_kernel(False)
    assert not TT._stacked_decode_ok(TT.NO_QUANT, cache_q, 1, hq)
    TT.set_decode_kernel("auto")
    assert TT._stacked_decode_ok(TT.NO_QUANT, cache_q, 1, hq)
    assert not TT._stacked_decode_ok(TT.NO_QUANT, cache_q, 2, hq)  # prefill
    JT.set_stacked_decode(False)
    TT.set_stacked_decode(False)  # JAX's gate closes; the port's forms agree, so it stays
    assert not JT._stacked_decode_ok(JT.NO_QUANT, JT.init_kv_cache(CFG, 2, 64, quantized=8), 1)
    assert TT._stacked_decode_ok(TT.NO_QUANT, cache_q, 1, hq)
    TT.set_stacked_decode("auto")
    rq = TT.RuntimeQuantConfig(k=TT.QuantSpec(n_bits=8))
    assert not TT._stacked_decode_ok(rq, cache_fp, 1, hq)
    assert TT._stacked_decode_ok(TT.NO_QUANT, cache_fp, 1, 3 * TCFG.num_kv_heads)  # rep 3: padded
    assert not TT._stacked_decode_ok(TT.NO_QUANT, cache_fp, 1, 16 * TCFG.num_kv_heads)  # rep 16
    for mod in (JT, TT):
        with pytest.raises(ValueError):
            mod.set_stacked_decode("on")


def test_greedy_generate_stacked_matches(fp32):
    """Greedy tokens through both forms, on the port and on JAX's
    interpreted kernel route: all four streams identical."""
    jparams, tparams = fp32
    outs = {}
    JT.set_decode_kernel("interpret")
    for stacked in (False, "auto"):
        JT.set_stacked_decode(stacked)
        cache = JT.init_kv_cache(CFG, 1, 64, quantized=8)
        toks, _ = JT.greedy_generate(jparams, cache, jnp.array([[7]], jnp.int32), jnp.int32(0),
                                     6, CFG)
        outs[("jax", stacked)] = np.asarray(toks).tolist()
        TT.set_stacked_decode(stacked)
        cache = TT.init_kv_cache(TCFG, 1, 64, quantized=8, device="cpu")
        toks, _ = TT.greedy_generate(tparams, cache, torch.tensor([[7]]), 0, 6, TCFG)
        outs[("port", stacked)] = toks.tolist()
    assert len({str(v) for v in outs.values()}) == 1, outs


# ------------------------------------------------------- L3Q_DECODE_ATTN ----
def _run_py(script, **env):
    full = {**os.environ, **env}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(script)], cwd=ROOT,
                          capture_output=True, text=True, timeout=120, env=full)


def test_decode_attn_env_sets_the_default(fp32):
    out = _run_py("""
        import numpy as np, torch
        torch.set_num_threads(1)
        import jax
        from llama3_quantization_tpu.models import transformer as JT
        from llama3_quantization_tpu_torch.models import transformer as TT
        from llama3_quantization_tpu_torch.tools.reproduce_study import load_tiny_params
        from llama3_quantization_tpu_torch.models.configs import TINY_LLAMA
        print(JT._DECODE_ATTN, TT._DECODE_ATTN)
        p = load_tiny_params("cpu")
        cache = TT.init_kv_cache(TINY_LLAMA, 1, 64, quantized=8, device="cpu")
        toks, _ = TT.greedy_generate(p, cache, torch.tensor([[7]]), 0, 6, TINY_LLAMA)
        print(toks.tolist())
    """, L3Q_DECODE_ATTN="xla")
    assert out.returncode == 0, out.stderr
    modes, toks = out.stdout.strip().splitlines()[-2:]
    assert modes == "xla xla"
    JT.set_decode_kernel("interpret")
    JT.set_decode_attn("xla")
    cache = JT.init_kv_cache(CFG, 1, 64, quantized=8)
    ref, _ = JT.greedy_generate(fp32[0], cache, jnp.array([[7]], jnp.int32), jnp.int32(0), 6, CFG)
    assert toks == str(np.asarray(ref).tolist())
    bad = _run_py("import llama3_quantization_tpu_torch", L3Q_DECODE_ATTN="codes")
    assert bad.returncode != 0 and "L3Q_DECODE_ATTN" in bad.stderr


# --------------------------------------------- JAX's L3Q_WINDOW_MERGE ----
def _merge_inputs(packed, seed):
    L, B, H, T, D, KW = 2, 3, 2, 16, 4, 5
    rng = np.random.default_rng(seed)
    codes = rng.integers(-7, 8, (L, B, H, T, D)).astype(np.int8)
    cache = {"k_q": codes, "v_q": codes[:, ::-1].copy(),
             "k_s": rng.normal(size=(L, B, H, T, 1)).astype(np.float32),
             "v_s": rng.normal(size=(L, B, H, T, 1)).astype(np.float32)}
    if packed:
        cache["k_q"] = np.asarray(jkv.kv4_pack(jnp.asarray(cache["k_q"])))
        cache["v_q"] = np.asarray(jkv.kv4_pack(jnp.asarray(cache["v_q"])))
    win = (rng.integers(-7, 8, (L, B, H, KW, D)).astype(np.int8),
           rng.normal(size=(L, B, H, KW, 1)).astype(np.float32),
           rng.integers(-7, 8, (L, B, H, KW, D)).astype(np.int8),
           rng.normal(size=(L, B, H, KW, 1)).astype(np.float32))
    return cache, win


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("sink", [0, 2, 3])
@pytest.mark.parametrize("pos0", [0, 13, [0, 2, 3], [11, 20, 33]])
@pytest.mark.parametrize("gather", [True, False])
def test_gather_merge_knob_matches_jax(monkeypatch, packed, sink, pos0, gather):
    """The port's merge (which reads no knob) against JAX's gather merge
    under `L3Q_WINDOW_MERGE=gather` and its default choice without it."""
    if gather:
        monkeypatch.setenv("L3Q_WINDOW_MERGE", "gather")
    else:
        monkeypatch.delenv("L3Q_WINDOW_MERGE", raising=False)
    cache, win = _merge_inputs(packed, seed=sink + 3 * packed)
    ref = JW.merge_window_into_cache({k: jnp.asarray(v) for k, v in cache.items()},
                                     tuple(jnp.asarray(w) for w in win),
                                     jnp.asarray(np.asarray(pos0, np.int32)), CFG, sink)
    tp0 = pos0 if isinstance(pos0, int) else torch.tensor(pos0)
    got = TW.merge_window_into_cache({k: torch.from_numpy(v.copy()) for k, v in cache.items()},
                                     tuple(torch.from_numpy(w) for w in win), tp0, TCFG, sink)
    for k in tkv.CACHE_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


# ------------------------------------- L3Q_SERVE_CLAMP and L3Q_SERVE_DEBUG ----
@pytest.mark.parametrize("clamp", ["max", "min"])
def test_serve_clamp_and_debug_match_jax(models, jax_kernel_route, monkeypatch, capsys, clamp):
    monkeypatch.setenv("L3Q_SERVE_DEBUG", "1")
    if clamp == "min":
        monkeypatch.setenv("L3Q_SERVE_CLAMP", "min")
    else:
        monkeypatch.delenv("L3Q_SERVE_CLAMP", raising=False)
    counts = []

    def drive(eng):
        for p, n in (([1, 2, 3, 4], 9), ([9, 8, 7], 3), ([5, 5, 5], 6)):
            eng.submit(p, n, None)
        eng.run_pipelined(4)
        line = [ln for ln in capsys.readouterr().err.splitlines() if "run_pipelined:" in ln]
        counts.append(int(re.search(r"(\d+) windows", line[-1]).group(1)))
        return streams(eng)

    ref, got = run_both(models, drive, max_slots=2, max_len=64)
    assert got == ref
    assert counts[0] == {"max": 3, "min": 5}[clamp]  # JAX's counts
    assert counts[1] == 3  # the port reads no L3Q_SERVE_CLAMP
