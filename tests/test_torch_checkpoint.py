"""Port parity: HF directories and checkpoints (`models/hf_loader.py`,
`utils/pytree_io.py`).

`config_from_hf` equal to JAX's on llama, Llama-3.1 rope scaling,
Mixtral, the three Falcon layouts and OPT; JAX's `save_hf_checkpoint`
read by the port's `from_hf_checkpoint` (and the reverse) into equal
parameters; the port's safetensors codec writes the bytes of
`safetensors.numpy.save_file` for F32 and reads and writes BF16 and F16
as `safetensors.torch` does; the `.bin` fallback; TINY_OPT's HF directory
both ways; JAX's `save_checkpoint`
of an HQQ-packed TINY_LLAMA loaded by the port's `load_checkpoint` gives
logits within 1e-5 of JAX's, and the reverse; bf16 leaves both ways; and
the study's `fp` and `rtn` golden rows through the port's HF save and
load (`tests/test_golden_study.py:41-58`).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import TINY_LLAMA, forward_logits, init_params
from llama3_quantization_tpu.models import hf_loader as JL
from llama3_quantization_tpu.quant import QuantSpec as JSpec
from llama3_quantization_tpu.quant import hqq as JH
from llama3_quantization_tpu.utils import pytree_io as JIO
from llama3_quantization_tpu_torch import api, convert
from llama3_quantization_tpu_torch.models import configs as tcfg
from llama3_quantization_tpu_torch.models import hf_loader as TL
from llama3_quantization_tpu_torch.models import transformer as TT
from llama3_quantization_tpu_torch.ops import matmul as mm
from llama3_quantization_tpu_torch.quant.quantizer import QuantSpec
from llama3_quantization_tpu_torch.tools import reproduce_study as study
from llama3_quantization_tpu_torch.utils import pytree_io as TIO

from test_torch_model import to_numpy_tree

torch.set_num_threads(1)

HF_CONFIGS = {
    "llama": {"model_type": "llama", "vocab_size": 512, "hidden_size": 64,
              "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2},
    "llama31": {"model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
                "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
                "num_key_value_heads": 8, "rope_theta": 500000.0,
                "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                 "high_freq_factor": 4.0,
                                 "original_max_position_embeddings": 8192}},
    "mixtral": {"model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096,
                "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
                "num_key_value_heads": 8, "num_local_experts": 8},
    "falcon_mq": {"model_type": "falcon", "vocab_size": 65024, "hidden_size": 4544,
                  "num_hidden_layers": 32, "num_attention_heads": 71, "multi_query": True},
    "falcon_new": {"model_type": "falcon", "vocab_size": 65024, "hidden_size": 8192,
                   "num_hidden_layers": 60, "num_attention_heads": 128,
                   "new_decoder_architecture": True, "num_kv_heads": 8},
    "falcon_mha": {"model_type": "RefinedWeb", "vocab_size": 50304, "hidden_size": 2048,
                   "n_layer": 24, "n_head": 32, "multi_query": False},
    "opt": {"model_type": "opt", "vocab_size": 50272, "hidden_size": 768, "ffn_dim": 3072,
            "num_hidden_layers": 12, "num_attention_heads": 12,
            "max_position_embeddings": 2048},
}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_config_from_hf_is_jaxs(tmp_path, name):
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIGS[name]))
    got, ref = TL.config_from_hf(str(tmp_path)), JL.config_from_hf(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_config_from_hf_rejects_unknown(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "gpt2"}))
    with pytest.raises(ValueError, match="unsupported model_type"):
        TL.config_from_hf(str(tmp_path))


# ---------------------------------------------------------- safetensors ----
def test_codec_writes_safetensors_bytes(tmp_path):
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    arrays = {"model.b.weight": rng.standard_normal((5, 3)).astype(np.float32),
              "a": rng.standard_normal(7).astype(np.float32),
              "z.scalarish": np.ones((1, 1), np.float32)}
    save_file(arrays, str(tmp_path / "ref.safetensors"))
    TL.write_safetensors({k: torch.from_numpy(v) for k, v in arrays.items()},
                         str(tmp_path / "got.safetensors"))
    assert (tmp_path / "got.safetensors").read_bytes() == (tmp_path / "ref.safetensors").read_bytes()
    back = TL.read_safetensors(str(tmp_path / "ref.safetensors"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_codec_reads_and_writes_half_types(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(1)
    tensors = {"x": torch.randn(4, 6, generator=g).to(dtype),
               "y": torch.randn(3, generator=g).to(dtype)}
    save_file(tensors, str(tmp_path / "ref.safetensors"))
    back = TL.read_safetensors(str(tmp_path / "ref.safetensors"))
    TL.write_safetensors(tensors, str(tmp_path / "got.safetensors"))
    again = load_file(str(tmp_path / "got.safetensors"))
    for k, v in tensors.items():
        assert back[k].dtype == dtype and torch.equal(back[k], v)
        assert again[k].dtype == dtype and torch.equal(again[k], v)


# --------------------------------------------------------- HF directories ----
@pytest.fixture(scope="module")
def tiny():
    jp = init_params(TINY_LLAMA, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, convert.params_from_numpy(to_numpy_tree(jp), device="cpu")


def _assert_trees_equal(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_trees_equal(got[k], ref[k], f"{path}/{k}")
        return
    assert got.dtype == ref.dtype, path
    assert torch.equal(got, ref), path


def test_jax_hf_dir_loads_in_port(tmp_path, tiny):
    jp, tp = tiny
    JL.save_hf_checkpoint(jp, TINY_LLAMA, str(tmp_path))
    got, cfg = TL.from_hf_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JL.config_from_hf(str(tmp_path)))
    _assert_trees_equal(got, tp)
    bf, _ = TL.from_hf_checkpoint(str(tmp_path), device="cpu")  # JAX's default dtype, bf16
    assert bf["layers"]["q"]["w"].dtype == torch.bfloat16
    assert torch.equal(bf["layers"]["q"]["w"], tp["layers"]["q"]["w"].bfloat16())


def test_port_hf_dir_loads_in_jax(tmp_path, tiny):
    jp, tp = tiny
    TL.save_hf_checkpoint(tp, tcfg.TINY_LLAMA, str(tmp_path))
    ref_dir = tmp_path / "jax"
    JL.save_hf_checkpoint(jp, TINY_LLAMA, str(ref_dir))
    assert (json.loads((tmp_path / "config.json").read_text())
            == json.loads((ref_dir / "config.json").read_text()))
    assert ((tmp_path / "model.safetensors").read_bytes()
            == (ref_dir / "model.safetensors").read_bytes())
    got, _ = JL.from_hf_checkpoint(str(tmp_path), dtype=jnp.float32)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bin_fallback(tmp_path, tiny):
    from safetensors.torch import load_file

    _, tp = tiny
    TL.save_hf_checkpoint(tp, tcfg.TINY_LLAMA, str(tmp_path / "st"))
    sd = load_file(str(tmp_path / "st" / "model.safetensors"))
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "config.json").write_text((tmp_path / "st" / "config.json").read_text())
    torch.save(sd, str(tmp_path / "bin" / "pytorch_model.bin"))
    got, _ = TL.from_hf_checkpoint(str(tmp_path / "bin"), dtype=torch.float32, device="cpu")
    _assert_trees_equal(got, tp)
    with pytest.raises(FileNotFoundError):
        TL.from_hf_checkpoint(str(tmp_path / "st" / ".."), tcfg.TINY_LLAMA, device="cpu")


def test_other_architectures_wait_for_a4(tmp_path):
    """(The name is kept from when the port refused other architectures.)
    OPT (`_OPT_LAYER`, learned positions, biases, LayerNorms): JAX's
    `save_hf_checkpoint` of TINY_OPT and the port's write the same
    config.json; either directory loads in the port into JAX's tree bit for
    bit, and in JAX from the port's; the forward within 1e-5 of JAX's."""
    from llama3_quantization_tpu.models.configs import TINY_OPT

    jp = init_params(TINY_OPT, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = convert.params_from_numpy(to_numpy_tree(jp), device="cpu")
    JL.save_hf_checkpoint(jp, TINY_OPT, str(tmp_path / "jax"))
    TL.save_hf_checkpoint(tp, tcfg.TINY_OPT, str(tmp_path / "port"))
    assert (json.loads((tmp_path / "jax" / "config.json").read_text())
            == json.loads((tmp_path / "port" / "config.json").read_text()))
    for d in ("jax", "port"):
        got, cfg = TL.from_hf_checkpoint(str(tmp_path / d), dtype=torch.float32, device="cpu")
        ref, jc = JL.from_hf_checkpoint(str(tmp_path / d), dtype=jnp.float32)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jc)
        _assert_trees_equal(got, tp)
        _assert_trees_equal(convert.params_from_numpy(to_numpy_tree(ref), device="cpu"), tp)
    toks = np.random.default_rng(2).integers(0, TINY_OPT.vocab_size, (2, 16))
    out = TT.forward_logits(got, torch.from_numpy(toks), cfg).numpy()
    ref = np.asarray(forward_logits(jp, jnp.asarray(toks), TINY_OPT))
    assert float(np.abs(out - ref).max()) <= 1e-5 * float(np.abs(ref).max())


# ------------------------------------------------------------ checkpoints ----
@pytest.fixture(scope="module")
def hqq_models(tiny):
    jp, tp = tiny
    jq = JH.hqq_quantize_model(jp, TINY_LLAMA, JSpec(n_bits=4, group_size=32), iters=5,
                               pack=True)
    tq = api.quantize(tp, tcfg.TINY_LLAMA, "hqq", QuantSpec(n_bits=4, group_size=32), iters=5)
    return jq, tq


TOKS = np.random.default_rng(3).integers(0, TINY_LLAMA.vocab_size, (2, 16))


def _logits_t(params):
    with mm.backend("xla"):
        return TT.forward_logits(params, torch.from_numpy(TOKS), tcfg.TINY_LLAMA).numpy()


def _logits_j(params):
    return np.asarray(forward_logits(params, jnp.asarray(TOKS), TINY_LLAMA))


def test_jax_checkpoint_loads_in_port(tmp_path, hqq_models):
    jq, tq = hqq_models
    JL.save_checkpoint(jq, TINY_LLAMA, str(tmp_path))
    got = TL.load_checkpoint(str(tmp_path), tq)
    w, ref_w = got["layers"]["down"]["w"], jq["layers"]["down"]["w"]
    assert w.packed and np.array_equal(w.data.numpy(), np.asarray(ref_w.data))
    np.testing.assert_array_equal(w.zero.numpy(), np.asarray(ref_w.zero))
    np.testing.assert_allclose(_logits_t(got), _logits_j(jq), rtol=0, atol=1e-5)


def test_port_checkpoint_loads_in_jax(tmp_path, hqq_models):
    jq, tq = hqq_models
    TL.save_checkpoint(tq, tcfg.TINY_LLAMA, str(tmp_path / "port"))
    JL.save_checkpoint(jq, TINY_LLAMA, str(tmp_path / "jax"))
    assert ((tmp_path / "port" / "manifest.json").read_text()
            == (tmp_path / "jax" / "manifest.json").read_text())
    got = JL.load_checkpoint(str(tmp_path / "port"), jq)
    assert len(jax.tree_util.tree_leaves(got)) == len(TIO.tree_leaves(tq))
    np.testing.assert_allclose(_logits_j(got), _logits_t(tq), rtol=0, atol=1e-5)


def test_checkpoint_round_trip_is_exact(tmp_path, hqq_models):
    _, tq = hqq_models
    TL.save_checkpoint(tq, tcfg.TINY_LLAMA, str(tmp_path))
    got = TL.load_checkpoint(str(tmp_path), tq)
    for a, b in zip(TIO.tree_leaves(got), TIO.tree_leaves(tq)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(_logits_t(got), _logits_t(tq))


def test_bf16_leaves_both_ways(tmp_path):
    """JAX writes bfloat16 as 2-byte void records (which JAX's own loader
    refuses); they load here as bfloat16. The port writes them as float32,
    which JAX loads."""
    x = np.random.default_rng(4).standard_normal((3, 5)).astype(np.float32)
    jtree = {"a": jnp.asarray(x, jnp.bfloat16), "b": {"c": jnp.asarray(x)}}
    JIO.save_pytree_npz(str(tmp_path / "j.npz"), jtree)
    like = {"a": torch.zeros(3, 5, dtype=torch.bfloat16), "b": {"c": torch.zeros(3, 5)}}
    got = TIO.load_pytree_npz(str(tmp_path / "j.npz"), like)
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"], torch.from_numpy(x).bfloat16())
    TIO.save_pytree_npz(str(tmp_path / "t.npz"), got)
    back = JIO.load_pytree_npz(str(tmp_path / "t.npz"), jtree)
    np.testing.assert_array_equal(np.asarray(back["a"]),
                                  np.asarray(jtree["a"].astype(jnp.float32)))


@pytest.mark.parametrize("method", ["fp", "rtn"])
def test_study_via_hf_checkpoint_matches_golden(tmp_path, method):
    """The port's counterpart of `tests/test_golden_study.py:41-58`: the
    study's parameters saved as an HF directory and read back (fp32 round
    trips bit for bit), then the golden row."""
    TL.save_hf_checkpoint(study.load_tiny_params("cpu"), tcfg.TINY_LLAMA, str(tmp_path))
    params, cfg = TL.from_hf_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    assert cfg == tcfg.TINY_LLAMA
    table = study.run_study([method], device="cpu", params=params, verbose=False)
    assert study.golden_misses(table) == []
