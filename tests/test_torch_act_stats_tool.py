"""Port parity: the act-stats tool's command line
(`tools/generate_act_stats.py` in both packages).

Both tools take JAX's flags (`--model`, `--net`, `--calib_dataset`,
`--nsamples`, `--seqlen`, `--seed`, `--out`; the port's also `--device`)
and go through their package's `cli.load_model` and `cli.get_calib`. On an
HF directory written here (TINY_LLAMA from `tools/tiny_llama_init.npz`,
TINY_OPT from JAX's `init_params`) with `--calib_dataset synthetic`, the
two npz files hold the same keys; the first layer's attention inputs
(q/k/v and o) are bit-equal, and every |max| and mean is within 1e-2 of its
vector's scale. Both tools load the directory in bf16, as JAX's does, so
the stream is bf16: XLA's bf16 dot and torch's round the o and MLP
outputs up to one bf16 step apart, which the residual stream carries on
(at most 0.8% of a vector's scale here). `tests/test_torch_smoothing.py`
holds the fp32 statistics at 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from llama3_quantization_tpu.models import configs as JCF
from llama3_quantization_tpu.models import hf_loader as JL
from llama3_quantization_tpu.models import params as JP
from llama3_quantization_tpu.tools import generate_act_stats as jtool
from llama3_quantization_tpu_torch.models import configs as TCF
from llama3_quantization_tpu_torch.models import hf_loader as TL
from llama3_quantization_tpu_torch.tools import generate_act_stats as ttool
from llama3_quantization_tpu_torch.tools import reproduce_study as R

torch.set_num_threads(1)


def _hf_dir(path, arch):
    if arch == "llama":
        TL.save_hf_checkpoint(R.load_tiny_params("cpu"), TCF.TINY_LLAMA, str(path))
    else:
        params = JP.init_params(JCF.TINY_OPT, jax.random.PRNGKey(0), dtype=jnp.float32)
        JL.save_hf_checkpoint(params, JCF.TINY_OPT, str(path))
    return str(path)


@pytest.mark.parametrize("arch", ["llama", "opt"])
def test_tools_write_the_same_stats(tmp_path, arch):
    model = _hf_dir(tmp_path / "hf", arch)
    argv = ["--model", model, "--calib_dataset", "synthetic", "--nsamples", "4",
            "--seqlen", "32", "--seed", "3"]
    jtool.main(argv + ["--out", str(tmp_path / "j.npz")])
    assert ttool.main(argv + ["--out", str(tmp_path / "t.npz"), "--device", "cpu"]) == 0
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(t.files) == sorted(j.files) and len(j.files) == 2 * 2 * (
            7 if arch == "llama" else 6)
        for key in j.files:
            ref, got = j[key], t[key]
            if key.startswith("0/") and key.split("/")[1] in ("q", "k", "v", "o"):
                np.testing.assert_array_equal(got, ref, err_msg=key)
            err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
            assert err <= 1e-2 * scale, (key, err, scale)


def test_port_tool_takes_jax_flags_and_exits_without_a_model(tmp_path):
    """`--net` builds the named config (the port's seeded draws); neither
    `--model` nor `--net` exits as JAX's `cli.load_model` does."""
    out = tmp_path / "s.npz"
    ttool.main(["--net", "tiny-opt", "--calib_dataset", "synthetic", "--nsamples", "2",
                "--seqlen", "16", "--out", str(out), "--device", "cpu"])
    with np.load(out) as data:
        assert "1/fc2/absmax" in data.files and data["0/q/mean"].shape == (64,)
    with pytest.raises(SystemExit, match="pass --model"):
        ttool.main(["--out", str(out), "--device", "cpu"])
