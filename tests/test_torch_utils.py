"""Port parity: `utils/logger.py`, `utils/profiling.py` and
`tools/profile_report.py`.

`create_logger` is a copy of JAX's (same handlers, formats, file name);
`Throughput` is JAX's with the H100's HBM rate (3,350 GB/s) as its
default; the trace report reads a `torch.profiler` Chrome trace, whose
device events carry the categories `kernel`, `gpu_memcpy` and
`gpu_memset` where a `jax.profiler` trace names its device processes
`/device:...`: on the same device events written in each format, the two
tables are equal. A real CPU trace from `profile_trace` is read back (it
holds no device event, so its table is empty).
"""

import gzip
import json
import logging

import pytest
import torch

from llama3_quantization_tpu.utils import logger as jlogger
from llama3_quantization_tpu.utils import profiling as jprof
from llama3_quantization_tpu_torch import utils as tutils
from llama3_quantization_tpu_torch.tools import profile_report
from llama3_quantization_tpu_torch.utils import logger as tlogger
from llama3_quantization_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

#: (name, duration us) of the synthetic device events, in trace order
KERNELS = [("void qmm_gemv_kernel<4, false, 2, 1>(...)", 30.0), ("qmm_gemm_kernel", 70.0),
           ("void qmm_gemv_kernel<4, false, 2, 1>(...)", 28.0), ("Memcpy HtoD", 5.0),
           ("Memset (Device)", 1.0), ("decode_fp_kernel", 12.5)]
CATS = ["kernel", "kernel", "kernel", "gpu_memcpy", "gpu_memset", "kernel"]


def torch_trace():
    """Device events as torch.profiler writes them, among host events."""
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 0,
               "dur": 500.0},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
               "ts": 1, "dur": 4.0}]
    for i, ((name, dur), cat) in enumerate(zip(KERNELS, CATS)):
        events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": 10 * i,
                       "dur": dur})
    events.append({"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7, "ts": 3})
    return {"traceEvents": events}


def jax_trace():
    """The same device events as jax.profiler writes them."""
    events = [{"ph": "M", "name": "process_name", "pid": 5, "args": {"name": "/device:GPU:0"}},
              {"ph": "M", "name": "process_name", "pid": 6, "args": {"name": "/host:CPU"}},
              {"ph": "X", "name": "aten::mm", "pid": 6, "ts": 0, "dur": 500.0}]
    for i, (name, dur) in enumerate(KERNELS):
        events.append({"ph": "X", "name": name, "pid": 5, "ts": 10 * i, "dur": dur})
    return {"traceEvents": events}


def write_gz(path, trace):
    with gzip.open(path, "wt") as f:
        json.dump(trace, f)


@pytest.mark.parametrize("top,steps", [(25, 1), (2, 4)])
def test_device_op_table_matches_jax_on_the_same_device_events(tmp_path, top, steps):
    write_gz(tmp_path / "a.pt.trace.json.gz", torch_trace())
    (tmp_path / "j").mkdir()
    write_gz(tmp_path / "j" / "b.trace.json.gz", jax_trace())
    got = tprof.device_op_table(tprof.load_trace_events(str(tmp_path / "a.pt.trace.json.gz")),
                                top=top, steps=steps)
    ref = jprof.device_op_table(jprof.load_trace_events(str(tmp_path / "j")), top=top,
                                steps=steps)
    assert got == ref
    assert got[0]["name"] == "qmm_gemm_kernel"
    gemv = [r for r in got if "qmm_gemv_kernel" in r["name"]]
    if top > 2:
        assert gemv[0]["count"] == 2 and gemv[0]["total_ms"] == 0.058
        assert {r["name"] for r in got} == {name for name, _ in KERNELS}
    assert tprof.format_op_table(got) == jprof.format_op_table(ref)


def test_profile_report_main(tmp_path, capsys):
    write_gz(tmp_path / "old.pt.trace.json.gz", {"traceEvents": []})
    write_gz(tmp_path / "new.pt.trace.json.gz", torch_trace())
    import os
    import time

    os.utime(tmp_path / "old.pt.trace.json.gz", (time.time() - 100, time.time() - 100))
    rows = profile_report.main([str(tmp_path), "--top", "3", "--steps", "2"])
    out = capsys.readouterr().out
    assert len(rows) == 3 and "qmm_gemm_kernel" in out and out.count("\n") == 4
    with pytest.raises(FileNotFoundError):
        tprof.load_trace_events(str(tmp_path / "nothing"))


def test_profile_trace_writes_a_cpu_trace(tmp_path):
    with tutils.profile_trace(str(tmp_path)):
        a = torch.randn(32, 32)
        (a @ a).sum()
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json.gz")
    events = tprof.load_trace_events(str(tmp_path))
    assert any(e.get("cat") == "cpu_op" and e.get("name") == "aten::mm" for e in events)
    assert tprof.device_op_table(events) == []


def test_throughput_is_jaxs_at_the_cards_rate():
    got, ref = tutils.Throughput(bytes_per_token=4e9), jprof.Throughput(bytes_per_token=4e9,
                                                                         hbm_gbps=3350.0)
    assert got.hbm_gbps == 3350.0 and jprof.Throughput().hbm_gbps == 819.0
    for t in (got, ref):
        t.start()
        t.stop(16)
        t.seconds = 0.25
        t.tokens = 200
    assert got.report() == ref.report()
    assert got.tok_s == 800.0 and got.speed_of_light_fraction == pytest.approx(800 / 837.5)
    assert tutils.Throughput().report() == {"tokens": 0, "seconds": 0.0, "tok_s": 0.0}


def test_create_logger_is_jaxs(tmp_path):
    got = tutils.create_logger(str(tmp_path / "t"), 0, name="l3q-port-test")
    ref = jlogger.create_logger(str(tmp_path / "j"), 0, name="l3q-jax-test")
    assert got is tutils.create_logger(str(tmp_path / "t"), 0, name="l3q-port-test")
    assert [type(h) for h in got.handlers] == [type(h) for h in ref.handlers]
    assert [h.formatter._fmt for h in got.handlers] == [h.formatter._fmt for h in ref.handlers]
    assert got.level == ref.level == logging.DEBUG and not got.propagate
    got.info("hello from the port")
    for h in got.handlers:
        h.flush()
    (log,) = (tmp_path / "t").iterdir()
    assert log.name.startswith("log_rank0_") and "hello from the port" in log.read_text()
    quiet = tlogger.create_logger(None, 1, name="l3q-port-rank1")
    assert quiet.handlers == []
