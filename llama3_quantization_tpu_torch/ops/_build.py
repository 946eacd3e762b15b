"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface and loaded with `ctypes`. The build
runs at first use, into `_build/` beside this package (listed in
`.gitignore`), under a name keyed on a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is reused. `build_all()`
starts one `nvcc` per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("qmatmul", "qmatmul_a8", "decode_attention", "decode_fp", "flash_attention",
           "flash_attention_bwd", "w4_stream", "w4_bd", "qmm_u8")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)



def _flags() -> tuple:
    """NVCC_FLAGS, plus the timing switch `L3Q_ABLATE` (csrc/common.cuh)
    where the environment sets it: kernels built so give wrong results."""
    ablate = os.environ.get("L3Q_ABLATE")
    return NVCC_FLAGS + ((f"-DL3Q_ABLATE={int(ablate)}",) if ablate else ())


#: the matmul kernels' GEMV forms serve M <= 64, their tiled forms above
#: (the TPU kernel's decode/prefill switch, pallas_qmatmul.py:399-403)
GEMV_MAX_M = 64
#: blocks a matmul launch wants in flight (two per H100 SM)
TARGET_BLOCKS = 264
#: the GEMV forms' column tiles (16-column warps, 8 warps a block), most
#: blocks along K (one thread-block cluster, the portable limit), and the
#: most code bytes and bytes of one activation row that one round moves
GEMV_TILES = (128, 64, 32, 16)
GEMV_MAX_SPLIT = 8
GEMV_ROUND_CODES = 8192
GEMV_ROUND_X = 512


class GemvPlan(NamedTuple):
    """Tiles and order of a GEMV form (B1, B3's GEMV form), from the shapes
    alone: the units of byte rows are walked in rounds of kw runs of uw
    units, run r of each round by warp row r."""

    bn: int      #: output columns per block (bn / 16 column warps)
    ksplit: int  #: blocks along K, one cluster, summed in rank order
    kw: int      #: warp rows along K in a block (8 warps / column warps)
    unit: int    #: byte rows per unit: a unit lies in one group
    uw: int      #: units per run: a run lies in one group


def gemv_run(gs: int, f: int, unit: int, bn: int, xbytes: int) -> int:
    """Units per run of a GEMV plan: the most units of one group whose
    round (one TMA box: at most 256 rows) stays within GEMV_ROUND_CODES
    code bytes and GEMV_ROUND_X bytes of an activation row (`xbytes` a
    value)."""
    ug, kw = gs // f // unit, 128 // bn
    fits = [u for u in range(ug, 0, -1) if ug % u == 0 and kw * u * unit <= 256]
    small = [u for u in fits if kw * u * unit * bn <= GEMV_ROUND_CODES
             and kw * u * unit * f * xbytes <= GEMV_ROUND_X]
    return small[0] if small else fits[-1]


def gemv_tiles(n: int, k: int, gs: int, f: int, unit: int, xbytes: int) -> GemvPlan:
    """The widest column tile of at least 64 columns (64-byte code rows:
    narrower rows stream the codes at well under the HBM rate) that reaches
    TARGET_BLOCKS blocks with the fewest splits (at most GEMV_MAX_SPLIT, on
    whole runs, a run per warp row of each split); where none does, the
    most blocks."""
    plans = []
    for bn in [t for t in GEMV_TILES if 64 <= t <= n] or [16]:
        kw = 128 // bn
        uw = gemv_run(gs, f, unit, bn, xbytes)
        most = max(1, min(GEMV_MAX_SPLIT, k // (unit * f) // uw // kw))
        ks = next((s for s in range(1, most + 1) if -(-n // bn) * s >= TARGET_BLOCKS), None)
        if ks:
            return GemvPlan(bn, ks, kw, unit, uw)
        plans.append(GemvPlan(bn, most, kw, unit, uw))
    return max(plans, key=lambda p: -(-n // p.bn) * p.ksplit)


_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(_flags()).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel; return each one's
    `ptxas` report (registers, shared memory, spills) by name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, path)
    reports, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def out_flag(out_dtype) -> int:
    """The kernels' `out_bf16` flag: 1 for bfloat16 output, 0 for float32."""
    import torch

    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"output dtype must be bfloat16 or float32, got {out_dtype}")
    return int(out_dtype == torch.bfloat16)


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
