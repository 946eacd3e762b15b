"""Nothing of the benchmark imports JAX or the JAX package: checked on
what a fresh process holds after importing every module under
`portbench/`, and on the import statements themselves. Names are
compared by their top-level part (before the first dot), whole: the port
`llama3_quantization_tpu_torch` is not the JAX package."""

import ast
import json
import subprocess
import sys

from portbench.bench import FORBIDDEN
from portbench.registry import PACKAGE, REPO

SCRIPT = """
import importlib, importlib.util, json, sys
from pathlib import Path
sys.path.insert(0, {repo!r})
files = sorted(Path({pkg!r}).rglob("*.py"))
for i, f in enumerate(files):
    parts = f.relative_to({repo!r}).with_suffix("").parts
    if all(p.isidentifier() for p in parts):
        importlib.import_module(".".join(parts))
    else:  # a metric's reader: its name holds dots
        spec = importlib.util.spec_from_file_location(f"pb_mod_{{i}}", f)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps([len(files), sorted(m for m in sys.modules
                                     if m.split(".")[0] in {bad!r})]))
"""


def test_no_jax_in_sys_modules_after_importing_everything():
    code = SCRIPT.format(repo=str(REPO), pkg=str(PACKAGE), bad=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(REPO)})
    assert out.returncode == 0, out.stderr[-2000:]
    n_files, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert n_files > 20
    assert loaded == []


def test_no_import_statement_names_jax():
    for f in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not [n for n in names if n.split(".")[0] in FORBIDDEN], (f, names)


def test_forbidden_names_are_whole_top_level_names():
    from portbench.bench import forbidden_modules

    assert "llama3_quantization_tpu_torch" not in FORBIDDEN
    assert all(m.split(".")[0] in FORBIDDEN for m in forbidden_modules())


PLANTED = """
import json, sys
sys.path.insert(0, {repo!r})
from pathlib import Path
from portbench.bench import run_cell
from portbench.tests import tiny

root = Path({root!r})
reg = tiny.write_root(root)
(root / "metrics" / "probe.ppl.py").write_text(
    "import jax\\n\\n\\ndef read(ctx):\\n    return 1.0\\n")
bench = tiny.bench_with_tiny_cells()
bench["per_layer"].append({{"name": "probe.ppl", "unit": "n", "better": "higher",
                           "source": "program_counter", "layer": "eval entry",
                           "moves": "score_tok_per_s", "workloads": ["tiny-falcon-ppl"]}})
try:
    result = run_cell("tiny-falcon-ppl", 5, 1.0, True, "cpu", registry=reg, bench=bench)
except RuntimeError as err:
    print("REFUSED", err, sys.modules["jax"].__file__)
else:
    print(json.dumps(result))
"""


def test_a_reader_that_loads_jax_gets_no_result(tmp_path):
    """A per-layer reader, loaded after the window, that imports `jax` (a
    stub of that name here) leaves the run without a result: the look at
    `sys.modules` comes after the readers and the reference."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    code = PLANTED.format(repo=str(REPO), root=str(tmp_path / "root"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                                           "PYTHONPATH": str(stub)})
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("REFUSED") and "'jax'" in last and str(stub) in last, last
