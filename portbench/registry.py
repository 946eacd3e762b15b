"""Finds the benchmark's parts by name, so that a later change adds a
configuration, a traffic mix, a per-layer metric, a kernel name, a driver
or a cell's limits as new files and edits none:

- `configs/<name>.json`: a model configuration;
- `traffic/<name>.json`: a traffic mix, the parameters its driver reads;
- `drivers/<name>.py`: a driver (`Driver` class), named by a mix's `driver`;
- `metrics/<name>.py`: a per-layer metric's reader (`read(ctx)`), or, where
  there is none, the reader of the name less its last dotted part, which
  serves a family of metrics that `BENCHMARK.json` keeps apart by their
  cells (`idle_share.py` reads `idle_share.ppl` and `idle_share.serve`);
- `kernel_groups/<group>/*.txt`: kernel names, one a line; a group is the
  union of its files;
- `limits/<cell>.json`: the limits of a cell's correctness check.

Each is looked up in the extra roots first (a test's temporary folder),
then in this package.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Sequence

PACKAGE = Path(__file__).resolve().parent
REPO = PACKAGE.parent


class Registry:
    def __init__(self, extra_roots: Sequence[Path] = ()):
        self.roots: List[Path] = [Path(r) for r in extra_roots] + [PACKAGE]
        self._modules: Dict[Path, object] = {}

    def path(self, kind: str, name: str, ext: str) -> Path:
        for root in self.roots:
            p = root / kind / f"{name}{ext}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{ext} under {[str(r) for r in self.roots]}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        """The module of `<kind>/<name>.py`, loaded once by path (a metric's
        name may hold dots)."""
        p = self.path(kind, name, ".py")
        if p not in self._modules:
            spec = importlib.util.spec_from_file_location(
                f"portbench_{kind}_{len(self._modules)}", p)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[p] = mod
        return self._modules[p]

    def reader(self, metric: str):
        """The reader of per-layer metric `metric` (see above)."""
        try:
            return self.module("metrics", metric)
        except FileNotFoundError:
            if "." not in metric:
                raise
            return self.module("metrics", metric.rsplit(".", 1)[0])

    def kernel_groups(self) -> Dict[str, List[str]]:
        """Every group's kernel names: the union of its files in all roots."""
        groups: Dict[str, List[str]] = {}
        for root in self.roots:
            base = root / "kernel_groups"
            if not base.is_dir():
                continue
            for group in sorted(p for p in base.iterdir() if p.is_dir()):
                names = groups.setdefault(group.name, [])
                for f in sorted(group.glob("*.txt")):
                    for line in f.read_text().splitlines():
                        line = line.split("#", 1)[0].strip()
                        if line and line not in names:
                            names.append(line)
        return groups


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())
