"""Perplexity windows: the study's PPL loop, timed.

Disjoint windows of `[batch, seqlen]` token ids, window i drawn from
`(seed, i)`, each through the port's PPL step (`eval.ppl.windowed_nll_fn`
on the tree after `pad_for_kernels`, as `compute_ppl` sets it up: the
forward, then the chunked NLL), its NLL read back to the host before the
next window is dispatched. Set-up warms the one shape with a window of
its own. The check samples `check_windows` of the window's windows (from
the seed) and holds each one's mean NLL a token against the reference's.

Traffic parameters: `seqlen`, `batch`, `chunk` (the NLL's positions at a
time), `check_windows`.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from llama3_quantization_tpu_torch.eval.ppl import windowed_nll_fn

from portbench import program, work
from portbench.bench import log, samples_line, seed_words
from portbench.reference.decoder import Reference

WARMUP = -1


class Driver:
    def __init__(self, cfg, traffic, seed, device, tracer, control=False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.tracer = device, tracer
        self.rq = program.runtime_quant(control)
        self.nlls = []
        self.wall = 0.0

    def tokens(self, i: int) -> np.ndarray:
        t = self.traffic
        rng = np.random.default_rng(seed_words(self.seed, i + 1))
        return rng.integers(0, self.cfg["model"]["vocab_size"], (t["batch"], t["seqlen"]))

    def _run(self, i: int) -> float:
        toks = torch.from_numpy(self.tokens(i)).to(self.device)
        with self.tracer.span("ppl.step"):
            nll = self.step(self.params, toks)
        with self.tracer.span("ppl.read"):
            return float(nll)

    def setup(self) -> None:
        self.params = program.build_params(self.cfg, self.seed, self.device)
        self.step = windowed_nll_fn(program.model_config(self.cfg), self.rq,
                                    chunk=self.traffic["chunk"])
        self._run(WARMUP)

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        while True:
            self.nlls.append(self._run(len(self.nlls)))
            self.wall = time.perf_counter() - t0
            if self.wall >= seconds:
                break
        samples_line({"windows": len(self.nlls)})

    def _scored_tokens(self) -> int:
        return len(self.nlls) * self.traffic["batch"] * self.traffic["seqlen"]

    def end_to_end(self) -> dict:
        return {"score_tok_per_s": self._scored_tokens() / self.wall}

    def facts(self) -> dict:
        t = self.traffic
        per_window = work.window_work(self.cfg, t["seqlen"])
        n = len(self.nlls) * t["batch"]
        return {
            "kind": "ppl",
            "windows": len(self.nlls),
            "wall_s": self.wall,
            "qmm_bound_s": n * work.linear_bound_s(self.cfg, t["seqlen"]),
            "flash_bound_s": n * per_window["flash"].bound_s,
            "step_flops": n * per_window["step"].flops,
        }

    def release(self) -> None:
        del self.params, self.step

    def outcomes(self):
        return len(self.nlls), sum(not math.isfinite(v) for v in self.nlls)

    def check(self) -> dict:
        """`nll_gap`: the largest |program − reference| mean NLL a token
        over the sampled windows."""
        t = self.traffic
        rng = np.random.default_rng(seed_words(self.seed, 0))
        n = min(t["check_windows"], len(self.nlls))
        picks = sorted(rng.choice(len(self.nlls), n, replace=False).tolist())
        ref = Reference(self.cfg, self.seed, self.device)
        toks = torch.from_numpy(np.concatenate([self.tokens(i) for i in picks]))
        ref_nll = ref.mean_nll(toks).reshape(n, t["batch"]).mean(-1).tolist()
        gaps = [abs(self.nlls[i] / t["seqlen"] - r) for i, r in zip(picks, ref_nll)]
        for i, r, g in zip(picks, ref_nll, gaps):
            log(f"window {i}: program {self.nlls[i] / t['seqlen']!r} reference {r!r} gap {g!r}")
        samples_line({"windows_checked": n})
        return {"nll_gap": max(gaps) if gaps else float("inf")}
