"""Closed-loop serving on the port's `ServingEngine`.

`clients` clients each send their next request as soon as their last is
seen finished. The loop is the engine's own sequential one (`run(step_tokens
=k)`): admit every waiting request that finds a free slot with
`add_requests`, run `step_n(k)`, and repeat until the window's seconds have
passed. Every request's first token reaches the host when `add_requests`
returns, and its finish is seen when the `step_n` that ends it returns.

Sizes: one pool of `pool` (prompt length, budget) pairs drawn once from
`sizes_seed`, the same for every run and in the same order, served in
cycles; the run's seed draws the prompts' token ids. In a closed loop the
order of the sizes sets which requests share each step and each
admission, so an order of each seed's own would change the work from seed
to seed. No eos: each request runs to its budget.

The window records what each round did (the prompt lengths it admitted,
the positions each decode step attended) and nothing more; the work those
imply is counted once the window has closed, so the harness adds little
host time to the loop it measures.

Metrics: tokens generated (first tokens included) over the window;
tpot over every request finished in the window, (finish - first token) /
(tokens - 1); ttft over every request admitted in the window, from its
send to its first token. The check holds each served token of a sample of
the finished requests (from the seed, the longest among them) against the
reference's logits on the same prefix: the widest gap by which a served
token's logit lies below the reference's best.

Traffic parameters: `clients`, `slots`, `max_len`, `quantized_cache` (8,
4, or false for the bf16 cache), `step_tokens`, `prompt_len` and `budget`
(`[low, high)`), `sizes_seed`, `pool`, `check_requests`.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from llama3_quantization_tpu_torch.ops.launches import COUNTS
from llama3_quantization_tpu_torch.serving.engine import ServingEngine

from portbench import program, stats, work
from portbench.bench import log, samples_line, seed_words
from portbench.reference.decoder import Reference

KV_BYTES = {8: 1.0, 4: 0.5, False: 2.0}


def bucket(n: int, max_len: int) -> int:
    """The engine's prefill bucket of an `n`-token prompt."""
    b = 16
    while b < n:
        b *= 2
    return min(b, max_len - 1)


class Driver:
    def __init__(self, cfg, traffic, seed, device, tracer, control=False):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.tracer = device, tracer
        self.rq = program.runtime_quant(control)
        t = traffic
        sizes = np.random.default_rng(t["sizes_seed"])
        plens = sizes.integers(*t["prompt_len"], t["pool"])
        budgets = sizes.integers(*t["budget"], t["pool"])
        self.sizes = list(zip(plens.tolist(), budgets.tolist()))
        self.next_j = 0
        self.admitted = []   # (j, send_t, first_t)
        self.finished = []   # (j, first_t, finish_t, prompt, generated)
        self.decode_tokens = self.first_tokens = 0
        self.admit_s = self.wall = 0.0
        self.launches = self.steps = 0
        self.admissions = []  # the prompt lengths of each admission
        self.step_contexts = []  # each decode step's attended positions, a slot each

    def prompt(self, j: int):
        plen, budget = self.sizes[j % len(self.sizes)]
        rng = np.random.default_rng(seed_words(self.seed, 2, j))
        return rng.integers(0, self.cfg["model"]["vocab_size"], plen).tolist(), budget

    def setup(self) -> None:
        t = self.traffic
        self.params = program.build_params(self.cfg, self.seed, self.device)
        self.engine = ServingEngine(
            self.params, program.model_config(self.cfg), max_slots=t["slots"],
            max_len=t["max_len"], rq=self.rq, quantized_cache=t["quantized_cache"],
            device=self.device)
        self._warm_up()

    def _warm_up(self) -> None:
        """Every prefill bucket the mix reaches, and the decode step: a full
        batch at the largest bucket run through one `step_n` to its end,
        then one request at each smaller bucket and one step each."""
        t, eng = self.traffic, self.engine
        lo, hi = t["prompt_len"]
        buckets = sorted({bucket(n, t["max_len"]) for n in range(lo, hi)}, reverse=True)
        rng = np.random.default_rng(seed_words(self.seed, 3))
        vocab = self.cfg["model"]["vocab_size"]
        for i, b in enumerate(buckets):
            n_req, budget, k = (t["slots"], t["step_tokens"] + 1, t["step_tokens"]) if i == 0 \
                else (1, 1, 1)
            reqs = [(rng.integers(0, vocab, min(b, hi - 1)).tolist(), budget, None)
                    for _ in range(n_req)]
            rids = eng.add_requests(reqs)
            while not all(eng.requests[r].done for r in rids):
                eng.step_n(k)
            for r in rids:
                eng.result(r)

    def window(self, seconds: float) -> None:
        t, eng = self.traffic, self.engine
        k = t["step_tokens"]
        live = {}  # rid -> (j, send_t, first_t, prompt)
        t0 = time.perf_counter()
        waiting = collections.deque((self._next(), t0) for _ in range(t["clients"]))
        while True:
            if waiting and eng.free:
                batch = [waiting.popleft() for _ in range(min(len(waiting), len(eng.free)))]
                reqs = [(prompt, budget, None) for (prompt, budget, _), _ in batch]
                ta = time.perf_counter()
                with self.tracer.span("serve.add_requests"):
                    rids = eng.add_requests(reqs)
                tb = time.perf_counter()
                self.admit_s += tb - ta
                self.first_tokens += len(rids)
                self.admissions.append([len(r[0]) for r in reqs])
                for rid, ((prompt, _, j), send_t) in zip(rids, batch):
                    live[rid] = (j, send_t, tb, prompt)
                    self.admitted.append((j, send_t, tb))
            before = sum(COUNTS.values()), eng.dispatches["steps"]
            done_before = {rid: len(eng.requests[rid].generated) for rid in live}
            with self.tracer.span("serve.step_n"):
                out = eng.step_n(k)
            tc = time.perf_counter()
            self.launches += sum(COUNTS.values()) - before[0]
            steps = eng.dispatches["steps"] - before[1]
            self.steps += steps
            contexts = [[] for _ in range(steps)]
            for rid, toks in out.items():
                j, send_t, first_t, prompt = live[rid]
                n0 = done_before[rid]
                self.decode_tokens += len(toks)
                for s in range(len(toks)):
                    contexts[s].append(len(prompt) + n0 + s)  # positions attended
                if eng.requests[rid].done:
                    gen = eng.result(rid)
                    self.finished.append((j, first_t, tc, prompt, gen))
                    del live[rid]
                    waiting.append((self._next(), tc))
            self.step_contexts.extend(contexts)
            self.wall = tc - t0
            if self.wall >= seconds:
                break
        samples_line({"admitted": len(self.admitted), "finished": len(self.finished),
                      "decode_steps": self.steps, "tokens": self.first_tokens + self.decode_tokens})

    def _next(self):
        j = self.next_j
        self.next_j += 1
        prompt, budget = self.prompt(j)
        return prompt, budget, j

    def end_to_end(self) -> dict:
        tpot = [(fin - first) / (len(gen) - 1) for _, first, fin, _, gen in self.finished
                if len(gen) > 1]
        ttft = [first - send for _, send, first in self.admitted]
        return {
            "gen_tok_per_s": (self.first_tokens + self.decode_tokens) / self.wall,
            "tpot_p90_ms": 1e3 * stats.percentile(tpot, 90) if tpot else None,
            "ttft_p90_ms": 1e3 * stats.percentile(ttft, 90) if ttft else None,
        }

    def facts(self) -> dict:
        cfg, kv = self.cfg, KV_BYTES[self.traffic["quantized_cache"]]
        qmm_bound_s = step_bound_s = 0.0
        for plens in self.admissions:
            qmm_bound_s += work.linear_bound_s(cfg, sum(plens))
            step_bound_s += work.admission_work(cfg, plens)["step"].bound_s
        for ctx in self.step_contexts:
            qmm_bound_s += work.linear_bound_s(cfg, len(ctx))
            step_bound_s += work.decode_step_work(cfg, ctx, kv)["step"].bound_s
        return {
            "kind": "serve",
            "wall_s": self.wall,
            "slots": self.traffic["slots"],
            "decode_tokens": self.decode_tokens,
            "decode_steps": self.steps,
            "admit_s": self.admit_s,
            "launches": self.launches,
            "qmm_bound_s": qmm_bound_s,
            "step_bound_s": step_bound_s,
        }

    def release(self) -> None:
        del self.engine, self.params

    def outcomes(self):
        return len(self.admitted), 0

    def check(self) -> dict:
        """`served_gap`: over every served token of the sampled requests, the
        widest gap between the reference's best logit and the served
        token's, on the same prefix (the reference's fp32 logits)."""
        n = min(self.traffic["check_requests"], len(self.finished))
        if n == 0:
            return {"served_gap": float("inf")}
        lengths = [len(f[3]) + len(f[4]) for f in self.finished]
        longest = int(np.argmax(lengths))
        rest = [i for i in range(len(self.finished)) if i != longest]
        rng = np.random.default_rng(seed_words(self.seed, 4))
        picks = [longest] + rng.choice(rest, n - 1, replace=False).tolist()
        reqs = [self.finished[i] for i in picks]
        seqs = [prompt + gen[:-1] for _, _, _, prompt, gen in reqs]
        width = max(map(len, seqs))
        toks = torch.zeros((n, width), dtype=torch.long)
        for row, s in enumerate(seqs):
            toks[row, :len(s)] = torch.tensor(s)
        ref = Reference(self.cfg, self.seed, self.device)
        hidden = ref.hidden(toks)
        widest, served, total = 0.0, 0, 0.0
        for row, (_, _, _, prompt, gen) in enumerate(reqs):
            pos = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(gen), device=hidden.device)
            logits = ref.logits(hidden[row, pos])
            got = logits.gather(-1, torch.tensor(gen, device=logits.device)[:, None])[:, 0]
            gaps = logits.max(-1).values - got
            gap = gaps.max().item()
            log(f"request {reqs[row][0]}: prompt {len(prompt)} served {len(gen)} gap {gap!r} "
                f"off the best {int((gaps > 0).sum())}")
            widest, served, total = max(widest, gap), served + len(gen), total + gaps.sum().item()
        samples_line({"requests_checked": n, "served_tokens_checked": served})
        log(f"mean gap a served token {total / served!r}")
        return {"served_gap": widest}
