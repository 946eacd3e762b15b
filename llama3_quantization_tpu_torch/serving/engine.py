"""Continuous-batching serving engine (port of `llama3_quantization_tpu/serving/engine.py`).

The engine keeps a fixed pool of KV-cache slots and advances all active
sequences together:

- `add_request(s)` / `submit` claim free slots; a whole admission batch
  prefills in one forward at a fixed batch of `max_slots` rows, padded to
  the largest prompt-length bucket present, into a memoized scratch cache
  whose rows are then copied into the claimed slots (`_splice`);
- `step()` runs one `decode_step_multi` across all slots, each at its own
  position in its own ring; `step_n(k)` runs a k-token window: the
  windowed decode (`models/windowed.py`) while every active slot's window
  fits the ring, else k per-slot steps;
- finished requests free their slots at once, so new requests join the
  batch without stopping decoding.

`run_pipelined` keeps the host ahead of the card: window i+1 is enqueued
from device-resident tokens before window i's tokens are copied to the
host, and admissions keep their first tokens on the device until the next
collect. Host->device copies go through pinned memory and device->host
copies are waited on by event, so the per-window Python adds no device
sync inside a window.

The slot pool is the fp cache by default (`quantized_cache=False`, bf16
from `cfg.dtype`, decoded per step through B6: the windowed decode takes
quantized caches only), or the int8 (`8`) or int4 (`4`) cache. `rq` is the
runtime fake-quant config every decode and prefill runs under. `fuse=True`
fuses q/k/v and gate/up horizontally (`quant/serving.fuse_for_decode`).
The matmul backend (`ops/matmul.set_backend`) is read at every call; under
"s4" the engine prepares its weights once per backend and keeps them
(`prepare_decode_params`), where JAX re-prepares inside every compiled
window: the prepared weights compute the same numbers, and a repack per
window would cost the port a pass over every weight byte. Sampled streams
come from a `torch.Generator` and do not reproduce JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.configs import ModelConfig
from ..models.transformer import (
    NO_QUANT,
    RuntimeQuantConfig,
    decode_hidden,
    decode_step_multi,
    init_kv_cache,
    lm_head,
    sample_logits,
)
from ..models.windowed import decode_window, windowed_ok
from ..ops.matmul import get_backend, prepare_decode_params
from ..quant.serving import fuse_for_decode


@dataclasses.dataclass
class _Request:
    rid: int
    slot: int
    prompt_len: int
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    eos_id: Optional[int] = None
    done: bool = False
    #: tokens scheduled on the device so far (prefill first token plus
    #: dispatched windows): lets the pipelined loop free budget-bound slots
    #: at dispatch time instead of one window later
    scheduled: int = 0
    #: slot already returned to the free pool (guards the double free when
    #: a pre-freed request's late-collected finish calls _finish)
    freed: bool = False


class ServingEngine:
    def __init__(
        self,
        params,
        cfg: ModelConfig,
        max_slots: int = 8,
        max_len: int = 512,
        rq: RuntimeQuantConfig = NO_QUANT,
        quantized_cache=False,  # False: fp (cfg.dtype); 8 (or True): int8; 4: int4-packed
        sink_tokens: int = 0,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        fuse: bool = False,
        schedule: str = "fifo",
        device="cuda",
    ):
        if schedule not in ("fifo", "ljf"):
            raise ValueError(schedule)
        self.device = resolve_device(device)
        if fuse:
            # horizontal qkv / gate-up fusion: fewer weight dots per step
            params = fuse_for_decode(params, cfg)
        self.params = params
        #: (backend, params prepared for it), built at first use
        self._prepared: Optional[Tuple[str, dict]] = None
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self._quantized_cache = quantized_cache
        self.cache = init_kv_cache(cfg, max_slots, max_len, quantized=quantized_cache,
                                   device=self.device)
        self._scratch: Optional[Dict[str, torch.Tensor]] = None
        self._rq, self._sink_tokens = rq, sink_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.pos = np.zeros(max_slots, np.int64)  # next write position
        self.next_tok = np.zeros(max_slots, np.int64)
        self.free: List[int] = list(range(max_slots))
        self.requests: Dict[int, _Request] = {}
        self._slot_req: Dict[int, int] = {}
        self._next_rid = 0
        #: admission policy for the submit queue: "fifo" (arrival order) or
        #: "ljf" (longest job first by max_new_tokens: shortens the drain
        #: tail when generation budgets are known)
        self.schedule = schedule
        self._queue: List = []  # submitted, not yet admitted
        # async admissions (run_pipelined): first tokens on the device,
        # awaiting host resolution / merging into the next window's tok0
        self._first_pending: List = []
        self._scatter_next: List = []
        #: windows dispatched by route ("windowed" or "per_step"), and the
        #: decode steps they ran ("steps")
        self.dispatches = {"windowed": 0, "per_step": 0, "steps": 0}

    # ------------------------------------------------------------------
    def _params(self):
        """The parameters for the current backend: `prepare_decode_params`
        once per backend, kept for later calls."""
        be = get_backend()
        if self._prepared is None or self._prepared[0] != be:
            self._prepared = (be, prepare_decode_params(self.params))
        return self._prepared[1]

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the device, without waiting for the device: the
        copy is staged in pinned memory and enqueued asynchronously."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _to_host(self, t: torch.Tensor):
        """Start copying `t` to the host; `_fetch` waits for that copy only."""
        if self.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    @staticmethod
    def _fetch(pending) -> np.ndarray:
        host, done = pending
        if done is not None:
            done.synchronize()
        return host.numpy()

    def _batch_cache(self) -> Dict[str, torch.Tensor]:
        """Scratch cache with `max_slots` rows for the batched prefill
        (memoized). The prefill writes every position it then reads, and
        each slot's stale positions stay masked until decode overwrites
        them, so the scratch is never cleared."""
        if self._scratch is None:
            self._scratch = init_kv_cache(
                self.cfg, self.max_slots, self.max_len, quantized=self._quantized_cache,
                device=self.device,
            )
        return self._scratch

    def _splice(self, slot: int, batch_cache: Dict[str, torch.Tensor], row: int) -> None:
        """Copy prefill row `row` into pool slot `slot`, in place, cast to
        the pool's dtype (`serving/engine.py:126-134`)."""
        for k, buf in self.cache.items():
            buf[:, slot].copy_(batch_cache[k][:, row])

    # ------------------------------------------------------------------
    def _bucket(self, prompt_len: int) -> int:
        # pad to a power-of-2 bucket; padded positions sit at >= prompt_len,
        # which the position mask excludes until real writes replace them
        bucket = 16
        while bucket < prompt_len:
            bucket *= 2
        return min(bucket, self.max_len - 1)

    def _prefill(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One prefill of `batch` [(prompt, max_new, eos_id)] at a fixed
        `max_slots` rows. Returns (first tokens [max_slots] on the device,
        the scratch cache). Only each row's last prompt position goes
        through the lm_head, at a fixed M = max_slots."""
        bucket = self._bucket(max(len(p) for p, _, _ in batch))
        npad = self.max_slots
        toks = np.zeros((npad, bucket), np.int64)
        last = np.zeros(npad, np.int64)
        for row, (prompt, _, _) in enumerate(batch):
            toks[row, : len(prompt)] = np.asarray(prompt, np.int64)
            last[row] = len(prompt) - 1
        cache = self._batch_cache()
        h = decode_hidden(self._params(), cache, self._to_device(toks), 0, self.cfg, self._rq,
                          self._sink_tokens)
        h_last = h[torch.arange(npad, device=self.device), self._to_device(last)]
        logits = lm_head(self._params(), h_last[:, None], self.cfg)[:, 0]
        return self._pick(logits), cache

    def _check_prompts(self, batch) -> None:
        for prompt, _, _ in batch:
            if len(prompt) >= self.max_len:
                raise ValueError(
                    f"prompt of {len(prompt)} tokens does not fit max_len={self.max_len}; "
                    "truncate explicitly or raise max_len"
                )

    def _claim(self, prompt, max_new: int, eos_id, generated: List[int]) -> _Request:
        slot = self.free.pop()
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, slot, len(prompt), max_new, generated, eos_id, scheduled=1)
        self.requests[rid] = req
        self._slot_req[slot] = rid
        self.pos[slot] = len(prompt)
        return req

    def add_request(
        self, prompt_tokens: Sequence[int], max_new_tokens: int = 64, eos_id: Optional[int] = None
    ) -> int:
        """Claim a slot, prefill, return the request id."""
        return self.add_requests([(prompt_tokens, max_new_tokens, eos_id)])[0]

    def add_requests(self, requests) -> List[int]:
        """Admit a batch of (prompt_tokens, max_new_tokens, eos_id) at once:
        one prefill at the fixed batch of `max_slots` rows and the largest
        bucket present; row i is spliced into its slot, padded rows are
        discarded. The first tokens come to the host in one transfer."""
        if len(requests) > len(self.free):
            raise RuntimeError(f"{len(requests)} requests for {len(self.free)} free slots")
        self._check_prompts(requests)
        if not requests:
            return []
        nxts_dev, batch_cache = self._prefill(requests)
        nxts = nxts_dev.cpu().numpy()
        rids = []
        for row, (prompt, max_new, eos_id) in enumerate(requests):
            nxt = int(nxts[row])
            req = self._claim(prompt, max_new, eos_id, [nxt])
            self._splice(req.slot, batch_cache, row)
            self.next_tok[req.slot] = nxt
            if eos_id is not None and nxt == eos_id:
                self._finish(req)
            rids.append(req.rid)
        return rids

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy by default; seeded sampling when temperature > 0."""
        return sample_logits(logits, self._gen, self.temperature, self.top_k, self.top_p)

    def _finish(self, req: _Request) -> None:
        req.done = True
        self._release_slot(req)

    def _release_slot(self, req: _Request) -> None:
        if not req.freed:
            req.freed = True
            self._slot_req.pop(req.slot, None)
            self.free.append(req.slot)

    def _prefree_scheduled(self) -> None:
        """Free slots whose request is fully scheduled on the device (budget
        bound, no eos): the in-flight window already holds its final
        tokens, so the slot can take a new admission now. Token bookkeeping
        still happens at collect time (`freed` guards the double free)."""
        for slot, rid in list(self._slot_req.items()):
            req = self.requests[rid]
            if req.eos_id is None and req.scheduled >= req.max_new_tokens:
                self._release_slot(req)

    def _is_final(self, req: _Request, tok: int) -> bool:
        return (req.eos_id is not None and tok == req.eos_id) or len(
            req.generated
        ) >= req.max_new_tokens

    # ------------------------------------------------------------------
    def step(self) -> Dict[int, int]:
        """Advance every active sequence one token; returns {rid: token}."""
        if not self._slot_req:
            return {}
        tokens = self._to_device(self.next_tok[:, None])
        pos = self._to_device(self.pos)
        logits, _ = decode_step_multi(self._params(), self.cache, tokens, pos, self.cfg,
                                      self._rq, self._sink_tokens)
        nxt = self._pick(logits[:, 0, :]).cpu().numpy()
        out: Dict[int, int] = {}
        for slot, rid in list(self._slot_req.items()):
            req = self.requests[rid]
            tok = int(nxt[slot])
            req.generated.append(tok)
            self.pos[slot] += 1
            self.next_tok[slot] = tok
            out[rid] = tok
            if self._is_final(req, tok):
                self._finish(req)
        return out

    def step_n(self, k: int) -> Dict[int, List[int]]:
        """Advance every active sequence up to k tokens in one window.
        Finishes (eos / max_new_tokens) are processed at the window
        boundary: a slot that finishes mid-window ignores its trailing
        tokens, and slot reuse splices a fresh prefill over whatever the
        dead steps wrote."""
        if not self._slot_req:
            return {}
        tok0 = self._to_device(self.next_tok[:, None])
        pos0 = self._to_device(self.pos)
        toks = self._dispatch_window(k, tok0, pos0)
        return self._collect_step_n(toks.cpu().numpy(), k)

    def _collect_step_n(self, toks: np.ndarray, k: int) -> Dict[int, List[int]]:
        """Distribute a [k, B] token window to requests; finishes at the
        window boundary (mid-window finishers drop trailing tokens)."""
        out: Dict[int, List[int]] = {}
        for slot, rid in list(self._slot_req.items()):
            req = self.requests[rid]
            taken: List[int] = []
            for i in range(k):
                tok = int(toks[i, slot])
                req.generated.append(tok)
                taken.append(tok)
                self.pos[slot] += 1
                self.next_tok[slot] = tok
                if self._is_final(req, tok):
                    self._finish(req)
                    break
            out[rid] = taken
        return out

    def _dispatch_window(self, k: int, tok0: torch.Tensor, pos0: torch.Tensor) -> torch.Tensor:
        """Enqueue one k-step window without fetching its result: the
        windowed decode when every active slot's window fits the ring, else
        k `decode_step_multi` steps. Returns the device tokens [k, B]."""
        active = list(self._slot_req)
        fits_ring = k < self.max_len and all(self.pos[s] + k <= self.max_len for s in active)
        self.dispatches["steps"] += k
        params = self._params()
        if fits_ring and windowed_ok(self.cfg, self.cache, self._rq, self._sink_tokens):
            self.dispatches["windowed"] += 1
            toks, _ = decode_window(
                params, self.cache, tok0, pos0, k, self.cfg, self._rq, generator=self._gen,
                temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
                sink_tokens=self._sink_tokens,
            )
            return toks.T
        self.dispatches["per_step"] += 1
        out = []
        tok, pos = tok0, pos0
        for _ in range(k):
            logits, _ = decode_step_multi(params, self.cache, tok, pos, self.cfg, self._rq,
                                          self._sink_tokens)
            nxt = self._pick(logits[:, 0, :])
            out.append(nxt)
            tok, pos = nxt[:, None], pos + 1
        return torch.stack(out)

    def run_pipelined(self, step_tokens: int, max_windows: int = 10**6) -> None:
        """Continuous batching with the host ahead of the device: window i+1
        is enqueued from device-resident tokens before window i's tokens
        are fetched (`serving/engine.py:433-582`).

        Greedy streams match the sequential `step_n` loop when the two
        partition each request into the same windows; only when the host
        learns of a finish changes. Budget-bound requests (eos_id=None) are
        freed at dispatch time of their final window (`_prefree_scheduled`);
        eos finishes are discovered one window late. The drain tail clamps
        the window to the largest remaining budget, rounded down into
        `_window_sizes`, and the ring-headroom clamp shrinks windows near
        the ring end so the windowed path keeps fitting."""
        k = step_tokens
        prev = None  # (pending host copy of the tokens, slotmap, k) of the last window
        self._admissions_async()
        dev_last = None  # [B, 1] device tokens chained from the last window
        windows = 0
        while (self._slot_req or prev is not None or self._queue) and windows < max_windows:
            self._prefree_scheduled()  # fully scheduled slots admit now
            self._admissions_async()
            cur = None
            if self._slot_req:
                tok0 = (dev_last if dev_last is not None
                        else torch.zeros((self.max_slots, 1), dtype=torch.long, device=self.device))
                # newly admitted slots take their first tokens straight
                # from the prefill's device result, never fetched
                for nxts_dev, slotmap in self._scatter_next:
                    rows = np.zeros(self.max_slots, np.int64)
                    sel = np.zeros((self.max_slots, 1), bool)
                    for s, (row, _rid) in slotmap.items():
                        rows[s] = row
                        sel[s] = True
                    tok0 = torch.where(self._to_device(sel),
                                       nxts_dev[self._to_device(rows)][:, None], tok0)
                self._scatter_next = []
                pos0 = self._to_device(self.pos)
                # drain-tail clamp: no active request needs more than its
                # remaining budget (eos only finishes earlier)
                rem = [self.requests[rid].max_new_tokens - self.requests[rid].scheduled
                       for rid in self._slot_req.values()]
                target = min(k, max(1, max(rem) if rem else k))
                # ring-headroom clamp: near the ring end, shrink the window so
                # the windowed path keeps fitting; headroom <= 0 means a slot
                # already lives past the ring (per-step path, keep k)
                if windowed_ok(self.cfg, self.cache, self._rq, self._sink_tokens):
                    headroom = int(self.max_len - max(self.pos[s] for s in self._slot_req))
                    if headroom >= 1:
                        target = min(target, headroom)
                k_eff = max(c for c in self._window_sizes(k) if c <= target)
                toks = self._dispatch_window(k_eff, tok0, pos0)
                dev_last = toks[-1][:, None]
                cur = (self._to_host(toks), dict(self._slot_req), k_eff)
                self.pos += k_eff  # every row advances (dead rows are harmless:
                #                    slot reuse splices over their writes)
                for rid in self._slot_req.values():
                    self.requests[rid].scheduled += k_eff
                windows += 1
            if prev is not None:
                pending, slotmap, k_p = prev
                arr = self._fetch(pending)  # window i; the device runs i+1
                self._resolve_first_tokens()
                self._collect_pipelined(arr, k_p, slotmap)
                self._admissions_async()
            prev = cur
        self._resolve_first_tokens()

    @staticmethod
    def _window_sizes(k: int) -> List[int]:
        """Allowed window sizes (ascending): powers of two below k, and k."""
        sizes = []
        c = 1
        while c < k:
            sizes.append(c)
            c *= 2
        sizes.append(k)
        return sizes

    def _collect_pipelined(self, toks: np.ndarray, k: int, slotmap) -> None:
        """Distribute a fetched [k, B] window to the requests that were
        active when it was dispatched (finish bookkeeping only: `pos`
        advanced at dispatch time)."""
        for slot, rid in slotmap.items():
            req = self.requests.get(rid)
            if req is None or req.done:
                continue
            for i in range(k):
                tok = int(toks[i, slot])
                req.generated.append(tok)
                if self._slot_req.get(slot) == rid:
                    # a pre-freed slot may already host a new request whose
                    # next_tok this late collect must not clobber
                    self.next_tok[slot] = tok
                if self._is_final(req, tok):
                    self._finish(req)
                    break

    def _order_queue(self) -> None:
        if self.schedule == "ljf" and len(self._queue) > 1:
            self._queue.sort(key=lambda r: r[1])  # pop() takes the longest

    def _admissions_async(self) -> None:
        """Admit queued requests without any device sync: the prefill's
        first tokens stay on the device, merged into the next window's
        tok0 there and resolved into host bookkeeping at the next collect
        (`_resolve_first_tokens`)."""
        self._order_queue()
        while self.free and self._queue:
            batch = []
            while self.free and len(batch) < len(self.free) and self._queue:
                batch.append(self._queue.pop())
            self._check_prompts(batch)
            nxts_dev, batch_cache = self._prefill(batch)
            slotmap: Dict[int, Tuple[int, int]] = {}
            for row, (prompt, max_new, eos_id) in enumerate(batch):
                req = self._claim(prompt, max_new, eos_id, [])
                self._splice(req.slot, batch_cache, row)
                slotmap[req.slot] = (row, req.rid)
            self._first_pending.append((self._to_host(nxts_dev), slotmap))
            self._scatter_next.append((nxts_dev, slotmap))

    def _resolve_first_tokens(self) -> None:
        """Fold the pending prefill first tokens into request bookkeeping
        (their prefills ran before the window just fetched)."""
        for pending, slotmap in self._first_pending:
            vals = self._fetch(pending)
            for slot, (row, rid) in slotmap.items():
                req = self.requests.get(rid)
                if req is None:
                    continue
                tok = int(vals[row])
                req.generated.append(tok)
                if self._slot_req.get(slot) == rid:
                    self.next_tok[slot] = tok
                if self._is_final(req, tok):
                    self._finish(req)
        self._first_pending = []

    def submit(self, prompt_tokens, max_new_tokens: int = 64, eos_id=None) -> None:
        """Queue a request for admission at the next free-slot window
        boundary (used with `run_pipelined`)."""
        self._queue.append((list(prompt_tokens), max_new_tokens, eos_id))

    def run(self, max_steps: int = 10_000, step_tokens: int = 1) -> None:
        steps = 0
        while self._slot_req and steps < max_steps:
            if step_tokens > 1:
                self.step_n(step_tokens)
            else:
                self.step()
            steps += 1

    def result(self, rid: int) -> List[int]:
        """Generated tokens of a request; a finished request is evicted on
        read so a long-running engine does not keep it forever."""
        req = self.requests[rid]
        if req.done:
            del self.requests[rid]
        return req.generated
