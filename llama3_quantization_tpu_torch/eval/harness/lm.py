"""LM request engines (port of `llama3_quantization_tpu/eval/harness/lm.py`).

`Reorderer`, `get_rolling_token_windows`, `make_disjoint_window` and
`BaseLM` are copies of the JAX package's (held equal to them by
`tests/test_torch_harness.py`): the reference's batched request engine
(`models/models_utils.py:157-594`, `lm_eval/base.py:120-369`),
length-descending reordering, left truncation to `max_length + 1`, right
padding, log-softmax + continuation gather + greedy match, rolling
windows for perplexity requests.

`DummyLM` is a copy of the JAX package's. `TorchLM` is the port's
counterpart of `JAXLM`: it scores each padded batch with one
`forward_logits` at a power-of-two bucket of positions (capped at
`max_length + 1`, as JAX buckets its compiled shapes), and generates
greedily through `decode_step` on a fresh fp KV cache.
`Seq2SeqTorchLM` is the counterpart of `Seq2SeqJAXLM`, over the T5
encoder-decoder trunk (`models/seq2seq.py`).
"""

from __future__ import annotations

import abc
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ...models.seq2seq import (
    _pad_mask,
    decode_logits,
    encode,
    greedy_generate_seq2seq_cached,
)
from ...models.transformer import NO_QUANT, decode_step, forward_logits, init_kv_cache
from ...ops.padding import pad_for_kernels
from ..data import bucket_pow2
from ..ppl import params_device
from .base import LM


class Reorderer:
    """Sort requests (by descending total length) and restore order
    (`models/models_utils.py:544-568`)."""

    def __init__(self, arr, fn):
        self.size = len(arr)
        self.arr = sorted(enumerate(arr), key=lambda x: fn(x[1]))

    def get_reordered(self):
        return [x for _, x in self.arr]

    def get_original(self, newarr):
        res = [None] * self.size
        for (i, _), v in zip(self.arr, newarr):
            res[i] = v
        return res


def get_rolling_token_windows(
    token_list: List[int], prefix_token: int, max_seq_len: int, context_len: int
) -> Iterable[Tuple[List[int], List[int]]]:
    """Rolling (context, prediction) windows over a long token stream
    (`models/models_utils.py:503-541`)."""
    if not token_list:
        return
    pred_len = max_seq_len - context_len + 1
    predicted = 0
    first_seq_len = min(max_seq_len, len(token_list))
    yield ([prefix_token] + token_list[: first_seq_len - 1], token_list[:first_seq_len])
    predicted += first_seq_len
    while predicted < len(token_list):
        window_pred_len = min(len(token_list) - predicted, pred_len)
        window_end = predicted + window_pred_len
        yield (
            token_list[window_end - max_seq_len - 1 : window_end - 1],
            token_list[window_end - window_pred_len : window_end],
        )
        predicted += window_pred_len


def make_disjoint_window(pair):
    """Trim context so windows are disjoint (`models/models_utils.py` use)."""
    a, b = pair
    return a[: len(a) - (len(b) - 1)] if len(b) > 1 else a, b


class BaseLM(LM):
    """Request engine; concrete subclasses provide tokenization +
    `_score_tokens`."""

    batch_size: int = 8
    max_length: int = 2048

    @property
    @abc.abstractmethod
    def eot_token_id(self) -> int: ...

    @abc.abstractmethod
    def tok_encode(self, string: str) -> List[int]: ...

    @abc.abstractmethod
    def tok_decode(self, tokens: List[int]) -> str: ...

    @abc.abstractmethod
    def _score_tokens(
        self, inps: np.ndarray, targets: np.ndarray, mask: np.ndarray
    ) -> tuple:
        """inps/targets/mask [B, S] right-padded; returns (ll_sums [B],
        greedy_ok [B]) — summed target logprobs and whether every masked
        target is the argmax. Device-side gather: only [B] scalars cross
        the host boundary (a [B, S, V] logprob transfer is ~8 GB/batch at
        Llama-3 vocab)."""

    @abc.abstractmethod
    def _model_generate(self, context: List[int], max_gen: int, stops: List[str]) -> str: ...

    # ------------------------------------------------------------------
    def loglikelihood(self, requests):
        new_reqs = []
        for context, continuation in requests:
            if context == "":
                context_enc = [self.eot_token_id]
            else:
                context_enc = self.tok_encode(context)
            continuation_enc = self.tok_encode(continuation)
            new_reqs.append(((context, continuation), context_enc, continuation_enc))
        return self._loglikelihood_tokens(new_reqs)

    def loglikelihood_rolling(self, requests):
        loglikelihoods = []
        for (string,) in [(r,) if isinstance(r, str) else r for r in requests]:
            windows = [
                make_disjoint_window(w)
                for w in get_rolling_token_windows(
                    self.tok_encode(string),
                    prefix_token=self.eot_token_id,
                    max_seq_len=self.max_length,
                    context_len=1,
                )
            ]
            windows = [(None, ctx, cont) for ctx, cont in windows]
            scores = self._loglikelihood_tokens(windows, disable_reorder=True)
            loglikelihoods.append(sum(s[0] for s in scores))
        return loglikelihoods

    max_gen_toks = 256

    def greedy_until(self, requests):
        res = []
        for context, until in requests:
            if isinstance(until, str):
                until = [until]
            # leave room for generation inside the position table (the
            # reference truncates to max_length - max_gen_toks,
            # `models/models_utils.py:434-472`); tiny test configs whose
            # max_length <= max_gen_toks keep at least half for context
            keep = max(self.max_length - self.max_gen_toks, self.max_length // 2)
            context_enc = self.tok_encode(context)[-keep:]
            out = self._model_generate(context_enc, self.max_gen_toks, until)
            for stop in until:
                out = out.split(stop)[0]
            res.append(out)
        return res

    # ------------------------------------------------------------------
    def _loglikelihood_tokens(self, requests, disable_reorder: bool = False):
        reord = Reorderer(
            requests, (lambda x: 0) if disable_reorder else (lambda x: -(len(x[1]) + len(x[2])))
        )
        ordered = reord.get_reordered() if not disable_reorder else requests
        results = []
        for start in range(0, len(ordered), self.batch_size):
            chunk = ordered[start : start + self.batch_size]
            seqs = [
                (list(context_enc) + list(continuation_enc))[-(self.max_length + 1) :]
                for _, context_enc, continuation_enc in chunk
            ]
            contlens = [len(c[2]) for c in chunk]
            maxlen = max(len(s) - 1 for s in seqs)
            b = len(chunk)
            inp = np.zeros((b, maxlen), dtype=np.int32)
            tgt = np.zeros((b, maxlen), dtype=np.int32)
            mask = np.zeros((b, maxlen), dtype=np.float32)
            for i, seq in enumerate(seqs):
                L = len(seq) - 1
                inp[i, :L] = seq[:-1]
                tgt[i, :L] = seq[1:]
                # left truncation can eat into a continuation longer than
                # the window; score whatever part survived
                cl = min(contlens[i], L)
                mask[i, L - cl : L] = 1.0
            lls, greedy_ok = self._score_tokens(inp, tgt, mask)
            for i in range(b):
                results.append((float(lls[i]), bool(greedy_ok[i])))
        return reord.get_original(results) if not disable_reorder else results


class TorchLM(BaseLM):
    """Concrete LM over the port's functional models (`JAXLM`,
    `eval/harness/lm.py:182-299`), on `device` (default: the params').
    Weights on the card that a kernel does not take are padded once, here
    (`ops/padding.pad_for_kernels`)."""

    def __init__(
        self,
        params,
        cfg,
        tokenizer,
        rq=None,
        batch_size: int = 8,
        max_length: Optional[int] = None,
        device=None,
    ):
        self.params = pad_for_kernels(params)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.rq = rq or NO_QUANT
        self.batch_size = batch_size
        self.max_length = max_length or min(cfg.max_position_embeddings, 2048)
        self.device = torch.device(device) if device is not None else params_device(params)

    @property
    def eot_token_id(self) -> int:
        return getattr(self.tokenizer, "eot_token_id", getattr(self.tokenizer, "bos_id", 0))

    def tok_encode(self, string: str) -> List[int]:
        # never add specials inside request scoring: a BOS spliced into a
        # continuation corrupts every loglikelihood (`models/LMClass.py:81-88`)
        try:
            ids = self.tokenizer.encode(string, add_special_tokens=False)
        except TypeError:  # tokenizers without the kwarg add none anyway
            ids = self.tokenizer.encode(string)
        return list(map(int, ids))

    def tok_decode(self, tokens) -> str:
        return self.tokenizer.decode(list(tokens))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _score_tokens(self, inps: np.ndarray, targets: np.ndarray, mask: np.ndarray):
        """fp32 log-probs of the targets from one `forward_logits` over the
        batch right-padded (with token 0) to `min(bucket_pow2(S),
        max_length + 1)` positions: the masked sum per row and whether
        every masked target is the argmax (`lm.py:242-259`)."""
        b, s = inps.shape
        sb = min(bucket_pow2(s), self.max_length + 1)

        def pad(a):
            out = np.zeros((b, sb), dtype=a.dtype)
            out[:, :s] = a
            return self._to_device(out)

        inp, tgt, msk = pad(inps.astype(np.int64)), pad(targets.astype(np.int64)), pad(mask)
        with torch.inference_mode():
            logits = forward_logits(self.params, inp, self.cfg, self.rq).float()
            logz = torch.logsumexp(logits, dim=-1)
            tok_lp = torch.gather(logits, -1, tgt[..., None])[..., 0] - logz
            lls = (tok_lp * msk).sum(dim=-1)
            greedy = logits.argmax(dim=-1) == tgt
            greedy_ok = torch.where(msk > 0, greedy, True).all(dim=-1)
        return lls.cpu().numpy(), greedy_ok.cpu().numpy()

    def _model_generate(self, context: List[int], max_gen: int, stops: List[str]) -> str:
        """Greedy text after `context` (`lm.py:261-299`): the context,
        right-padded to its power-of-two bucket, prefills a fresh fp cache
        (`init_kv_cache`'s default, `cfg.dtype`) of `bucket(bucket(n) +
        max_gen)` slots through `decode_step`; then one token a step until
        a stop string shows in the decoded text or `max_gen` tokens."""
        n_ctx = len(context)
        ctx_b = bucket_pow2(n_ctx)
        cache = init_kv_cache(self.cfg, 1, bucket_pow2(ctx_b + max_gen), device=self.device)
        padded = np.zeros((1, ctx_b), dtype=np.int64)
        padded[0, :n_ctx] = context
        with torch.inference_mode():
            logits, cache = decode_step(self.params, cache, self._to_device(padded), 0,
                                        self.cfg, self.rq)
            nxt = int(logits[0, n_ctx - 1].argmax())
            pos, out_tokens, text = n_ctx, [], ""
            for _ in range(max_gen):
                out_tokens.append(nxt)
                text = self.tok_decode(out_tokens)
                if any(stop in text for stop in stops):
                    break
                tok = torch.tensor([[nxt]], dtype=torch.long, device=self.device)
                logits, cache = decode_step(self.params, cache, tok, pos, self.cfg, self.rq)
                nxt = int(logits[0, -1].argmax())
                pos += 1
        return text


class Seq2SeqTorchLM(BaseLM):
    """T5-family request engine over the encoder-decoder trunk
    (`Seq2SeqJAXLM`, `eval/harness/lm.py:321-461`): the context feeds the
    encoder, the continuation is scored by the teacher-forced decoder (the
    reference's hf-seq2seq semantics). Weights on the card that a kernel
    does not take are padded once, here (`ops/padding.pad_for_kernels`)."""

    def __init__(
        self,
        params,
        cfg,
        tokenizer,
        rq=None,
        batch_size: int = 8,
        max_length: Optional[int] = None,
        device=None,
    ):
        self.params = pad_for_kernels(params)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.rq = rq or NO_QUANT
        self.batch_size = batch_size
        self.max_length = max_length or 512
        self.device = torch.device(device) if device is not None else params["shared"].device

    @property
    def eot_token_id(self) -> int:
        return self.cfg.eos_token_id

    def tok_encode(self, string: str) -> List[int]:
        try:
            ids = self.tokenizer.encode(string, add_special_tokens=False)
        except TypeError:
            ids = self.tokenizer.encode(string)
        return list(map(int, ids))

    def tok_decode(self, tokens) -> str:
        return self.tokenizer.decode(list(tokens))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _score_tokens(self, inps, targets, mask):
        raise NotImplementedError("seq2seq scores (enc, dec) pairs")

    def _score(self, enc, dec, tgt, msk):
        """(ll sums [B], greedy_ok [B]) of the targets under one teacher-forced
        forward, in fp32 (`lm.py:353-363`)."""
        enc, dec, tgt, msk = (self._to_device(a) for a in (enc, dec, tgt, msk))
        with torch.inference_mode():
            enc_mask = _pad_mask(enc, self.cfg.pad_token_id)
            enc_h = encode(self.params, enc, self.cfg, self.rq, enc_mask)
            logits = decode_logits(self.params, dec, enc_h, self.cfg, self.rq, enc_mask).float()
            logz = torch.logsumexp(logits, dim=-1)
            tok_lp = torch.gather(logits, -1, tgt[..., None])[..., 0] - logz
            lls = (tok_lp * msk).sum(dim=-1)
            greedy = logits.argmax(dim=-1) == tgt
            greedy_ok = torch.where(msk > 0, greedy, True).all(dim=-1)
        return lls.cpu().numpy(), greedy_ok.cpu().numpy()

    def _loglikelihood_tokens(self, requests, disable_reorder: bool = False):
        """Seq2seq batching (`lm.py:391-430`): the encoder takes the context
        (its last `max_length` tokens), the decoder input is the start token
        then the continuation shifted right, every continuation token is
        scored; both padded to power-of-two buckets."""
        reord = Reorderer(
            requests, (lambda x: 0) if disable_reorder else (lambda x: -(len(x[1]) + len(x[2])))
        )
        ordered = reord.get_reordered() if not disable_reorder else requests
        results = []
        start_id, pad_id = self.cfg.decoder_start_token_id, self.cfg.pad_token_id
        for s0 in range(0, len(ordered), self.batch_size):
            chunk = ordered[s0 : s0 + self.batch_size]
            b = len(chunk)
            encs = [list(c[1])[-self.max_length:] for c in chunk]
            conts = [list(c[2])[: self.max_length] for c in chunk]
            el = bucket_pow2(max(max(len(e) for e in encs), 1))
            dl = bucket_pow2(max(max(len(c) for c in conts), 1))
            enc = np.full((b, el), pad_id, np.int64)
            dec = np.full((b, dl), pad_id, np.int64)
            tgt = np.zeros((b, dl), np.int64)
            msk = np.zeros((b, dl), np.float32)
            for i, (e, c) in enumerate(zip(encs, conts)):
                enc[i, : len(e)] = e
                dec[i, 0] = start_id
                dec[i, 1 : len(c)] = c[:-1]
                tgt[i, : len(c)] = c
                msk[i, : len(c)] = 1.0
            lls, ok = self._score(enc, dec, tgt, msk)
            results.extend((float(lls[i]), bool(ok[i])) for i in range(b))
        return reord.get_original(results) if not disable_reorder else results

    def _model_generate(self, context: List[int], max_gen: int, stops: List[str]) -> str:
        """Greedy text after `context` (`lm.py:432-461`): the context,
        padded to its power-of-two bucket, through
        `greedy_generate_seq2seq_cached` for `min(max_gen, 64)` steps, cut
        at EOS, then at the stop strings."""
        el = bucket_pow2(max(len(context), 1))
        enc = np.full((1, el), self.cfg.pad_token_id, np.int64)
        enc[0, : len(context)] = context[-el:]
        with torch.inference_mode():
            toks = greedy_generate_seq2seq_cached(self.params, self._to_device(enc),
                                                  min(max_gen, 64), self.cfg, self.rq)[0]
        out = []
        for t in toks.tolist():
            if t == self.cfg.eos_token_id:
                break
            out.append(t)
        text = self.tok_decode(out)
        for stop in stops:
            text = text.split(stop)[0]
        return text


class DummyLM(LM):
    """Deterministic fake LM for harness plumbing tests
    (`lm_eval/models/dummy.py:5-36`)."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def loglikelihood(self, requests):
        rng = np.random.default_rng(self.seed)
        return [(-float(rng.random()), False) for _ in requests]

    def loglikelihood_rolling(self, requests):
        rng = np.random.default_rng(self.seed)
        return [-float(rng.random()) for _ in requests]

    def greedy_until(self, requests):
        return ["lol" for _ in requests]
