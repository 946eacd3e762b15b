"""Pluggable LM adapters (port of
`llama3_quantization_tpu/eval/harness/models.py`; the reference's
`lm_eval/models/__init__.py:7-15`).

The reference registry exposes HF causal models (`gpt2.py`,
`huggingface.py`), the OpenAI completions API (`gpt3.py`), the TextSynth
API (`textsynth.py`) and a dummy LM. The port's native engine is
`TorchLM` (`lm.py`); the adapters here cover the rest of the registry:

- `HFCausalLM` / `HFSeq2SeqLM` drive a `transformers`-style model (any
  `nn.Module` whose call returns `.logits`) through the same request
  engine (the `hf-causal` / `gpt2` / `hf-seq2seq` registry rows). A model
  the caller gives is run where it is: inputs go to
  `next(model.parameters()).device`, and the model is never moved (one
  without parameters runs on `device`). A model loaded by `pretrained=`
  (the only use of `transformers`) is put on `device`, the card unless
  the caller passes `device="cpu"`.
- `GPT3LM` / `TextSynthLM` are HTTP completions adapters whose transport
  is an injectable callable, so tests (and proxies) can substitute one.

Apart from the HF adapters' `device`, the code is the JAX module's, held
equal to it by `tests/test_torch_adapters.py`.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Callable, List, Optional

import numpy as np
import torch

from ...device import resolve_device
from .base import LM
from .lm import BaseLM, get_rolling_token_windows, make_disjoint_window


def _model_device(model, device="cuda") -> torch.device:
    """Where a model's parameters are; for a model without any, `device`."""
    try:
        return next(model.parameters()).device
    except (AttributeError, StopIteration):
        return resolve_device(device)


class HFCausalLM(BaseLM):
    """`lm_eval/models/gpt2.py` HFLM equivalent: local torch causal LM.

    Accepts either a model name (resolved via `transformers.AutoModelForCausalLM`
    / `AutoTokenizer`) or already-constructed model/tokenizer objects — the
    latter keeps tests and air-gapped runs free of hub lookups.
    """

    def __init__(self, model=None, tokenizer=None, pretrained: Optional[str] = None,
                 batch_size: int = 8, max_length: Optional[int] = None,
                 device="cuda"):
        if model is None:
            dev = resolve_device(device)
            from transformers import AutoModelForCausalLM, AutoTokenizer

            model = AutoModelForCausalLM.from_pretrained(pretrained).to(dev)
            tokenizer = AutoTokenizer.from_pretrained(pretrained)
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self._torch = torch
        self.device = _model_device(model, device)
        if max_length is not None:
            self.max_length = max_length
        else:
            n_pos = getattr(getattr(model, "config", None), "max_position_embeddings", None)
            if n_pos:
                self.max_length = int(n_pos)

    @property
    def eot_token_id(self) -> int:
        eos = getattr(self.tokenizer, "eos_token_id", None)
        return int(eos) if eos is not None else 0

    def tok_encode(self, string: str) -> List[int]:
        return self.tokenizer.encode(string)

    def tok_decode(self, tokens) -> str:
        return self.tokenizer.decode(tokens)

    def _score_tokens(self, inps, targets, mask):
        torch = self._torch
        with torch.no_grad():
            logits = self.model(torch.as_tensor(np.asarray(inps), dtype=torch.long,
                                                 device=self.device)).logits
            logprobs = torch.log_softmax(logits.float(), dim=-1)
            tgt = torch.as_tensor(np.asarray(targets), dtype=torch.long, device=self.device)
            msk = torch.as_tensor(np.asarray(mask), device=self.device)
            picked = logprobs.gather(-1, tgt[..., None])[..., 0]
            lls = (picked * msk).sum(-1)
            greedy = logprobs.argmax(-1) == tgt
            greedy_ok = ((greedy | (msk == 0)).all(-1))
        return lls.cpu().numpy(), greedy_ok.cpu().numpy()

    def _model_generate(self, context: List[int], max_gen: int, stops: List[str]) -> str:
        torch = self._torch
        toks = list(context)
        with torch.no_grad():
            for _ in range(max_gen):
                inp = torch.as_tensor([toks[-self.max_length:]], dtype=torch.long,
                                      device=self.device)
                nxt = int(self.model(inp).logits[0, -1].argmax())
                if nxt == self.eot_token_id:
                    break  # EOS itself is not part of the generation
                toks.append(nxt)
                if any(s in self.tok_decode(toks[len(context):]) for s in stops):
                    break
        return self.tok_decode(toks[len(context):])


class HFSeq2SeqLM(LM):
    """`lm_eval/models/huggingface.py` AutoSeq2SeqLM equivalent: encoder-
    decoder scoring where the context feeds the encoder and the
    continuation is scored by the decoder (covers the reference's T0-style
    special case, `models/LMClass.py:35-39`)."""

    def __init__(self, model=None, tokenizer=None, pretrained: Optional[str] = None,
                 batch_size: int = 8, max_length: int = 512,
                 device="cuda"):
        if model is None:
            dev = resolve_device(device)
            from transformers import AutoModelForSeq2SeqLM, AutoTokenizer

            model = AutoModelForSeq2SeqLM.from_pretrained(pretrained).to(dev)
            tokenizer = AutoTokenizer.from_pretrained(pretrained)
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length
        self._torch = torch
        self.device = _model_device(model, device)

    def _score_pair(self, context: str, continuation: str):
        torch = self._torch
        enc = self.tokenizer.encode(context)[-self.max_length:]
        if not enc:  # empty context: encoder still needs one token
            pad = getattr(self.tokenizer, "pad_token_id", None)
            enc = [int(pad) if pad is not None else 0]
        dec = self.tokenizer.encode(continuation)[: self.max_length]
        if not dec:  # nothing to score
            return 0.0, True
        with torch.no_grad():
            logits = self.model(
                input_ids=torch.as_tensor([enc], dtype=torch.long, device=self.device),
                labels=torch.as_tensor([dec], dtype=torch.long, device=self.device),
            ).logits
            logprobs = torch.log_softmax(logits.float(), dim=-1)[0, : len(dec)]
            tgt = torch.as_tensor(dec, dtype=torch.long, device=self.device)
            ll = float(logprobs.gather(-1, tgt[:, None])[:, 0].sum())
            greedy = bool((logprobs.argmax(-1) == tgt).all())
        return ll, greedy

    def loglikelihood(self, requests):
        return [self._score_pair(ctx, cont) for ctx, cont in requests]

    def loglikelihood_rolling(self, requests):
        # no causal factorization over one stream in an encoder-decoder;
        # score each doc as (empty context -> doc) like the upstream adapter
        return [self._score_pair("", r if isinstance(r, str) else r[0])[0] for r in requests]

    def greedy_until(self, requests):
        torch = self._torch
        res = []
        for context, until in requests:
            if isinstance(until, str):
                until = [until]
            enc = self.tokenizer.encode(context)[-self.max_length:]
            with torch.no_grad():
                out = self.model.generate(
                    torch.as_tensor([enc], dtype=torch.long, device=self.device),
                    max_new_tokens=256, do_sample=False,
                )
            # drop decoder-start/pad/eos token text from the generation
            try:
                text = self.tokenizer.decode(out[0].tolist(), skip_special_tokens=True)
            except TypeError:  # non-HF test tokenizers have no specials
                text = self.tokenizer.decode(out[0].tolist())
            for stop in until:
                text = text.split(stop)[0]
            res.append(text)
        return res


def _default_http(url: str, payload: dict, headers: dict) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json", **headers}
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


class GPT3LM(LM):
    """OpenAI completions adapter (`lm_eval/models/gpt3.py`): scores via
    `echo=True, logprobs=1` and reads continuation logprobs back from the
    response's token offsets."""

    def __init__(self, engine: str = "davinci", tokenizer=None,
                 api_key: Optional[str] = None,
                 base_url: str = "https://api.openai.com/v1",
                 http: Callable[[str, dict, dict], dict] = _default_http,
                 max_length: int = 2048):
        self.engine = engine
        self.tokenizer = tokenizer  # needed only for rolling windows
        self.api_key = api_key or os.environ.get("OPENAI_API_SECRET_KEY", "")
        self.base_url = base_url.rstrip("/")
        self.http = http
        self.max_length = max_length

    def _complete(self, **payload) -> dict:
        return self.http(
            f"{self.base_url}/completions",
            {"model": self.engine, **payload},
            {"Authorization": f"Bearer {self.api_key}"},
        )

    def _score_one(self, context: str, continuation: str):
        full = context + continuation
        resp = self._complete(prompt=full, max_tokens=0, echo=True, logprobs=1)
        ch = resp["choices"][0]["logprobs"]
        offsets, logprobs, tokens = ch["text_offset"], ch["token_logprobs"], ch["tokens"]
        # first token index belonging to the continuation
        start = next((i for i, off in enumerate(offsets) if off >= len(context)), len(tokens))
        ll = sum(lp for lp in logprobs[start:] if lp is not None)
        top = ch.get("top_logprobs") or []
        greedy = all(
            top[i] and tokens[i] == max(top[i], key=top[i].get)
            for i in range(start, len(tokens))
            if i < len(top)
        )
        return float(ll), bool(greedy)

    def loglikelihood(self, requests):
        return [self._score_one(ctx, cont) for ctx, cont in requests]

    def loglikelihood_rolling(self, requests):
        if self.tokenizer is None:
            raise ValueError("rolling loglikelihood needs a tokenizer for window math")
        out = []
        for (string,) in [(r,) if isinstance(r, str) else r for r in requests]:
            total = 0.0
            for ctx_toks, cont_toks in (
                make_disjoint_window(w)
                for w in get_rolling_token_windows(
                    self.tokenizer.encode(string),
                    # EOT prefix, as in the reference gpt3 adapter
                    # (`lm_eval/models/gpt3.py` uses eot 50256)
                    prefix_token=getattr(self.tokenizer, "eot_token_id", 0),
                    max_seq_len=self.max_length,
                    context_len=1,
                )
            ):
                ll, _ = self._score_one(
                    self.tokenizer.decode(ctx_toks), self.tokenizer.decode(cont_toks)
                )
                total += ll
            out.append(total)
        return out

    def greedy_until(self, requests):
        res = []
        for context, until in requests:
            if isinstance(until, str):
                until = [until]
            resp = self._complete(prompt=context, max_tokens=256, temperature=0.0, stop=until)
            res.append(resp["choices"][0]["text"])
        return res


class TextSynthLM(LM):
    """TextSynth adapter (`lm_eval/models/textsynth.py`): the server
    tokenizes, so loglikelihood posts (context, continuation) pairs to the
    `/logprob` endpoint; rolling loglikelihood is unsupported upstream and
    here."""

    def __init__(self, engine: str = "gptj_6B", api_key: Optional[str] = None,
                 base_url: str = "https://api.textsynth.com",
                 http: Callable[[str, dict, dict], dict] = _default_http):
        self.engine = engine
        self.api_key = api_key or os.environ.get("TEXTSYNTH_API_SECRET_KEY", "")
        self.base_url = base_url.rstrip("/")
        self.http = http

    def _post(self, endpoint: str, payload: dict) -> dict:
        return self.http(
            f"{self.base_url}/v1/engines/{self.engine}/{endpoint}",
            payload,
            {"Authorization": f"Bearer {self.api_key}"},
        )

    def loglikelihood(self, requests):
        out = []
        for context, continuation in requests:
            resp = self._post("logprob", {"context": context, "continuation": continuation})
            out.append((float(resp["logprob"]), bool(resp["is_greedy"])))
        return out

    def loglikelihood_rolling(self, requests):
        raise NotImplementedError(
            "textsynth API exposes no tokenization; rolling windows unavailable"
        )

    def greedy_until(self, requests):
        res = []
        for context, until in requests:
            if isinstance(until, str):
                until = [until]
            resp = self._post("completions", {"prompt": context, "max_tokens": 256, "stop": until})
            res.append(resp["text"])
        return res
