"""Port parity: the LM adapters (`eval/harness/models.py`), `DummyLM` and
`MODEL_REGISTRY`.

- `DummyLM` answers every request type as JAX's does, seed for seed.
- `GPT3LM` and `TextSynthLM` through the fake transports of
  `tests/test_model_adapters.py` give JAX's answers (rolling windows of
  GPT3LM included).
- `HFCausalLM` and `HFSeq2SeqLM` over tiny `transformers` models built
  from a config (no download) give JAX's adapters' answers on the same
  model, and send their inputs to the model's device without moving it;
  with `pretrained=` they load onto the caller's `device`, the card unless
  it is "cpu".
- `MODEL_REGISTRY` has JAX's keys, "torch" (`TorchLM`) where JAX has "jax".
"""

import numpy as np
import pytest
import torch

import test_model_adapters as JMA
from llama3_quantization_tpu.eval import harness as JH
from llama3_quantization_tpu_torch.eval import harness as TH
from llama3_quantization_tpu_torch.eval.harness import models as TM

torch.set_num_threads(1)

LL_REQS = [("abc", "de"), ("", "hello"), ("Question: how?\nAnswer:", " with a rope"),
           ("x" * 70, " tail")]
ROLLING = ["some document text that is long enough to roll " * 3, "short"]


def test_dummy_lm_matches_jax():
    for seed in (0, 5):
        j, t = JH.DummyLM(seed=seed), TH.DummyLM(seed=seed)
        assert t.loglikelihood(LL_REQS) == j.loglikelihood(LL_REQS)
        assert t.loglikelihood_rolling(ROLLING) == j.loglikelihood_rolling(ROLLING)
        assert t.greedy_until([("a", "\n"), ("b", ["."])]) == j.greedy_until([("a", "\n")] * 2)


def test_model_registry_is_jaxs():
    want = {("torch" if k == "jax" else k): v.__name__ for k, v in JH.MODEL_REGISTRY.items()}
    got = {k: v.__name__ for k, v in TH.MODEL_REGISTRY.items()}
    assert got == {**want, "torch": "TorchLM"}
    assert list(TH.MODEL_REGISTRY) == ["torch" if k == "jax" else k for k in JH.MODEL_REGISTRY]
    for name in TH.MODEL_REGISTRY:
        assert TH.get_model(name) is TH.MODEL_REGISTRY[name]


class WordTok:
    """A tokenizer for GPT3LM's rolling windows: one id a character."""

    eot_token_id = 3

    def encode(self, s):
        return [ord(c) for c in s]

    def decode(self, toks):
        return "".join(chr(t) for t in toks)


@pytest.mark.parametrize("max_length", [2048, 16])
def test_gpt3_adapter_matches_jax(max_length):
    kw = dict(engine="davinci", api_key="k", http=JMA._gpt3_fake_http, max_length=max_length)
    j, t = JH.GPT3LM(tokenizer=WordTok(), **kw), TH.GPT3LM(tokenizer=WordTok(), **kw)
    assert t.loglikelihood(LL_REQS) == j.loglikelihood(LL_REQS)
    assert t.loglikelihood_rolling(ROLLING) == j.loglikelihood_rolling(ROLLING)
    assert t.greedy_until([("abcd", ["\n"]), ("x", "\n")]) == j.greedy_until(
        [("abcd", ["\n"]), ("x", "\n")])
    for lm in (TH.GPT3LM(api_key="k", http=JMA._gpt3_fake_http),
               JH.GPT3LM(api_key="k", http=JMA._gpt3_fake_http)):
        with pytest.raises(ValueError, match="tokenizer"):
            lm.loglikelihood_rolling(["text"])


def test_textsynth_adapter_matches_jax():
    seen = []

    def fake_http(url, payload, headers):
        seen.append((url, payload, headers))
        if url.endswith("/logprob"):
            return {"logprob": -0.25 * len(payload["continuation"]),
                    "is_greedy": len(payload["context"]) % 2 == 0}
        return {"text": payload["prompt"][::-1]}

    outs = []
    for mod in (JH, TH):
        lm = mod.TextSynthLM(engine="gptj_6B", api_key="k", http=fake_http)
        outs.append((lm.loglikelihood(LL_REQS), lm.greedy_until([("abc", "\n"), ("de", ["."])])))
        with pytest.raises(NotImplementedError):
            lm.loglikelihood_rolling(["text"])
    assert outs[0] == outs[1]
    half = len(seen) // 2
    assert seen[:half] == seen[half:]


# ------------------------------------------------------------ HF models ----
def tiny_gpt2():
    from transformers import GPT2Config, GPT2LMHeadModel

    torch.manual_seed(0)
    cfg = GPT2Config(vocab_size=260, n_positions=128, n_embd=32, n_layer=2, n_head=2)
    return GPT2LMHeadModel(cfg).eval()


def tiny_t5():
    from transformers import T5Config, T5ForConditionalGeneration

    torch.manual_seed(0)
    cfg = T5Config(vocab_size=260, d_model=32, d_ff=64, num_layers=2, num_heads=2, d_kv=16,
                   decoder_start_token_id=0)
    return T5ForConditionalGeneration(cfg).eval()


@pytest.fixture(scope="module")
def gpt2():
    return tiny_gpt2()


@pytest.fixture(scope="module")
def t5():
    return tiny_t5()


def test_hf_causal_matches_jax(gpt2):
    j = JH.HFCausalLM(model=gpt2, tokenizer=JMA.CharTok(), batch_size=3)
    t = TH.HFCausalLM(model=gpt2, tokenizer=JMA.CharTok(), batch_size=3)
    assert t.max_length == j.max_length == 128 and t.device == torch.device("cpu")
    assert t.loglikelihood(LL_REQS) == j.loglikelihood(LL_REQS)
    np.testing.assert_array_equal(t.loglikelihood_rolling(ROLLING),
                                  j.loglikelihood_rolling(ROLLING))
    for lm in (j, t):
        lm.max_gen_toks = 6
    reqs = [("ab", ["\n"]), ("hello there", "zz")]
    assert t.greedy_until(reqs) == j.greedy_until(reqs)
    docs = [{"goal": f"do {i}", "sol1": f"aa{i}", "sol2": f"bb{i}", "label": i % 2}
            for i in range(4)]
    data = {"piqa": {"train": docs, "validation": docs}}
    got = TH.simple_evaluate(t, ["piqa"], task_data=data, bootstrap_iters=10)
    ref = JH.simple_evaluate(j, ["piqa"], task_data=data, bootstrap_iters=10)
    assert got["results"] == ref["results"]


def test_hf_seq2seq_matches_jax(t5):
    j = JH.HFSeq2SeqLM(model=t5, tokenizer=JMA.CharTok())
    t = TH.HFSeq2SeqLM(model=t5, tokenizer=JMA.CharTok())
    reqs = LL_REQS + [("abc", "")]
    assert t.loglikelihood(reqs) == j.loglikelihood(reqs)
    assert t.loglikelihood_rolling(ROLLING) == j.loglikelihood_rolling(ROLLING)
    assert t.greedy_until([("abc", ["\n"]), ("de", "x")]) == j.greedy_until(
        [("abc", ["\n"]), ("de", "x")])


class Spy(torch.nn.Module):
    """A causal model that records the device of the inputs it is given."""

    def __init__(self, device="cpu"):
        super().__init__()
        self.w = torch.nn.Parameter(torch.randn(8, 300, device=device))
        self.seen = []

    def forward(self, input_ids=None, labels=None):
        self.seen.append(input_ids.device)
        return type("Out", (), {"logits": self.w[input_ids % 8]})


def test_hf_adapters_run_on_the_models_device():
    model = Spy()
    lm = TH.HFCausalLM(model=model, tokenizer=JMA.CharTok(), batch_size=2)
    lm.loglikelihood(LL_REQS[:2])
    assert model.seen and set(model.seen) == {model.w.device}
    # a model elsewhere (here "meta") is read where it is, never moved
    for cls in (TH.HFCausalLM, TH.HFSeq2SeqLM):
        meta = Spy(device="meta")
        assert cls(model=meta, tokenizer=JMA.CharTok()).device == torch.device("meta")
        assert meta.w.device == torch.device("meta")
    # one without parameters runs on the caller's device, the card by default
    assert TM._model_device(object(), "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM._model_device(object())


@pytest.mark.parametrize("kind", ["causal", "seq2seq"])
def test_pretrained_goes_to_the_callers_device(kind, tmp_path):
    """`pretrained=` loads onto the card unless the caller passes
    `device="cpu"` (without CUDA it raises before loading), and the loaded
    model answers as the same model given in memory."""
    from transformers import ByT5Tokenizer

    cls, model = {"causal": (TH.HFCausalLM, tiny_gpt2),
                  "seq2seq": (TH.HFSeq2SeqLM, tiny_t5)}[kind]
    model = model()  # saved with a byte tokenizer: no download
    model.save_pretrained(tmp_path)
    ByT5Tokenizer().save_pretrained(tmp_path)
    if torch.cuda.is_available():
        lm = cls(pretrained=str(tmp_path))
        assert lm.device.type == "cuda" and next(lm.model.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(pretrained=str(tmp_path))
    lm = cls(pretrained=str(tmp_path), device="cpu")
    assert lm.device == next(lm.model.parameters()).device == torch.device("cpu")
    ref = cls(model=model, tokenizer=ByT5Tokenizer())
    assert lm.loglikelihood(LL_REQS) == ref.loglikelihood(LL_REQS)
