"""Model configs, parameter trees and the decoder forward/decode (Llama,
OPT, Falcon, Mixtral), and the T5 encoder-decoder trunk."""

from .seq2seq import (  # noqa: F401
    Seq2SeqConfig,
    decode_step_seq2seq,
    forward_logits_seq2seq,
    from_hf_seq2seq,
    greedy_generate_seq2seq,
    greedy_generate_seq2seq_cached,
    init_seq2seq_params,
    init_seq2seq_state,
    quantize_seq2seq_rtn,
)
