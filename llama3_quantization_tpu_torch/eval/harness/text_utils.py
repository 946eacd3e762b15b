"""Small text helpers shared by task prompts
(the reference's `lm_eval/utils.py:62-69`).

A copy of `llama3_quantization_tpu/eval/harness/text_utils.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

import re


def general_detokenize(string: str) -> str:
    """Undo PTB-ish tokenization artifacts in dataset sentences (used by
    the SST/MRPC/WSC prompt builders for score parity)."""
    string = string.replace(" n't", "n't")
    string = string.replace(" )", ")")
    string = string.replace("( ", "(")
    string = string.replace('" ', '"')
    string = string.replace(' "', '"')
    string = re.sub(r" (['.,])", r"\1", string)
    return string
