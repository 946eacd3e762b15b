"""Task registry (the reference's `lm_eval/tasks/__init__.py:86-353`).

Covers the reference study's benchmark set — the five CommonSenseQA tasks
(`new_scripts/evaluate_*.sh`: piqa, arc_easy, arc_challenge, hellaswag,
winogrande), wikitext, MMLU (hendrycksTest-*), plus boolq/lambada/gsm8k,
GLUE, SuperGLUE, BLiMP x67, Pile perplexity subsets, WMT translation and
CrowS-Pairs — with the same prompt formats, so scores are comparable. All
tasks accept `data={split: [docs]}` for offline operation.

A copy of `llama3_quantization_tpu/eval/harness/tasks/__init__.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .anli import ANLIRound1, ANLIRound2, ANLIRound3
from .arc import ARCChallenge, ARCEasy
from .arithmetic import ARITHMETIC_CONFIGS, create_arithmetic_task
from .boolq import BoolQ
from .coqa import CoQA
from .drop import DROP
from .ethics import (
    EthicsCM,
    EthicsDeontology,
    EthicsJustice,
    EthicsUtilitarianism,
    EthicsUtilitarianismOriginal,
    EthicsVirtue,
)
from .extra_mc import Copa, OpenBookQA, SciQ
from .glue import MNLI, MRPC, QNLI, QQP, RTE, SST, WNLI, CoLA, MNLIMismatched
from .gsm8k import GSM8K
from .hendrycks_math import MATH_SUBJECTS, Asdiv, create_math_task
from .mc_taco import MCTACO
from .more_mc import (
    PROST,
    SWAG,
    HeadQAEn,
    HeadQAEs,
    LogiQA,
    MathQA,
    QA4MRE2011,
    QA4MRE2012,
    QA4MRE2013,
    ToxiGen,
)
from .mutual import MuTual, MuTualPlus
from .pubmedqa import PubMedQA
from .qa_free import TriviaQA, WebQs
from .qasper import QASPER
from .race import RACE
from .squad import SQuAD2
from .superglue import CB, MultiRC, ReCoRD, WSC, WiC
from .truthfulqa import TruthfulQAGeneration, TruthfulQAMultipleChoice
from .unscramble import UNSCRAMBLE_CONFIGS, create_unscramble_task
from .wsc273 import WinogradSchemaChallenge273
from .hellaswag import HellaSwag
from .hendrycks_test import SUBJECTS, create_mmlu_task
from .blimp import BLIMP_PHENOMENA, create_blimp_task
from .crows_pairs import BIAS_TYPES, CrowsPairs, CrowsPairsFrench, create_crows_subset
from .lambada import Lambada, LambadaCloze, LambadaStandard, LambadaStandardCloze
from .pile import PILE_SUBSETS, create_pile_task
from .translation import WMT_PAIRS, create_translation_task
from .piqa import PiQA
from .winogrande import Winogrande
from .wikitext import WikiText

TASK_REGISTRY = {
    "piqa": PiQA,
    "arc_easy": ARCEasy,
    "arc_challenge": ARCChallenge,
    "hellaswag": HellaSwag,
    "winogrande": Winogrande,
    "wikitext": WikiText,
    "boolq": BoolQ,
    "copa": Copa,
    "openbookqa": OpenBookQA,
    "sciq": SciQ,
    "lambada_openai": Lambada,
    "gsm8k": GSM8K,
    # GLUE (`lm_eval/tasks/glue.py`)
    "cola": CoLA,
    "sst": SST,
    "mrpc": MRPC,
    "qqp": QQP,
    "mnli": MNLI,
    "mnli_mismatched": MNLIMismatched,
    "qnli": QNLI,
    "rte": RTE,
    "wnli": WNLI,
    # SuperGLUE beyond boolq/copa (`lm_eval/tasks/superglue.py`)
    "cb": CB,
    "wic": WiC,
    "wsc": WSC,
    "multirc": MultiRC,
    "lambada_standard": LambadaStandard,
    "lambada_cloze": LambadaCloze,  # alias kept for earlier CLI scripts
    "lambada_openai_cloze": LambadaCloze,
    "lambada_standard_cloze": LambadaStandardCloze,
    "crows_pairs_english": CrowsPairs,
    "crows_pairs_french": CrowsPairsFrench,
    # ANLI (`lm_eval/tasks/anli.py`)
    "anli_r1": ANLIRound1,
    "anli_r2": ANLIRound2,
    "anli_r3": ANLIRound3,
    # open-ended / span QA
    "coqa": CoQA,
    "drop": DROP,
    "squad2": SQuAD2,
    "qasper": QASPER,
    "triviaqa": TriviaQA,
    "webqs": WebQs,
    "record": ReCoRD,
    "race": RACE,
    # misc MC
    "headqa": HeadQAEs,  # deprecated alias in the reference registry
    "headqa_en": HeadQAEn,
    "headqa_es": HeadQAEs,
    "logiqa": LogiQA,
    "mathqa": MathQA,
    "swag": SWAG,
    "prost": PROST,
    "pubmedqa": PubMedQA,
    "qa4mre_2011": QA4MRE2011,
    "qa4mre_2012": QA4MRE2012,
    "qa4mre_2013": QA4MRE2013,
    "toxigen": ToxiGen,
    "mutual": MuTual,
    "mutual_plus": MuTualPlus,
    "mc_taco": MCTACO,
    "wsc273": WinogradSchemaChallenge273,
    "truthfulqa_mc": TruthfulQAMultipleChoice,
    "truthfulqa_gen": TruthfulQAGeneration,
    # ETHICS (`lm_eval/tasks/hendrycks_ethics.py`)
    "ethics_cm": EthicsCM,
    "ethics_deontology": EthicsDeontology,
    "ethics_justice": EthicsJustice,
    "ethics_utilitarianism": EthicsUtilitarianism,
    "ethics_utilitarianism_original": EthicsUtilitarianismOriginal,
    "ethics_virtue": EthicsVirtue,
    # MATH (`lm_eval/tasks/hendrycks_math.py`) + asdiv
    "math_asdiv": Asdiv,
    **{name: create_math_task(name) for name in MATH_SUBJECTS},
    **{name: create_arithmetic_task(name) for name in ARITHMETIC_CONFIGS},
    **{name: create_unscramble_task(name) for name in UNSCRAMBLE_CONFIGS},
    **{
        f"crows_pairs_{lang}_{bt}": create_crows_subset(lang, bt)
        for lang in ("english", "french")
        for bt in BIAS_TYPES
    },
    **{f"hendrycksTest-{sub}": create_mmlu_task(sub) for sub in SUBJECTS},
    **{f"blimp_{ph}": create_blimp_task(ph) for ph in BLIMP_PHENOMENA},
    **{f"pile_{sub}": create_pile_task(sub) for sub in PILE_SUBSETS},
    **{f"{ds}-{src}-{tgt}": create_translation_task(ds, src, tgt)
       for ds, src, tgt in WMT_PAIRS},
}


def get_task_dict(task_name_list: List[str], task_data: Optional[Dict] = None):
    task_data = task_data or {}
    return {
        name: TASK_REGISTRY[name](data=task_data.get(name))
        for name in task_name_list
    }
