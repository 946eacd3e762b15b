"""MMLU subject -> subcategory -> category maps + roll-up.

Equivalent of the reference's `categories.py` + the aggregation loop at
`main.py:169-198`. The mapping is the standard one from the MMLU authors'
repo (hendrycks/test categories.py).

A copy of `llama3_quantization_tpu/eval/mmlu_categories.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from __future__ import annotations

from typing import Dict, List

subcategories: Dict[str, List[str]] = {
    "abstract_algebra": ["math"],
    "anatomy": ["health"],
    "astronomy": ["physics"],
    "business_ethics": ["business"],
    "clinical_knowledge": ["health"],
    "college_biology": ["biology"],
    "college_chemistry": ["chemistry"],
    "college_computer_science": ["computer science"],
    "college_mathematics": ["math"],
    "college_medicine": ["health"],
    "college_physics": ["physics"],
    "computer_security": ["computer science"],
    "conceptual_physics": ["physics"],
    "econometrics": ["economics"],
    "electrical_engineering": ["engineering"],
    "elementary_mathematics": ["math"],
    "formal_logic": ["philosophy"],
    "global_facts": ["other"],
    "high_school_biology": ["biology"],
    "high_school_chemistry": ["chemistry"],
    "high_school_computer_science": ["computer science"],
    "high_school_european_history": ["history"],
    "high_school_geography": ["geography"],
    "high_school_government_and_politics": ["politics"],
    "high_school_macroeconomics": ["economics"],
    "high_school_mathematics": ["math"],
    "high_school_microeconomics": ["economics"],
    "high_school_physics": ["physics"],
    "high_school_psychology": ["psychology"],
    "high_school_statistics": ["math"],
    "high_school_us_history": ["history"],
    "high_school_world_history": ["history"],
    "human_aging": ["health"],
    "human_sexuality": ["culture"],
    "international_law": ["law"],
    "jurisprudence": ["law"],
    "logical_fallacies": ["philosophy"],
    "machine_learning": ["computer science"],
    "management": ["business"],
    "marketing": ["business"],
    "medical_genetics": ["health"],
    "miscellaneous": ["other"],
    "moral_disputes": ["philosophy"],
    "moral_scenarios": ["philosophy"],
    "nutrition": ["health"],
    "philosophy": ["philosophy"],
    "prehistory": ["history"],
    "professional_accounting": ["other"],
    "professional_law": ["law"],
    "professional_medicine": ["health"],
    "professional_psychology": ["psychology"],
    "public_relations": ["politics"],
    "security_studies": ["politics"],
    "sociology": ["culture"],
    "us_foreign_policy": ["politics"],
    "virology": ["health"],
    "world_religions": ["philosophy"],
}

categories: Dict[str, List[str]] = {
    "STEM": [
        "physics", "chemistry", "biology", "computer science", "math",
        "engineering",
    ],
    "humanities": ["history", "philosophy", "law"],
    "social sciences": [
        "politics", "culture", "economics", "geography", "psychology",
    ],
    "other (business, health, misc.)": ["other", "business", "health"],
}


def mmlu_rollup(task_results: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Aggregate per-subject `hendrycksTest-*` accs into category averages
    and an overall average (`main.py:169-198`)."""
    cat_cors: Dict[str, List[float]] = {cat: [] for cat in categories}
    all_cors: List[float] = []
    for key, metrics in task_results.items():
        if not key.startswith("hendrycksTest-"):
            continue
        subject = key[len("hendrycksTest-") :]
        acc = metrics.get("acc")
        if acc is None or subject not in subcategories:
            continue
        for subcat in subcategories[subject]:
            for cat, members in categories.items():
                if subcat in members:
                    cat_cors[cat].append(acc)
        all_cors.append(acc)
    out = {
        f"mmlu_{cat}": sum(v) / len(v) for cat, v in cat_cors.items() if v
    }
    if all_cors:
        out["mmlu_average"] = sum(all_cors) / len(all_cors)
    return out
