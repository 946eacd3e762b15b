"""MATH competition problems + ASDiv
(the reference's `lm_eval/tasks/hendrycks_math.py`, `asdiv.py`): greedy
generation; answers compared after the Minerva-style LaTeX string
normalization (`strip_string`, `hendrycks_math.py:219-280`).

A copy of `llama3_quantization_tpu/eval/harness/tasks/hendrycks_math.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from .. import metrics
from ..base import Task, rf


def last_boxed_only_string(text):
    """Extract the last \\boxed{...} / \\fbox{...} group (`:125-149`)."""
    if "\\boxed " in text:
        return "\\boxed " + text.split("\\boxed ")[-1].split("$")[0]
    idx = text.rfind("\\boxed")
    if idx < 0:
        idx = text.rfind("\\fbox")
        if idx < 0:
            return None
    depth = 0
    right = None
    for i in range(idx, len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                right = i
                break
    return text[idx : right + 1] if right is not None else None


def remove_boxed(s):
    if s is None:
        return None
    if s.startswith("\\boxed "):
        return s[len("\\boxed "):]
    if s.startswith("\\boxed{") and s.endswith("}"):
        return s[len("\\boxed{"):-1]
    return None


def _fix_fracs(s):
    """\\frac12 -> \\frac{1}{2}, \\frac1{72} -> \\frac{1}{72}."""
    parts = s.split("\\frac")
    out = parts[0]
    for part in parts[1:]:
        out += "\\frac"
        if not part:
            return s
        if part[0] == "{":
            out += part
        elif len(part) >= 2:
            a, b, rest = part[0], part[1], part[2:]
            if b != "{":
                out += "{" + a + "}{" + b + "}" + rest
            else:
                out += "{" + a + "}" + b + rest
        else:
            return s
    return out


def _fix_a_slash_b(s):
    parts = s.split("/")
    if len(parts) != 2:
        return s
    try:
        a, b = int(parts[0]), int(parts[1])
        if s == f"{a}/{b}":
            return "\\frac{" + str(a) + "}{" + str(b) + "}"
    except ValueError:
        pass
    return s


def _remove_right_units(s):
    if "\\text{ " in s:
        parts = s.split("\\text{ ")
        if len(parts) == 2:
            return parts[0]
    return s


def _fix_sqrt(s):
    if "\\sqrt" not in s:
        return s
    parts = s.split("\\sqrt")
    out = parts[0]
    for part in parts[1:]:
        if part and part[0] != "{":
            out += "\\sqrt{" + part[0] + "}" + part[1:]
        else:
            out += "\\sqrt" + part
    return out


def strip_string(s):
    """Canonicalize a LaTeX answer string (`hendrycks_math.py:219-280`)."""
    s = s.replace("\n", "").replace("\\!", "").replace("\\\\", "\\")
    s = s.replace("tfrac", "frac").replace("dfrac", "frac")
    s = s.replace("\\left", "").replace("\\right", "")
    s = s.replace("^{\\circ}", "").replace("^\\circ", "")
    s = s.replace("\\$", "")
    s = _remove_right_units(s)
    s = s.replace("\\%", "").replace("%", "")
    s = s.replace(" .", " 0.").replace("{.", "{0.")
    if not s:
        return s
    if s[0] == ".":
        s = "0" + s
    if len(s.split("=")) == 2 and len(s.split("=")[0]) <= 2:
        s = s.split("=")[1]
    s = _fix_sqrt(s)
    s = s.replace(" ", "")
    s = _fix_fracs(s)
    if s == "0.5":
        s = "\\frac{1}{2}"
    return _fix_a_slash_b(s)


def is_equiv(a, b):
    if a is None and b is None:
        return True
    if a is None or b is None:
        return False
    try:
        return strip_string(a) == strip_string(b)
    except Exception:
        return a == b


class Math(Task):
    VERSION = 1
    DATASET_PATH = "EleutherAI/hendrycks_math"
    DATASET_NAME = None

    def has_training_docs(self):
        return True

    def has_validation_docs(self):
        return False

    def has_test_docs(self):
        return True

    def training_docs(self):
        return map(self._process_doc, self.dataset["train"])

    def test_docs(self):
        return map(self._process_doc, self.dataset["test"])

    def _process_doc(self, doc):
        doc = dict(doc)
        doc["answer"] = remove_boxed(last_boxed_only_string(doc["solution"]))
        return doc

    def doc_to_text(self, doc):
        return "Problem: " + doc["problem"] + "\nAnswer:"

    def doc_to_target(self, doc):
        return " " + doc["solution"]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["problem"]

    def construct_requests(self, doc, ctx):
        return rf.greedy_until(ctx, ["\n"])

    def process_results(self, doc, results):
        completion = results[0] if isinstance(results, (list, tuple)) else results
        # if the answer is wrapped in $...$, take the inside
        dollars = [i for i, ch in enumerate(completion) if ch == "$"]
        answer = (
            completion[dollars[0] + 1 : dollars[-1]] if len(dollars) > 1 else completion
        )
        return {"acc": float(is_equiv(answer, doc["answer"]))}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}


MATH_SUBJECTS = {
    "math_algebra": "algebra",
    "math_counting_and_prob": "counting_and_probability",
    "math_geometry": "geometry",
    "math_intermediate_algebra": "intermediate_algebra",
    "math_num_theory": "number_theory",
    "math_prealgebra": "prealgebra",
    "math_precalc": "precalculus",
}


def create_math_task(name: str):
    class _Math(Math):
        DATASET_NAME = MATH_SUBJECTS[name]

    _Math.__name__ = name
    return _Math


class Asdiv(Task):
    """ASDiv arithmetic word problems (`asdiv.py`): zero-shot greedy-match
    of the numeric answer's loglikelihood."""

    VERSION = 0
    DATASET_PATH = "EleutherAI/asdiv"
    DATASET_NAME = None

    def has_training_docs(self):
        return False

    def has_validation_docs(self):
        return True

    def has_test_docs(self):
        return False

    def validation_docs(self):
        return self.dataset["validation"]

    def fewshot_context(self, doc, num_fewshot, rnd, description=""):
        if num_fewshot != 0:
            raise ValueError("ASDiv is zero-shot only")
        return super().fewshot_context(doc, num_fewshot, rnd, description)

    def doc_to_text(self, doc):
        return doc["body"] + "\nQuestion:" + doc["question"] + "\nAnswer:"

    def doc_to_target(self, doc):
        return " " + doc["answer"].split(" (")[0]

    def should_decontaminate(self):
        return True

    def doc_to_decontamination_query(self, doc):
        return doc["body"] + " " + doc["question"]

    def construct_requests(self, doc, ctx):
        ll, is_greedy = rf.loglikelihood(ctx, self.doc_to_target(doc))
        return ll, is_greedy

    def process_results(self, doc, results):
        _, is_greedy = results
        return {"acc": float(is_greedy)}

    def aggregation(self):
        return {"acc": metrics.mean}

    def higher_is_better(self):
        return {"acc": True}
