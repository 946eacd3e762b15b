"""Offline raw-file dataset loaders — the framework's equivalent of the
reference's custom HF builder scripts (`lm_eval/datasets/**`, 13
`GeneratorBasedBuilder`s for corpora not on the Hub).

Design difference: instead of `datasets` builder plugins that
download at import time, these are plain parsers from the SAME raw on-disk
formats (the files the reference's `_split_generators` download) to the
`{split: [docs]}` dicts every task here accepts via `data=`. Zero-egress
friendly: point them at local copies and feed the result to
`simple_evaluate(..., task_data=...)`.

Each loader cites the `_generate_examples` it mirrors.

A copy of `llama3_quantization_tpu/eval/harness/local_datasets.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from __future__ import annotations

import csv
import json
import os
from pathlib import Path
from typing import Dict, List, Optional


def load_logiqa(train_txt: str, validation_txt: str, test_txt: str) -> Dict[str, List[dict]]:
    """LogiQA raw txt: blank-line-separated blocks of [label, context,
    question, 4 "a."-prefixed options] (`datasets/logiqa/logiqa.py:111-124`)."""

    def normalize(text):
        return text.replace(".", ". ").strip()

    def parse(path):
        docs = []
        with open(path, encoding="utf-8") as f:
            for block in f.read().strip().split("\n\n"):
                lines = block.split("\n")
                docs.append(
                    {
                        "label": lines[0].strip(),
                        "context": normalize(lines[1]),
                        "question": normalize(lines[2]),
                        "options": [normalize(opt[2:]) for opt in lines[3:]],
                    }
                )
        return docs

    return {
        "train": parse(train_txt),
        "validation": parse(validation_txt),
        "test": parse(test_txt),
    }


def load_mutual(data_dir: str) -> Dict[str, List[dict]]:
    """MuTual repo layout: `<data_dir>/{train,dev,test}/*.txt`, each file one
    JSON record (`datasets/mutual/mutual.py:117-135`)."""
    out = {}
    for split, name in [("train", "train"), ("validation", "dev"), ("test", "test")]:
        base = Path(data_dir) / name
        docs = []
        if base.is_dir():
            for file in sorted(base.iterdir()):
                if file.suffix != ".txt":
                    continue
                text = file.read_text(encoding="utf-8")
                if not text:
                    continue
                data = json.loads(text)
                docs.append(
                    {
                        "answers": data["answers"],
                        "options": data["options"],
                        "article": data["article"],
                        "id": data["id"],
                    }
                )
        out[split] = docs
    return out


def load_unscramble(jsonl_path: str) -> Dict[str, List[dict]]:
    """GPT-3 unscramble task file: jsonl of {context, completion}
    (`datasets/unscramble/unscramble.py:103-110`)."""
    with open(jsonl_path, encoding="utf-8") as f:
        docs = [json.loads(line) for line in f if line.strip()]
    return {"validation": [{"context": d["context"], "completion": d["completion"]} for d in docs]}


def load_asdiv(xml_path: str) -> Dict[str, List[dict]]:
    """ASDiv.xml `<Problem>` records (`datasets/asdiv/asdiv.py:101-111`)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(xml_path).getroot()
    docs = [
        {
            "body": p.find("Body").text,
            "question": p.find("Question").text,
            "solution_type": p.find("Solution-Type").text,
            "answer": p.find("Answer").text,
            "formula": p.find("Formula").text,
        }
        for p in root.iter("Problem")
    ]
    return {"validation": docs}


def load_coqa(train_json: str, dev_json: str) -> Dict[str, List[dict]]:
    """coqa-{train,dev}-v1.0.json; additional_answers exist only in dev
    (`datasets/coqa/coqa.py:183-220`)."""

    def parse(path, with_additional):
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        docs = []
        for row in data["data"]:
            doc = {
                "id": row["id"],
                "story": row["story"],
                "questions": {
                    "input_text": [q["input_text"] for q in row["questions"]]
                },
                "answers": {
                    "input_text": [a["input_text"] for a in row["answers"]]
                },
                "additional_answers": None,
            }
            if with_additional and "additional_answers" in row:
                doc["additional_answers"] = {
                    k: {"input_text": [a["input_text"] for a in v]}
                    for k, v in row["additional_answers"].items()
                }
            docs.append(doc)
        return docs

    return {"train": parse(train_json, False), "validation": parse(dev_json, True)}


def load_drop(train_json: str, dev_json: str) -> Dict[str, List[dict]]:
    """drop_dataset_{train,dev}.json: passages with qa_pairs
    (`datasets/drop/drop.py:145-190`)."""

    def norm_answer(answer):
        return {
            "number": answer.get("number", ""),
            "date": {
                "day": answer.get("date", {}).get("day", ""),
                "month": answer.get("date", {}).get("month", ""),
                "year": answer.get("date", {}).get("year", ""),
            },
            "spans": answer.get("spans", []),
        }

    def parse(path):
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        docs = []
        for example in data.values():
            for qa in example["qa_pairs"]:
                docs.append(
                    {
                        "query_id": qa["query_id"],
                        "passage": example["passage"],
                        "question": qa["question"],
                        "answer": norm_answer(qa["answer"]),
                        "validated_answers": {
                            "number": [
                                va.get("number", "")
                                for va in qa.get("validated_answers", [])
                            ],
                            "date": [
                                norm_answer(va)["date"]
                                for va in qa.get("validated_answers", [])
                            ],
                            "spans": [
                                va.get("spans", [])
                                for va in qa.get("validated_answers", [])
                            ],
                        },
                    }
                )
        return docs

    return {"train": parse(train_json), "validation": parse(dev_json)}


def load_headqa(json_path: str, split: str = "test") -> Dict[str, List[dict]]:
    """HEAD-QA exam json (`datasets/headqa/headqa.py:134-151`)."""
    with open(json_path, encoding="utf-8") as f:
        head_qa = json.load(f)
    docs = []
    for exam in head_qa["exams"]:
        for question in head_qa["exams"][exam]["data"]:
            docs.append(
                {
                    "qid": int(question["qid"].strip()),
                    "qtext": question["qtext"].strip(),
                    "ra": int(question["ra"].strip()),
                    "answers": [
                        {"aid": a["aid"], "atext": a["atext"].strip()}
                        for a in question["answers"]
                    ],
                }
            )
    return {split: docs}


def load_hendrycks_ethics(csv_path: str, subset: str, split: str = "test") -> Dict[str, List[dict]]:
    """ETHICS csvs; grouped subsets get group ids, virtue splits on
    " [SEP] " (`datasets/hendrycks_ethics/hendrycks_ethics.py:178-229`)."""
    docs = []
    with open(csv_path, newline="", encoding="utf-8") as f:
        if subset == "utilitarianism":
            reader = csv.DictReader(f, fieldnames=["activity", "baseline"])
        else:
            reader = csv.DictReader(f)
        group_id = 0
        for key, row in enumerate(reader):
            if subset == "deontology":
                if key % 4 == 0 and key != 0:
                    group_id += 1
                docs.append(
                    {
                        "group_id": group_id,
                        "label": int(row["label"]),
                        "scenario": row["scenario"],
                        "excuse": row["excuse"],
                    }
                )
            elif subset == "justice":
                if key % 4 == 0 and key != 0:
                    group_id += 1
                docs.append(
                    {"group_id": group_id, "label": int(row["label"]), "scenario": row["scenario"]}
                )
            elif subset == "commonsense":
                docs.append({"label": int(row["label"]), "input": row["input"]})
            elif subset == "virtue":
                if key % 5 == 0 and key != 0:
                    group_id += 1
                scenario, trait = row["scenario"].split(" [SEP] ")
                docs.append(
                    {
                        "group_id": group_id,
                        "label": int(row["label"]),
                        "scenario": scenario,
                        "trait": trait,
                    }
                )
            elif subset == "utilitarianism":
                docs.append(
                    {"activity": row["activity"], "baseline": row["baseline"], "rating": ""}
                )
            else:
                raise ValueError(f"unknown ethics subset {subset}")
    return {split: docs}


def load_hendrycks_math(problems_dir: str, split: str = "test") -> Dict[str, List[dict]]:
    """MATH subject directory of per-problem json files
    (`datasets/hendrycks_math/hendrycks_math.py:111-121`)."""
    docs = []
    for file in sorted(Path(problems_dir).iterdir()):
        with open(file, encoding="utf-8") as f:
            data = json.load(f)
        docs.append(
            {
                "problem": data["problem"],
                "level": data["level"],
                "type": data["type"],
                "solution": data["solution"],
            }
        )
    return {split: docs}


def load_pile(jsonl_path: str, subset: Optional[str] = None, split: str = "test") -> Dict[str, List[str]]:
    """Pile jsonl(.zst): filter rows by meta.pile_set_name; documents are
    raw text for PerplexityTask (`datasets/pile/pile.py:119-126`). `.zst`
    files stream through `decontamination.archiver.Reader`."""
    docs = []
    if jsonl_path.endswith(".zst"):
        from ...decontamination.archiver import Reader

        for text, meta in Reader().read(jsonl_path, get_meta=True):
            if subset is None or meta.get("pile_set_name") == subset:
                docs.append(text)
    else:
        with open(jsonl_path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                data = json.loads(line)
                if subset is None or data["meta"]["pile_set_name"] == subset:
                    docs.append(data["text"])
    return {split: docs}


def load_quac(json_path: str, split: str = "validation") -> Dict[str, List[dict]]:
    """QuAC v0.2 json flattened to (question, answer) pairs
    (`datasets/quac/quac.py:102-117`; task disabled in the reference
    registry, loader provided for completeness)."""
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)["data"]
    docs = []
    for row in data:
        paragraph = row["paragraphs"][0]["context"].replace("CANNOTANSWER", "")
        for qa in row["paragraphs"][0]["qas"]:
            docs.append(
                {
                    "title": row["title"],
                    "section_title": row["section_title"],
                    "paragraph": paragraph,
                    "question": qa["question"],
                    "answer": qa["answers"][0]["text"],
                }
            )
    return {split: docs}


def load_triviaqa(json_path: str) -> Dict[str, List[dict]]:
    """TriviaQA unfiltered json ({Data: [...]} or a plain list); keeps the
    fields the task reads (`datasets/triviaqa/triviaqa.py:118-160`)."""
    with open(json_path, encoding="utf-8") as f:
        data = json.load(f)
    rows = data["Data"] if isinstance(data, dict) else data
    docs = [
        {
            "question": row["Question"],
            "answer": {
                "value": row["Answer"]["Value"],
                "aliases": row["Answer"]["Aliases"],
            },
        }
        for row in rows
    ]
    return {"validation": docs}


def load_sat_analogies(txt_path: str) -> Dict[str, List[dict]]:
    """SAT-package-V3.txt blank-line-separated records: [.., source, stem,
    5 choices, solution] (`datasets/sat_analogies/sat_analogies.py:100-128`;
    the dataset itself must be obtained from the authors)."""
    records, record = [], []
    with open(txt_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line and record:
                records.append(record)
                record = []
            elif line and line[0] == "#":
                continue
            elif line:
                record.append(line)
    if record:
        records.append(record)
    docs = [
        {
            "source": r[-8],
            "stem": r[-7],
            "choices": r[-6:-1],
            "solution": r[-1],
        }
        for r in records
    ]
    return {"validation": docs}


#: task name (registry) -> loader, for CLI discovery
LOADERS = {
    "logiqa": load_logiqa,
    "mutual": load_mutual,
    "mutual_plus": load_mutual,
    "anagrams1": load_unscramble,
    "anagrams2": load_unscramble,
    "cycle_letters": load_unscramble,
    "random_insertion": load_unscramble,
    "reversed_words": load_unscramble,
    "math_asdiv": load_asdiv,
    "coqa": load_coqa,
    "drop": load_drop,
    "headqa_en": load_headqa,
    "headqa_es": load_headqa,
    "ethics_cm": load_hendrycks_ethics,
    "ethics_deontology": load_hendrycks_ethics,
    "ethics_justice": load_hendrycks_ethics,
    "ethics_utilitarianism": load_hendrycks_ethics,
    "ethics_utilitarianism_original": load_hendrycks_ethics,
    "ethics_virtue": load_hendrycks_ethics,
    "triviaqa": load_triviaqa,
    "quac": load_quac,
}
LOADERS.update({f"math_{s}": load_hendrycks_math for s in (
    "algebra", "counting_and_prob", "geometry", "intermediate_algebra",
    "num_theory", "prealgebra", "precalc")})
LOADERS.update({f"pile_{s}": load_pile for s in (
    "arxiv", "books3", "bookcorpus2", "dm-mathematics", "enron", "europarl",
    "freelaw", "github", "gutenberg", "hackernews", "nih-exporter",
    "opensubtitles", "openwebtext2", "philpapers", "pile-cc",
    "pubmed-abstracts", "pubmed-central", "stackexchange", "ubuntu-irc",
    "uspto", "wikipedia", "youtubesubtitles")})
