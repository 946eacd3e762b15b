"""Evaluation orchestrator (the reference's `lm_eval/evaluator.py`).

Same flow as the fork's `simple_evaluate`: takes a LIVE LM object, expands
fnmatch task patterns, builds all requests per (task, doc) with the seeded
shuffle (`rnd.seed(42)`, evaluator.py:179-181), executes each request type
as one vectorized LM call, routes responses back through `process_results`,
aggregates with bootstrap stderr.

A copy of `llama3_quantization_tpu/eval/harness/evaluator.py`, held equal to it by
`tests/test_torch_tasks.py`.
"""

from __future__ import annotations

import collections
import fnmatch
import random
from typing import Dict, List, Optional, Union

from . import metrics as metrics_mod
from .base import LM, Task


def pattern_match(patterns: List[str], source_list: List[str]) -> List[str]:
    names = set()
    for pattern in patterns:
        for matching in fnmatch.filter(source_list, pattern):
            names.add(matching)
    return sorted(names)


def simple_evaluate(
    lm: LM,
    tasks: Union[str, List[str], Dict[str, Task]],
    num_fewshot: int = 0,
    limit: Optional[int] = None,
    bootstrap_iters: int = 1000,
    description_dict: Optional[dict] = None,
    task_data: Optional[dict] = None,
    decontamination_ngrams_path: Optional[str] = None,
):
    """Evaluate `lm` on tasks (names, patterns, or instances).

    `task_data` maps task name -> injected documents for offline operation.
    """
    from .tasks import TASK_REGISTRY, get_task_dict

    if isinstance(tasks, dict):
        task_dict = tasks
    else:
        if isinstance(tasks, str):
            tasks = [t for t in tasks.split(",") if t]
        names = pattern_match(tasks, list(TASK_REGISTRY.keys()))
        missing = set(tasks) - set(names) - {t for t in tasks if any(c in t for c in "*?[")}
        if missing:
            raise KeyError(f"unknown tasks: {sorted(missing)}")
        task_dict = get_task_dict(names, task_data=task_data)

    results = evaluate(
        lm,
        task_dict,
        num_fewshot=num_fewshot,
        limit=limit,
        bootstrap_iters=bootstrap_iters,
        description_dict=description_dict,
        decontamination_ngrams_path=decontamination_ngrams_path,
    )
    results["config"] = {
        "num_fewshot": num_fewshot,
        "limit": limit,
        "bootstrap_iters": bootstrap_iters,
    }
    return results


def evaluate(
    lm: LM,
    task_dict: Dict[str, Task],
    num_fewshot: int = 0,
    limit: Optional[int] = None,
    bootstrap_iters: int = 1000,
    description_dict: Optional[dict] = None,
    decontamination_ngrams_path: Optional[str] = None,
):
    task_dict_items = [
        (name, task)
        for name, task in task_dict.items()
        if task.has_validation_docs() or task.has_test_docs()
    ]
    results = collections.defaultdict(dict)
    versions = collections.defaultdict(dict)
    requests = collections.defaultdict(list)
    requests_origin = collections.defaultdict(list)
    docs = {}
    decontaminate = decontamination_ngrams_path is not None
    docs_for_decontamination = collections.defaultdict(list)

    for task_name, task in task_dict_items:
        versions[task_name] = task.VERSION
        if task.has_test_docs():
            task_doc_func = task.test_docs
        elif task.has_validation_docs():
            task_doc_func = task.validation_docs
        else:
            raise RuntimeError("Task has neither test_docs nor validation_docs")
        task_docs = list(task_doc_func())
        rnd = random.Random()
        rnd.seed(42)
        rnd.shuffle(task_docs)  # seeded shuffle, evaluator.py:179-181

        description = (
            description_dict.get(task_name, "") if description_dict else ""
        )
        for doc_id, doc in enumerate(task_docs[:limit] if limit else task_docs):
            docs[(task_name, doc_id)] = doc
            if decontaminate and task.should_decontaminate():
                docs_for_decontamination[task_name].append(
                    task.doc_to_decontamination_query(doc)
                )
            ctx = task.fewshot_context(
                doc=doc, num_fewshot=num_fewshot, rnd=rnd, description=description
            )
            reqs = task.construct_requests(doc, ctx)
            if not isinstance(reqs, (list, tuple)):
                reqs = [reqs]
            for i, req in enumerate(reqs):
                requests[req.request_type].append(req)
                requests_origin[req.request_type].append((i, task_name, doc, doc_id))

    process_res_queue = collections.defaultdict(list)
    for reqtype, reqs in requests.items():
        resps = getattr(lm, reqtype)([req.args for req in reqs])
        resps = [
            x if req.index is None else x[req.index] for x, req in zip(resps, reqs)
        ]
        for resp, (i, task_name, doc, doc_id) in zip(resps, requests_origin[reqtype]):
            process_res_queue[(task_name, doc_id)].append((i, resp))

    overlaps: dict = {}
    if decontaminate and docs_for_decontamination:
        from ...decontamination.decontaminate import get_train_overlap

        overlaps = get_train_overlap(
            dict(docs_for_decontamination), decontamination_ngrams_path
        )

    vals = collections.defaultdict(list)
    for (task_name, doc_id), per_doc_requests in process_res_queue.items():
        per_doc_requests.sort(key=lambda x: x[0])
        per_doc_results = [x[1] for x in per_doc_requests]
        task = task_dict[task_name]
        doc = docs[(task_name, doc_id)]
        output = task.process_results(doc, per_doc_results)
        for metric, value in output.items():
            vals[(task_name, metric)].append(value)
            if decontaminate and doc_id not in overlaps.get(task_name, set()):
                vals[(task_name, metric + "_decontaminate")].append(value)

    for (task_name, metric), items in vals.items():
        task = task_dict[task_name]
        base_metric = metric.replace("_decontaminate", "")
        agg = task.aggregation()[base_metric]
        results[task_name][metric] = agg(items)
        stderr = metrics_mod.stderr_for_metric(agg, bootstrap_iters=bootstrap_iters)
        if stderr is not None and not metric.endswith("_decontaminate"):
            results[task_name][metric + "_stderr"] = stderr(items)

    return {"results": dict(results), "versions": dict(versions)}


def _table_rows(result_dict):
    for k, dic in result_dict["results"].items():
        version = result_dict["versions"].get(k, "")
        for m, v in dic.items():
            if m.endswith("_stderr"):
                continue
            se = dic.get(m + "_stderr")
            yield k, version, m, v, se


def make_table(result_dict, fmt: str = "markdown") -> str:
    """Results table, markdown or latex (`lm_eval/evaluator.py:284-314`
    emits both via pytablewriter; here one writer with a `fmt` switch)."""
    if fmt == "latex":
        rows = [
            r"\begin{tabular}{lllrl}",
            r"Task & Version & Metric & Value & Stderr \\ \hline",
        ]
        for k, version, m, v, se in _table_rows(result_dict):
            se_str = f"$\\pm$ {se:.4f}" if se is not None else ""
            metric = m.replace("_", r"\_")
            task = k.replace("_", r"\_")
            rows.append(f"{task} & {version} & {metric} & {v:.4f} & {se_str} \\\\")
        rows.append(r"\end{tabular}")
        return "\n".join(rows)
    rows = ["|Task|Version|Metric|Value|Stderr|", "|---|---|---|---|---|"]
    for k, version, m, v, se in _table_rows(result_dict):
        se_str = f"± {se:.4f}" if se is not None else ""
        rows.append(f"|{k}|{version}|{m}|{v:.4f}|{se_str}|")
    return "\n".join(rows)
