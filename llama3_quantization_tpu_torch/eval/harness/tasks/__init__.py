"""Task registry: the golden-row subset (`piqa`, `arc_easy`,
`arc_challenge`) of `llama3_quantization_tpu/eval/harness/tasks/__init__.py`,
whose other names come with the full registry. All tasks accept
`data={split: [docs]}` for offline operation.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .arc import ARCChallenge, ARCEasy
from .piqa import PiQA

TASK_REGISTRY = {
    "piqa": PiQA,
    "arc_easy": ARCEasy,
    "arc_challenge": ARCChallenge,
}


def get_task_dict(task_name_list: List[str], task_data: Optional[Dict] = None):
    task_data = task_data or {}
    return {
        name: TASK_REGISTRY[name](data=task_data.get(name))
        for name in task_name_list
    }
