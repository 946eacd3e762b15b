"""Flattened-tree npz persistence (port of
`llama3_quantization_tpu/utils/pytree_io.py`): checkpoints and resumable
aux parameters.

The npz layout is JAX's: leaf `i` of the tree, in JAX's flattening order
(dict keys sorted, lists and tuples in order), under the name `leaf_{i}`,
so a file written by one package loads in the other.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch


def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts, lists and tuples, in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


def _unflatten(tree_like, leaves):
    if isinstance(tree_like, dict):
        return {k: _unflatten(tree_like[k], leaves) for k in sorted(tree_like)}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(v, leaves) for v in tree_like)
    if tree_like is None:
        return None
    return next(leaves)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    return np.asarray(x)


def save_pytree_npz(path: str, tree) -> None:
    """Write every leaf of `tree` as `leaf_{i}`."""
    leaves = tree_leaves(tree)
    np.savez(path, **{f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)})


def load_pytree_npz(path: str, tree_like):
    """Restore leaves into the structure of `tree_like`, each as a tensor
    on the device and in the dtype of the leaf it replaces."""
    like = tree_leaves(tree_like)
    with np.load(path) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(like))]
    out = []
    for arr, ref in zip(arrays, like):
        t = torch.from_numpy(np.array(arr, copy=True))
        if isinstance(ref, torch.Tensor):
            t = t.to(device=ref.device, dtype=ref.dtype)
        out.append(t)
    return _unflatten(tree_like, iter(out))
