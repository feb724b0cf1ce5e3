"""Small cross-cutting helpers. Port of ``repro/utils.py``, plus the
parameter-tree walk the JAX package gets from ``jax.tree_util``.

``to_device_copy`` snapshots a host buffer into a fresh tensor on the
device. A host-to-device copy may read its source after the call returns
(pinned-memory or asynchronous transfers), so a caller that mutates the
buffer right afterwards (a reused staging array, the next batch) must
hand over a copy it never touches again.

Trees are nested dicts of tensors. ``jax.tree_util`` walks dict keys in
**sorted** order, a Python dict in insertion order: every place the port
flattens a tree (bucket layout, optimizer, checkpoint leaf names) goes
through ``tree_flatten`` here so leaf order matches the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def to_device_copy(buf, device="cuda", dtype=None) -> torch.Tensor:
    """A fresh tensor on ``device`` from a never-mutated copy of ``buf``
    (also normalizes non-contiguous numpy views before the transfer)."""
    return torch.tensor(np.array(buf, dtype=dtype, copy=True),
                        device=device)


def tree_flatten(tree) -> Tuple[List[Path], List[Any]]:
    """(paths, leaves) in ``jax.tree_util`` order: dict keys sorted,
    depth first. A path is the tuple of keys from the root."""
    paths: List[Path] = []
    leaves: List[Any] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            paths.append(path)
            leaves.append(node)
    walk(tree, ())
    return paths, leaves


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[1]


def tree_unflatten(paths: List[Path], leaves: List[Any]):
    """Inverse of ``tree_flatten``: nested dicts from (paths, leaves)."""
    if len(paths) == 1 and paths[0] == ():
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)
