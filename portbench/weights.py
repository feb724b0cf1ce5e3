"""Weights made from the seed on the device, in the dtypes they are run
in: one normal draw per dtype over every leaf of the parameter tree,
each leaf a slice of it, scaled or filled by the leaf's name. The same
seed on the same device gives the same weights, so the reference makes
them again rather than read the program's."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ONES = ("ln1", "ln2", "final_norm", "norm_w", "m_ln", "s_ln", "D")
ZEROS = ("A_log", "dt_bias", "bq", "bk", "bv")
SMALL = {"embed": 0.02, "lm_head": 0.02, "router": 0.02, "conv_w": 0.1}
ALIGN = 256        # elements; every leaf starts 512-byte aligned or more


def leaves(tree, path=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaves(v, path + (k,)))
        else:
            out.append((path + (k,), v))
    return out


def _set(tree: Dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(spec: Dict, seed: int, device) -> Dict:
    """A tree like ``spec`` (meta tensors) of seeded weights."""
    flat = leaves(spec)
    by_dtype: Dict[torch.dtype, list] = {}
    for path, t in flat:
        by_dtype.setdefault(t.dtype, []).append((path, t))
    gen = torch.Generator(device).manual_seed(seed)
    out: Dict = {}
    for dt in sorted(by_dtype, key=str):
        items = by_dtype[dt]
        offs, n = [], 0
        for _, t in items:
            offs.append(n)
            n += -(-t.numel() // ALIGN) * ALIGN
        buf = torch.randn(n, generator=gen, dtype=dt, device=device)
        for (path, t), o in zip(items, offs):
            w = buf[o:o + t.numel()].view(t.shape)
            name = path[-1]
            if name in ONES:
                w.fill_(1.0)
            elif name in ZEROS:
                w.zero_()
            elif name in SMALL:
                w.mul_(SMALL[name])
            else:
                w.mul_(1.0 / math.sqrt(t.shape[-2]))
            _set(out, path, w)
    return out

