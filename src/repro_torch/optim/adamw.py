"""AdamW with cosine schedule and global-norm clipping over parameter
dicts. Port of ``repro/optim/adamw.py``.

The moments are f32 trees shaped like the parameters, and the update is
computed in f32 and cast back to each parameter's dtype. Every scalar
the reference computes as an f32 array (the schedule's learning rate,
the bias corrections ``1 - b**t``, the clip scale) is an f32 tensor here
too, never a Python double, so the trajectory rounds as the
reference's does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..utils import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor          # 0-d int32
    mu: Dict
    nu: Dict


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by
    leaf in the reference's (sorted) leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup: int = 100
    total_steps: int = 10_000

    def init(self, params) -> OptState:
        some = tree_leaves(params)[0]

        def f32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return OptState(step=torch.zeros((), dtype=torch.int32,
                                         device=some.device),
                        mu=tree_map(f32, params), nu=tree_map(f32, params))

    @torch.no_grad()
    def update(self, grads, state: OptState, params, *,
               gnorm=None) -> Tuple[Dict, OptState, Dict]:
        """``gnorm`` overrides the clip norm (a model-parallel caller
        passes the true cross-stage global norm)."""
        step = state.step + 1
        lr = cosine_schedule(self.lr, self.warmup, self.total_steps)(step)
        if gnorm is None:
            gnorm = global_norm(grads)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale.to(g.dtype), grads)

        t = step.to(torch.float32)
        c1 = 1.0 - self.b1 ** t
        c2 = 1.0 - self.b2 ** t

        def upd(p, g, m, v):
            g32 = g.float()
            m_new = self.b1 * m + (1 - self.b1) * g32
            v_new = self.b2 * v + (1 - self.b2) * g32 * g32
            mhat = m_new / c1
            vhat = v_new / c2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if p.ndim >= 2:      # decoupled decay on matrices only
                delta = delta + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m_new, v_new

        out = tree_map(upd, params, grads, state.mu, state.nu)
        pick = lambda i: tree_map(lambda o: o[i], out)   # tuples are leaves
        return pick(0), OptState(step, pick(1), pick(2)), \
            {"lr": lr, "grad_norm": gnorm}
