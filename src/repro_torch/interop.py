"""Carry parameters from the JAX package into the port.

``jax.random`` streams cannot be reproduced in PyTorch, so parity tests
initialise parameters with the reference and move them across as numpy.
The port keeps the reference's parameter tree and its ``(in, out)``
linear layout (``x @ w``), so the mapping is name for name with no
transposes: ``embed``, ``final_norm`` (``lm_head`` when untied) and
``blocks/{ln1, ln2, attn/{wq, wk, wv, wo[, bq, bk, bv]},
mlp/{gate, up, down}}`` stacked on the layer dim.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .configs.base import ModelConfig


def params_from_jax(tree: Dict, cfg: ModelConfig, device="cuda") -> Dict:
    """``tree``: the reference parameter tree with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``). Returns the port's
    parameter dict on ``device`` in ``cfg.dtype``."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    dt = getattr(torch, cfg.dtype)

    def t(x, shape):
        a = np.asarray(x, dtype=np.float32)
        if a.shape != shape:
            raise ValueError(f"parameter shape {a.shape} != {shape}")
        return torch.tensor(a, dtype=dt, device=device)

    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    qd, kd = cfg.q_dim, cfg.kv_dim
    b = tree["blocks"]
    attn = {"wq": t(b["attn"]["wq"], (L, D, qd)),
            "wk": t(b["attn"]["wk"], (L, D, kd)),
            "wv": t(b["attn"]["wv"], (L, D, kd)),
            "wo": t(b["attn"]["wo"], (L, qd, D))}
    if cfg.qkv_bias:
        attn.update(bq=t(b["attn"]["bq"], (L, qd)),
                    bk=t(b["attn"]["bk"], (L, kd)),
                    bv=t(b["attn"]["bv"], (L, kd)))
    out = {"embed": t(tree["embed"], (V, D)),
           "final_norm": t(tree["final_norm"], (D,)),
           "blocks": {"ln1": t(b["ln1"], (L, D)), "ln2": t(b["ln2"], (L, D)),
                      "attn": attn,
                      "mlp": {"gate": t(b["mlp"]["gate"], (L, D, F)),
                              "up": t(b["mlp"]["up"], (L, D, F)),
                              "down": t(b["mlp"]["down"], (L, F, D))}}}
    if not cfg.tie_embeddings:
        out["lm_head"] = t(tree["lm_head"], (V, D))
    return out
