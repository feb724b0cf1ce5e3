"""Carry parameters and optimizer state between the JAX package and the
port.

``jax.random`` streams cannot be reproduced in PyTorch, so parity tests
initialise parameters with the reference and move them across as numpy;
``params_to_numpy`` and ``opt_state_to_numpy`` bring the port's back in
the reference's tree layout for comparison.
The port keeps the reference's parameter tree and its ``(in, out)``
linear layout (``x @ w``), so the mapping is name for name with no
transposes: ``embed``, ``final_norm`` (``lm_head`` when untied) and
``blocks/{ln1, ln2, attn/{wq, wk, wv, wo[, bq, bk, bv]},
mlp/{gate, up, down}}`` stacked on the layer dim.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .configs.base import ModelConfig
from .optim import OptState
from .utils import tree_map


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


def params_to_numpy(params: Dict, cfg: ModelConfig) -> Dict:
    """The port's parameters as the reference's tree of numpy arrays
    (f32; the same keys and shapes as ``params_from_jax`` takes)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    return tree_map(lambda t: t.detach().float().cpu().numpy(), params)


def opt_state_from_jax(state, cfg: ModelConfig, device="cuda") -> OptState:
    """The reference's ``OptState`` (numpy leaves, or its ``_asdict()``)
    as the port's: f32 moments shaped like the parameters, an int32
    step."""
    st = state._asdict() if hasattr(state, "_asdict") else state
    f32 = dataclasses.replace(cfg, dtype="float32")
    return OptState(
        step=torch.tensor(np.asarray(st["step"]), dtype=torch.int32,
                          device=device),
        mu=params_from_jax(st["mu"], f32, device=device),
        nu=params_from_jax(st["nu"], f32, device=device))


def opt_state_to_numpy(state: OptState) -> Dict:
    """The port's ``OptState`` as ``{"step", "mu", "nu"}`` numpy trees in
    the reference's layout."""
    to_np = lambda t: t.detach().cpu().numpy()
    return {"step": to_np(state.step), "mu": tree_map(to_np, state.mu),
            "nu": tree_map(to_np, state.nu)}
