"""Carry parameters and optimizer state between the JAX package and the
port.

``jax.random`` streams cannot be reproduced in PyTorch, so parity tests
initialise parameters with the reference and move them across as numpy;
``params_to_numpy`` and ``opt_state_to_numpy`` bring the port's back in
the reference's tree layout for comparison.
The port keeps the reference's parameter tree and its ``(in, out)``
linear layout (``x @ w``), so the mapping is name for name with no
transposes, for every ported family: dense ``blocks/{ln1, ln2,
attn/{wq, wk, wv, wo[, bq, bk, bv]}, mlp/{gate, up, down}}`` stacked on
the layer dim; plain ssm ``blocks/{ln1, ssm/{in_proj, conv_w, A_log, D,
dt_bias, out_proj, norm_w}}`` stacked (L, ...); hybrid the same blocks
stacked (G, k, ...) plus ``shared/{ln1, ln2, attn, mlp}``; xLSTM
``blocks/{m_ln, mlstm/{up, wq, wk, wv, wi, wf, fb, norm_w, down}}``
stacked (G, k-1, ...) and ``blocks/{s_ln, slstm/{wx, wr, b, norm_w,
down}}`` stacked (G, ...); and ``embed``, ``final_norm`` (``lm_head``
when untied). Each leaf takes the dtype of the port's ``param_spec``
(``cfg.dtype``; ``A_log``, ``D``, ``dt_bias``, the mLSTM gates ``wi``,
``wf``, ``fb`` and the sLSTM bias ``b`` stay f32, as the reference keeps
them).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .configs.base import ModelConfig
from .models import transformer
from .optim import OptState
from .utils import tree_map


def params_from_jax(tree: Dict, cfg: ModelConfig, device="cuda") -> Dict:
    """``tree``: the reference parameter tree with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``). Returns the port's
    parameter dict on ``device``, shaped and typed as ``param_spec``."""
    def walk(spec, node, path):
        if isinstance(spec, dict):
            keys = sorted(node) if isinstance(node, dict) else node
            if keys != sorted(spec):
                raise ValueError(f"parameter tree at {path or '/'}: keys "
                                 f"{keys} != {sorted(spec)}")
            return {k: walk(spec[k], node[k], f"{path}/{k}") for k in spec}
        a = np.asarray(node, dtype=np.float32)
        if a.shape != tuple(spec.shape):
            raise ValueError(f"parameter {path}: shape {a.shape} != "
                             f"{tuple(spec.shape)}")
        return torch.tensor(a, dtype=spec.dtype, device=device)
    return walk(transformer.param_spec(cfg), tree, "")


def params_to_numpy(params: Dict, cfg: ModelConfig) -> Dict:
    """The port's parameters as the reference's tree of numpy arrays
    (f32; the same keys and shapes as ``params_from_jax`` takes)."""
    transformer.param_spec(cfg)          # raises for an unported family
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
