"""Gradient compression for cross-pod sync: int8 quantization with error
feedback (EF-SGD style). Port of ``repro/optim/compression.py`` on
torch tensors and nested dicts of them.

At multi-pod scale the pod axis crosses slower links than the ones
inside a pod, so the gradient all-reduce over "pod" is the step's long
pole. Compressing to int8 with per-tensor scale cuts those bytes 2x vs
bf16 (4x vs f32); the quantization error is carried in a residual
accumulator and re-injected next step (error feedback), which keeps
SGD/Adam convergence (Karimireddy et al. 2019).

Usage: wrap the cross-pod reduction only — the intra-pod reduction stays
full precision:

    q, s, state = compress(grads, state)          # int8 + scales
    g_pod = decompress(q, s)  -> all-reduce over "pod" (2x fewer bytes)

As in the reference, nothing on the training path calls it; the
multi-host level-1 exchange keeps the reference's wire format.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..utils import tree_leaves, tree_map


class EFState(NamedTuple):
    residual: Dict      # error-feedback accumulator, mirrors grads


def init_ef_state(grads) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads))


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress(grads, state: EFState) -> Tuple[Dict, Dict, EFState]:
    """-> (q_tree int8, scale_tree f32 0-d, new_state). Error feedback:
    the un-transmitted remainder is carried to the next step."""
    corrected = tree_map(lambda g, r: g.to(torch.float32) + r, grads,
                         state.residual)
    qs = tree_map(_quant, corrected)
    q_tree = tree_map(lambda t: t[0], qs)
    s_tree = tree_map(lambda t: t[1], qs)
    residual = tree_map(lambda c, q, s: c - _dequant(q, s), corrected,
                        q_tree, s_tree)
    return q_tree, s_tree, EFState(residual=residual)


def decompress(q_tree, s_tree, dtype=torch.float32):
    return tree_map(lambda q, s: _dequant(q, s).to(dtype), q_tree, s_tree)


def compressed_bytes(grads) -> Tuple[int, int]:
    """(full f32 bytes, compressed int8+scale bytes) for reporting."""
    full = sum(g.numel() * 4 for g in tree_leaves(grads))
    comp = sum(g.numel() + 4 for g in tree_leaves(grads))
    return full, comp
