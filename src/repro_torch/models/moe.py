"""Mixture-of-Experts feed-forward with capacity-based dense dispatch
(GShard/Switch style): top-k routing, per-expert capacity, one-hot
dispatch/combine products. Port of ``repro/models/moe.py``.

Expert weights carry a leading expert dim, ``(L?, E, D, F)`` and
``(L?, E, F, D)``; the router is f32 ``(L?, D, E)``. The arithmetic is the
reference's, step for step: the tokens are padded with zero rows up to
G groups of Tg, the router logits are taken in f32 from an f32 cast of
x, the gates renormalised over the top k, each expert's queue filled in
token-major ``(Tg·k)`` order up to its capacity
``C = min(int(max(1, cf·Tg·k/E)), Tg)`` (a token past it gets nothing
from that expert), and the dispatch and combine one-hots cast to x's
dtype before their products. The reference's sharding hints
(``constrain``) have no counterpart on one card. Every product here is a
plain large matrix product that the reference leaves to XLA outside any
Pallas kernel, so it stays ``torch.einsum``.

Top-k order: ``jax.lax.top_k`` puts the lower index first among equal
values, and the zero-padded rows have zero logits, so all E
probabilities tie there and the aux loss reads their first choice.
``torch.topk`` does not specify its order on ties, so ``_top_k`` takes a
stable descending sort and keeps its first k columns.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             *, layers: Optional[int], dtype: torch.dtype, device) -> Dict:
    def exp_w(din, dout):
        """(L?, E, din, dout) expert-stacked weights, drawn one layer at a
        time (a whole stack's f32 draw would need several times the
        stack's bf16 bytes on the card)."""
        lead = () if layers is None else (layers,)
        out = torch.empty((*lead, n_experts, din, dout), dtype=dtype,
                          device=device)
        for l in range(layers or 1):
            w = dense_init(gen, din, dout * n_experts, layers=None,
                           dtype=dtype, device=device)
            (out[l] if layers else out).copy_(
                w.view(din, n_experts, dout).permute(1, 0, 2))
        return out

    return {
        "router": dense_init(gen, d_model, n_experts, layers=layers,
                             dtype=torch.float32, device=device, scale=0.02),
        "gate": exp_w(d_model, d_ff),     # (L?, E, D, F)
        "up": exp_w(d_model, d_ff),       # (L?, E, D, F)
        "down": exp_w(d_ff, d_model),     # (L?, E, F, D)
    }


def moe_param_shapes(d_model: int, d_ff: int, n_experts: int,
                     dtype: torch.dtype) -> Dict:
    """{leaf: (shape, dtype)} of one layer's ``moe_init`` tree."""
    D, F_, E = d_model, d_ff, n_experts
    return {"router": ((D, E), torch.float32), "gate": ((E, D, F_), dtype),
            "up": ((E, D, F_), dtype), "down": ((E, F_, D), dtype)}


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: Dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float,
              group_size: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (out (B,S,D), aux_loss f32 scalar).

    Grouped dense dispatch: the tokens split into groups of
    ``group_size`` and each group dispatches within its own capacity;
    ``group_size=0`` is one group of all the tokens."""
    B, S, D = x.shape
    E = p["router"].shape[-1]
    T = B * S
    Tg = T if not group_size else min(group_size, T)
    # pad T to a multiple of the group size
    G = (T + Tg - 1) // Tg
    pad = G * Tg - T
    xt = x.reshape(T, D)
    if pad:
        xt = torch.cat([xt, xt.new_zeros((pad, D))])
    xg = xt.view(G, Tg, D)
    logits = xg.float() @ p["router"]                        # (G,Tg,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)               # (G,Tg,K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    C = int(max(1, capacity_factor * Tg * top_k / E))
    C = min(C, Tg)
    # position of each (token, k) within its expert's per-group queue
    onehot = F.one_hot(gate_idx, E).to(torch.int32)          # (G,Tg,K,E)
    flat = onehot.view(G, Tg * top_k, E)
    pos_in_exp = (torch.cumsum(flat, dim=1, dtype=torch.int32)
                  - flat).view(G, Tg, top_k, E)
    pos = (pos_in_exp * onehot).sum(-1)                      # (G,Tg,K)
    keep = pos < C
    oh = onehot.float() * keep[..., None]
    # one-hot of the queue position, all zeros past the capacity
    posoh = (pos[..., None] == torch.arange(C, device=x.device)).float()
    disp = torch.einsum("gtke,gtkc->gtec", oh, posoh)
    # at most one k of a token names expert e, so folding the gate into
    # the first operand is the reference's three-way product exactly
    comb = torch.einsum("gtke,gtkc->gtec", oh * gate_vals[..., None],
                        posoh)
    xin = torch.einsum("gtec,gtd->gecd", disp.to(x.dtype), xg)
    h = F.silu(torch.einsum("gecd,edf->gecf", xin, p["gate"])) \
        * torch.einsum("gecd,edf->gecf", xin, p["up"])
    out = torch.einsum("gecf,efd->gecd", h, p["down"])       # (G,E,C,D)
    y = torch.einsum("gtec,gecd->gtd", comb.to(x.dtype), out)
    y = y.reshape(G * Tg, D)[:T]
    # load-balancing auxiliary loss (Switch): E * sum(f_e * P_e)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    return y.reshape(B, S, D), aux
