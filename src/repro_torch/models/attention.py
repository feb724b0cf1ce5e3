"""GQA attention: prefill (full or sliding-window causal) through the
flash-attention kernel, and one-token decode over a KV cache through the
flash-decode kernel. Port of ``repro/models/attention.py``
(``cross_attention`` waits for the enc-dec slice).

The KV cache is a dict {"k","v","pos"}: k/v (B, W, kvH, hd) and pos
(B, W) holding the *absolute* position stored in each slot (-1 = empty).
A full cache has W = max_seq; a sliding-window cache is a ring buffer
(slot t % W). RoPE is applied to k at write time, q at read time.

Unlike the JAX package, ``decode_attention`` updates the cache IN PLACE
(PyTorch tensors are mutable; a functional update would copy the whole
cache every step) and returns the same tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.flash_decode import flash_decode
from .layers import apply_rope, dense_init

NEG_INF = -1e30


def attn_init(gen: torch.Generator, d_model: int, n_heads: int,
              n_kv_heads: int, head_dim: int, *, layers: Optional[int],
              dtype: torch.dtype, device, qkv_bias: bool = False) -> Dict:
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, layers=layers,
                         dtype=dtype, device=device),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, layers=layers,
                         dtype=dtype, device=device),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, layers=layers,
                         dtype=dtype, device=device),
        "wo": dense_init(gen, n_heads * head_dim, d_model, layers=layers,
                         dtype=dtype, device=device),
    }
    if qkv_bias:
        def zeros(d):
            shape = (d,) if layers is None else (layers, d)
            return torch.zeros(shape, dtype=dtype, device=device)
        p["bq"] = zeros(n_heads * head_dim)
        p["bk"] = zeros(n_kv_heads * head_dim)
        p["bv"] = zeros(n_kv_heads * head_dim)
    return p


def _project_qkv(p: Dict, x: torch.Tensor, n_heads: int, n_kv_heads: int,
                 head_dim: int):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.view(B, S, n_heads, head_dim),
            k.view(B, S, n_kv_heads, head_dim),
            v.view(B, S, n_kv_heads, head_dim))


def attention(p: Dict, x: torch.Tensor, positions: torch.Tensor, *,
              n_heads: int, n_kv_heads: int, head_dim: int,
              rope_theta: float, causal: bool = True,
              sliding_window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill / training self-attention. x: (B,S,D); positions: (B,S) =
    arange(S) per row (the kernel masks causality on indices, as the
    Pallas kernel does). Returns (out (B,S,D), k, v), k post-RoPE, both
    (B,S,Kh,hd): the cache handoff, so the projections are not
    recomputed. Differentiable: on the card the gradient runs the
    flash-attention backward kernel."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    # (B,S,H,hd) -> (B,H,S,hd) as strided views; the kernel's output is a
    # (B,H,S,hd) view of a (B,S,H,hd) buffer, so the merge below is free
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        sliding_window=sliding_window)
    o = o.transpose(1, 2).reshape(B, S, n_heads * head_dim)
    return o @ p["wo"], k, v


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------
def init_cache(batch: int, window: int, n_kv_heads: int, head_dim: int,
               dtype: torch.dtype, device) -> Dict:
    return {
        "k": torch.zeros((batch, window, n_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, window, n_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.full((batch, window), -1, dtype=torch.int32,
                          device=device),
    }


def decode_attention(p: Dict, x: torch.Tensor, t: torch.Tensor,
                     cache: Dict, *, n_heads: int, n_kv_heads: int,
                     head_dim: int, rope_theta: float,
                     sliding_window: Optional[int] = None,
                     live: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. x: (B,1,D); t: (B,) absolute position of the new
    token. Writes slot t (full cache) or t % W (ring buffer) in place and
    attends over all valid slots. ``live`` (optional, (B,) bool): a row
    where it is False writes nothing (its cache stays as it was).

    A write to slot t >= W of a full cache is DROPPED, as JAX drops an
    out-of-range ``.at[].set`` (prompt + new tokens past the window, and
    the sequential admission path, reach it); the step still attends
    over the cache as it stands."""
    B, S, _ = x.shape
    assert S == 1
    W = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(p, x, n_heads, n_kv_heads, head_dim)
    pos = t[:, None]                                   # (B,1)
    q = apply_rope(q, pos, rope_theta)
    k_new = apply_rope(k_new, pos, rope_theta)
    slot = t % W if sliding_window is not None else t
    inside = slot < W
    if live is not None:
        inside = inside & live
    bidx = torch.arange(B, device=x.device)
    idx = torch.where(inside, slot, torch.zeros_like(slot)).long()
    keep = inside[:, None, None]
    for name, new in (("k", k_new[:, 0]), ("v", v_new[:, 0])):
        buf = cache[name]
        buf[bidx, idx] = torch.where(keep, new, buf[bidx, idx])
    cache["pos"][bidx, idx] = torch.where(inside, t.to(torch.int32),
                                          cache["pos"][bidx, idx])
    cpos = cache["pos"]
    qi = t[:, None]
    valid = (cpos >= 0) & (cpos <= qi)
    if sliding_window is not None:
        valid = valid & (qi - cpos < sliding_window)
    o = flash_decode(q[:, 0], cache["k"].permute(0, 2, 1, 3),
                     cache["v"].permute(0, 2, 1, 3), valid.to(torch.int32))
    return o.reshape(B, 1, n_heads * head_dim) @ p["wo"], cache
