"""GQA attention: prefill (full or sliding-window causal) through the
flash-attention kernel, one-token decode over a KV cache through the
flash-decode kernel, and the enc-dec's cross-attention through both.
Port of ``repro/models/attention.py``.

The KV cache is a dict {"k","v","pos"}: k/v (B, W, kvH, hd) and pos
(B, W) holding the *absolute* position stored in each slot (-1 = empty).
A full cache has W = max_seq; a sliding-window cache is a ring buffer
(slot t % W). RoPE is applied to k at write time, q at read time.

Unlike the JAX package, ``decode_attention`` updates the cache IN PLACE
(PyTorch tensors are mutable; a functional update would copy the whole
cache every step) and returns the same tensors.

Cross-attention is position-free (no RoPE) over the encoder's K/V. The
reference computes it as a plain softmax in ``jnp``; here it goes
through the port's own kernels, as self-attention does: several query
rows (the teacher-forced decoder) through ``flash_attention`` with
``causal=False`` and Sq != Sk, one query row (a decode step) through
``flash_decode`` with every encoder key valid.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.flash_decode import flash_decode
from ..sharding import constrain, project
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
    q = project(x, p["wq"], "column")
    k = project(x, p["wk"], "column")
    v = project(x, p["wv"], "column")
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    # the head split's layout, set on the flat projection before the view
    # (a DTensor cannot split a dim sharded unevenly over its heads)
    q = constrain(q, "batch", None, "heads")
    k = constrain(k, "batch", None, "kv_heads")
    v = constrain(v, "batch", None, "kv_heads")
    return (q.view(B, S, n_heads, head_dim),
            k.view(B, S, n_kv_heads, head_dim),
            v.view(B, S, n_kv_heads, head_dim))


def attention(p: Dict, x: torch.Tensor, positions: torch.Tensor, *,
              n_heads: int, n_kv_heads: int, head_dim: int,
              rope_theta: float, causal: bool = True,
              sliding_window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill / training self-attention. x: (B,S,D); positions: (B,S) or
    (1,S) = arange(S) per row (the kernel masks causality on indices, as the
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
    o = constrain(o.transpose(1, 2), "batch", None, "heads", None)
    return project(o.reshape(B, S, n_heads * head_dim), p["wo"], "row"), k, v


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
    for name, new in (("k", k_new[:, 0]), ("v", v_new[:, 0]),
                      ("pos", t.to(torch.int32))):
        _write_slot(cache[name], bidx, idx, inside, new)
    cpos = cache["pos"]
    qi = t[:, None]
    valid = (cpos >= 0) & (cpos <= qi)
    if sliding_window is not None:
        valid = valid & (qi - cpos < sliding_window)
    o = flash_decode(q[:, 0], cache["k"].permute(0, 2, 1, 3),
                     cache["v"].permute(0, 2, 1, 3), valid.to(torch.int32))
    return project(o.reshape(B, 1, n_heads * head_dim), p["wo"], "row"), \
        cache


def _write_slot(buf: torch.Tensor, bidx: torch.Tensor, idx: torch.Tensor,
                keep: torch.Tensor, new: torch.Tensor) -> None:
    """``buf[b, idx[b]] = new[b]`` in place, in the rows where ``keep``;
    ``bidx`` is ``arange(B)``."""
    if type(buf) is not torch.Tensor:
        return _write_slot_shards(buf, idx, keep, new)
    keep = keep.view(-1, *[1] * (new.ndim - 1))
    buf[bidx, idx] = torch.where(keep, new, buf[bidx, idx])


def _write_slot_shards(buf, idx, keep, new) -> None:
    """``_write_slot`` on a DTensor cache with ``meta`` shards (the
    dry-run's): each rank writes the rows of its own shard, in place, as
    DTensor cannot index-put into a sharded buffer. The window (dim 1) is
    never resharded; on meta shards only the shapes matter."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if buf.device.type != "meta":
        raise ValueError("_write_slot: a DTensor cache must have meta "
                         "shards")
    mesh = buf.device_mesh

    def local(x, dims):
        """x's local shard, laid out as buf's dims ``dims`` are (x's dim
        i is buf's dim dims[i])."""
        pl = tuple(Shard(dims.index(p.dim))
                   if isinstance(p, Shard) and p.dim in dims
                   else Replicate() for p in buf.placements)
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return x.redistribute(mesh, pl).to_local()
    rest = (0,) + tuple(range(2, buf.ndim))       # buf's dims but the window
    lbuf = buf.to_local()
    _write_slot(lbuf, torch.arange(lbuf.shape[0], device=lbuf.device),
                local(idx, (0,)), local(keep, (0,)), local(new, rest))


# ---------------------------------------------------------------------------
# Cross-attention (enc-dec); encoder output is position-free (no rope)
# ---------------------------------------------------------------------------
def cross_attention(p: Dict, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor], *,
                    n_heads: int, n_kv_heads: int,
                    head_dim: int) -> torch.Tensor:
    """x: (B,S,D) decoder rows; enc_kv: k, v (B,S_enc,Kh,hd) from
    ``cross_kv``. Every query attends over every encoder position."""
    B, S, _ = x.shape
    q = project(x, p["wq"], "column")
    if "bq" in p:
        q = q + p["bq"]
    q = constrain(q, "batch", None, "heads").view(B, S, n_heads, head_dim)
    k, v = (t.transpose(1, 2) for t in enc_kv)        # (B,Kh,S_enc,hd)
    if S == 1:
        valid = torch.ones((B, k.shape[2]), dtype=torch.int32,
                           device=x.device)
        o = flash_decode(q[:, 0], k, v, valid)
    else:
        o = flash_attention(q.transpose(1, 2), k, v,
                            causal=False).transpose(1, 2)
    return project(o.reshape(B, S, n_heads * head_dim), p["wo"], "row")


def cross_kv(p: Dict, enc_out: torch.Tensor, *, n_kv_heads: int,
             head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's K/V, once per sequence (reused every decode step):
    two (B,S_enc,Kh,hd)."""
    B, S, _ = enc_out.shape
    k = project(enc_out, p["wk"], "column")
    v = project(enc_out, p["wv"], "column")
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    k = constrain(k, "batch", None, "kv_heads")
    v = constrain(v, "batch", None, "kv_heads")
    return (k.view(B, S, n_kv_heads, head_dim),
            v.view(B, S, n_kv_heads, head_dim))
