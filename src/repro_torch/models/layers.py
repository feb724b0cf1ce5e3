"""Shared model primitives: norms, rotary embeddings, SwiGLU MLP, linear
init. Port of ``repro/models/layers.py``.

Parameters are plain dicts of tensors laid out as in the JAX package:
a linear weight is ``(in, out)`` and applied as ``x @ w``, per-layer
weights are stacked along a leading layer dim. Norms and RoPE compute in
f32 and cast back, at the same rounding points as the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..sharding import constrain, project


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               layers: Optional[int], dtype: torch.dtype, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """(L?, in, out) truncated-normal init, fan-in scaled unless
    ``scale`` is given (the reference's distribution; ``jax.random``
    streams are not reproduced)."""
    shape = (in_dim, out_dim) if layers is None else (layers, in_dim, out_dim)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    if scale is None:
        return (w / math.sqrt(in_dim)).to(dtype)
    return (w * scale).to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * w.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate-half RoPE. x: (B, S, H, hd); positions: (B, S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             layers: Optional[int], dtype: torch.dtype, device) -> Dict:
    return {
        "gate": dense_init(gen, d_model, d_ff, layers=layers, dtype=dtype,
                           device=device),
        "up": dense_init(gen, d_model, d_ff, layers=layers, dtype=dtype,
                         device=device),
        "down": dense_init(gen, d_ff, d_model, layers=layers, dtype=dtype,
                           device=device),
    }


def mlp_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x @ gate) * (x @ up)) @ down, the three products per
    rank on the dry-run's DTensors (``sharding.project``)."""
    h = constrain(F.silu(project(x, p["gate"], "column"))
                  * project(x, p["up"], "column"), "batch", None, "ff")
    return project(h, p["down"], "row")


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype: torch.dtype, device) -> torch.Tensor:
    w = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def embed_apply(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if type(tokens) is torch.Tensor:
        return constrain(emb[tokens], "batch", None, None)
    return constrain(_embed_shards(emb, tokens), "batch", None, None)


def _embed_shards(emb, tokens):
    """``emb[tokens]`` on the dry-run's DTensors, per rank (``local_map``:
    DTensor has no rule for an index sharded over two mesh axes, the
    data-parallel-only layout's, and on some versions none for a table
    sharded on its rows). A replicated table is read at the rank's own
    token rows. A vocab-sharded one keeps its rows' shard: each rank
    reads its own rows, a token outside them reads zero, and the output
    is partial over the vocab's mesh dims until ``embed_apply`` reduces
    it; the table's gradient is scattered into the rank's own rows. An
    FSDP shard of the table's other dim is gathered where the tokens'
    batch is sharded, unless the tokens are fewer than the table's rows
    (a decode step: the tokens move, and the output is sharded there as
    the table is, as ``sharding.project`` does)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from ..kernels import meta
    V = emb.shape[0]
    pl = tokens.placements
    vocab = [p.is_shard(0) for p in emb.placements]
    if V % math.prod(emb.device_mesh.size(i)
                     for i, on in enumerate(vocab) if on):
        vocab = [False] * len(vocab)
    if not any(vocab):
        return meta.run(lambda e, t: e[t], (emb, tokens),
                        (emb.placements, pl), pl,
                        in_grad_placements=(meta.partial_over(pl), pl))
    R, d = Replicate(), tokens.ndim            # d: the output's model dim
    fsdp = [p.is_shard(1) and not v and (tokens.numel() < V
                                         or not t.is_shard())
            for p, v, t in zip(emb.placements, vocab, pl)]
    # per mesh dim: the table's, the tokens', the output's and the
    # table gradient's placements
    epl, tpl, opl, gpl = zip(*(
        (Shard(0), R, Partial(), Shard(0)) if v else
        (Shard(1), R, Shard(d), Shard(1)) if f else
        (R, t, t, Partial() if t.is_shard() else R)
        for v, f, t in zip(vocab, fsdp, pl)))

    def lookup(e, t):
        t, inside = meta.own_rows(t, emb, epl, 0)
        return torch.where(inside[..., None], e[t], 0)
    return meta.run(lookup, (emb, tokens), (epl, tpl), opl,
                    in_grad_placements=(gpl, tpl))


def unembed_apply(emb_or_head: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Logits in the weights' dtype: ``x @ w.T`` for the (vocab, d_model)
    embedding (tied) or head, per rank on the dry-run's DTensors."""
    return constrain(project(x, emb_or_head, "vocab"), "batch", None,
                     "vocab")
