"""Encoder-decoder (Whisper-style) stack. Port of
``repro/models/encdec.py``. The audio conv frontend is a stub, as in the
reference: the caller supplies precomputed frame embeddings
(B, enc_seq, d_model). Encoder: non-causal self-attention; decoder:
causal self-attention + cross-attention over the encoder output.

Positions as in the reference: RoPE on self-attention in both stacks,
position-free cross-attention. The encoder's self-attention runs the
flash-attention kernel with ``causal=False`` (Sq = Sk = enc_seq); the
cross-attention is ``attention.cross_attention``'s (the kernel with
Sq != Sk at prefill, the decode kernel at one token).

``decode_step`` updates the self-attention cache in place, as the
decoder-only stacks do; the cross K/V in the state are read only. The
prefill (``forward(want_cache=True)``) returns only the cross K/V
(``{"cross_k", "cross_v"}`` stacked (L, B, S_enc, Kh, hd)), as the
reference does; a caller copies them into the decode state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import attention as A
from .layers import (embed_apply, embed_init, mlp_apply, mlp_init, rmsnorm,
                     unembed_apply)
from .transformer import _dt, _layer, _unstack, zeros_state

Params = Dict


def _attn_kw(cfg: ModelConfig) -> Dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.hd)


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device="cuda") -> Params:
    """Random parameters from ``gen``, laid out like the reference's
    tree (an untied ``lm_head``)."""
    dt = _dt(cfg)
    Le, Ld, D = cfg.encoder_layers, cfg.n_layers, cfg.d_model

    def attn(n):
        return A.attn_init(gen, D, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           layers=n, dtype=dt, device=device,
                           qkv_bias=cfg.qkv_bias)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    return {
        "embed": embed_init(gen, cfg.vocab_size, D, dt, device),
        "enc_blocks": {
            "ln1": ones(Le, D), "ln2": ones(Le, D), "attn": attn(Le),
            "mlp": mlp_init(gen, D, cfg.d_ff, layers=Le, dtype=dt,
                            device=device),
        },
        "enc_norm": ones(D),
        "dec_blocks": {
            "ln1": ones(Ld, D), "lnx": ones(Ld, D), "ln2": ones(Ld, D),
            "attn": attn(Ld), "xattn": attn(Ld),
            "mlp": mlp_init(gen, D, cfg.d_ff, layers=Ld, dtype=dt,
                            device=device),
        },
        "final_norm": ones(D),
        "lm_head": embed_init(gen, cfg.vocab_size, D, dt, device),
    }


def param_spec(cfg: ModelConfig) -> Params:
    """The parameter tree as ``meta`` tensors (nothing allocated)."""
    dt = _dt(cfg)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    qd, kd = cfg.q_dim, cfg.kv_dim

    def m(*shape):
        return torch.empty(shape, dtype=dt, device="meta")

    def attn(n):
        a = {"wq": m(n, D, qd), "wk": m(n, D, kd), "wv": m(n, D, kd),
             "wo": m(n, qd, D)}
        if cfg.qkv_bias:
            a.update(bq=m(n, qd), bk=m(n, kd), bv=m(n, kd))
        return a

    def mlp(n):
        return {"gate": m(n, D, F), "up": m(n, D, F), "down": m(n, F, D)}

    Le, Ld = cfg.encoder_layers, cfg.n_layers
    return {
        "embed": m(V, D),
        "enc_blocks": {"ln1": m(Le, D), "ln2": m(Le, D), "attn": attn(Le),
                       "mlp": mlp(Le)},
        "enc_norm": m(D),
        "dec_blocks": {"ln1": m(Ld, D), "lnx": m(Ld, D), "ln2": m(Ld, D),
                       "attn": attn(Ld), "xattn": attn(Ld), "mlp": mlp(Ld)},
        "final_norm": m(D),
        "lm_head": m(V, D),
    }


def encode(cfg: ModelConfig, params: Params,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed embeddings -> (B, S_enc, D)."""
    B, S, _ = frames.shape
    h = frames.to(_dt(cfg))
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None].expand(B, S)
    for pl in _unstack(params["enc_blocks"], cfg.encoder_layers):
        a = A.attention(pl["attn"], rmsnorm(h, pl["ln1"], cfg.norm_eps),
                        positions, rope_theta=cfg.rope_theta, causal=False,
                        **_attn_kw(cfg))[0]
        h = h + a
        h = h + mlp_apply(pl["mlp"], rmsnorm(h, pl["ln2"], cfg.norm_eps))
    return rmsnorm(h, params["enc_norm"], cfg.norm_eps)


def _dec_block(cfg: ModelConfig, pl: Dict, h: torch.Tensor,
               positions: torch.Tensor, enc_out: torch.Tensor):
    """One decoder layer over the whole target sequence: (h, cross k,
    cross v)."""
    hn = rmsnorm(h, pl["ln1"], cfg.norm_eps)
    h = h + A.attention(pl["attn"], hn, positions,
                        rope_theta=cfg.rope_theta, causal=True,
                        **_attn_kw(cfg))[0]
    kv = A.cross_kv(pl["xattn"], enc_out, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.hd)
    h = h + A.cross_attention(pl["xattn"],
                              rmsnorm(h, pl["lnx"], cfg.norm_eps), kv,
                              **_attn_kw(cfg))
    h = h + mlp_apply(pl["mlp"], rmsnorm(h, pl["ln2"], cfg.norm_eps))
    return h, kv[0], kv[1]


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            frames: torch.Tensor, *, remat: bool = False,
            want_cache: bool = False):
    """Teacher-forced decoder over ``tokens`` given encoder ``frames``.
    Returns (logits, aux = f32 zero, caches|None), caches
    {"cross_k", "cross_v"} stacked (L, B, S_enc, Kh, hd). ``remat``
    recomputes each decoder layer in the backward (training only), as
    the reference checkpoints its decoder scan body."""
    if remat and want_cache:
        raise ValueError("forward: remat is for training; the cache "
                         "handoff is a serving path")
    enc_out = encode(cfg, params, frames)
    B, S = tokens.shape
    h = embed_apply(params["embed"], tokens)
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None].expand(B, S)
    ck, cv = [], []
    for pl in _unstack(params["dec_blocks"], cfg.n_layers):
        if remat:
            h = checkpoint(lambda x, p: _dec_block(cfg, p, x, positions,
                                                   enc_out)[0],
                           h, pl, use_reentrant=False)
            continue
        h, k, v = _dec_block(cfg, pl, h, positions, enc_out)
        ck.append(k)
        cv.append(v)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = unembed_apply(params["lm_head"], h)
    caches = ({"cross_k": torch.stack(ck), "cross_v": torch.stack(cv)}
              if want_cache else None)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=h.device), caches


# ---------------------------------------------------------------------------
# Decode: self-attn KV cache + precomputed per-layer cross K/V
# ---------------------------------------------------------------------------
def decode_state_shapes(cfg: ModelConfig, batch: int, window: int) -> Dict:
    """{"layers": {"k","v","pos"} (L, B, W, ...), "cross_k", "cross_v"
    (L, B, S_enc, Kh, hd)} as (shape, dtype) leaves; the self-attention
    cache is a full one of ``window`` slots."""
    dt = _dt(cfg)
    L, Kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    kv = (L, batch, window, Kh, hd)
    cross = (L, batch, cfg.encoder_seq, Kh, hd)
    return {"layers": {"k": (kv, dt), "v": (kv, dt),
                       "pos": ((L, batch, window), torch.int32)},
            "cross_k": (cross, dt), "cross_v": (cross, dt)}


def init_decode_state(cfg: ModelConfig, batch: int, window: int,
                      device="cuda") -> Dict:
    """Zeros (the cross K/V too: a caller copies the prefill's in), -1
    for the empty self-attention slots."""
    return zeros_state(decode_state_shapes(cfg, batch, window), device)


def decode_step(cfg: ModelConfig, params: Params, state: Dict,
                token: torch.Tensor, t: torch.Tensor,
                live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One new decoder token. token: (B,) int; t: (B,) absolute
    positions; live: optional (B,) bool, False leaves a row's cache
    untouched. Updates the self-attention cache in place and returns
    (logits (B,V), state)."""
    h = embed_apply(params["embed"], token[:, None])           # (B,1,D)
    blocks = params["dec_blocks"]
    for l in range(cfg.n_layers):
        pl = _layer(blocks, l)
        h = h + A.decode_attention(
            pl["attn"], rmsnorm(h, pl["ln1"], cfg.norm_eps), t,
            _layer(state["layers"], l), rope_theta=cfg.rope_theta,
            live=live, **_attn_kw(cfg))[0]
        h = h + A.cross_attention(
            pl["xattn"], rmsnorm(h, pl["lnx"], cfg.norm_eps),
            (state["cross_k"][l], state["cross_v"][l]), **_attn_kw(cfg))
        h = h + mlp_apply(pl["mlp"], rmsnorm(h, pl["ln2"], cfg.norm_eps))
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return unembed_apply(params["lm_head"], h)[:, 0], state
