"""Decoder stack of the dense family. Port of the dense branch of
``repro/models/transformer.py``: ``init_params``, ``forward`` (with the
prefill -> decode cache handoff), the decode state and ``decode_step``.

The reference scans stacked per-layer parameters with ``lax.scan``; here
a Python loop walks the same stacked tensors layer by layer. Other
families raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import attention as A
from .layers import (embed_apply, embed_init, mlp_apply, mlp_init, rmsnorm,
                     unembed_apply)

Params = Dict

_PENDING = {
    "moe": "ROADMAP A.8 (MoE)",
    "vlm": "ROADMAP A.8 (VLM backbone)",
    "audio": "ROADMAP A.8 (enc-dec)",
    "ssm": "ROADMAP A.7 (recurrent families: mamba2_scan / mlstm)",
    "hybrid": "ROADMAP A.7 (recurrent families: mamba2_scan)",
}


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; see "
            f"{_PENDING.get(cfg.family, 'ROADMAP')}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, gen: torch.Generator,
                device="cuda") -> Params:
    """Random parameters from ``gen`` (which must live on ``device``'s
    type), laid out like the reference's tree."""
    _require_dense(cfg)
    dt = _dt(cfg)
    L = cfg.n_layers
    p: Params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                     device),
                 "final_norm": torch.ones((cfg.d_model,), dtype=dt,
                                          device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                  device)
    p["blocks"] = {
        "ln1": torch.ones((L, cfg.d_model), dtype=dt, device=device),
        "ln2": torch.ones((L, cfg.d_model), dtype=dt, device=device),
        "attn": A.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, layers=L, dtype=dt, device=device,
                            qkv_bias=cfg.qkv_bias),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, layers=L, dtype=dt,
                        device=device),
    }
    return p


def _layer(tree: Dict, l: int) -> Dict:
    """Layer ``l``'s slice of a stacked parameter (or state) tree."""
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l])
            for k, v in tree.items()}


def _head(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    hout = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return unembed_apply(
        params["embed"] if cfg.tie_embeddings else params["lm_head"], hout)


# ---------------------------------------------------------------------------
# Prefill forward
# ---------------------------------------------------------------------------
def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            want_cache: bool = False):
    """Full-sequence forward. tokens: (B, S). Returns
    (logits (B,S,V), aux_loss, caches|None); caches are
    {"layers": {"k","v"}} stacked (L, B, S, Kh, hd), k post-RoPE."""
    _require_dense(cfg)
    h = embed_apply(params["embed"], tokens)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None].expand(B, S)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        pl = _layer(params["blocks"], l)
        hn = rmsnorm(h, pl["ln1"], cfg.norm_eps)
        a, k, v = A.attention(pl["attn"], hn, positions,
                              n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                              rope_theta=cfg.rope_theta, causal=True,
                              sliding_window=cfg.sliding_window)
        h = h + a
        h = h + mlp_apply(pl["mlp"], rmsnorm(h, pl["ln2"], cfg.norm_eps))
        if want_cache:
            ks.append(k)
            vs.append(v)
    logits = _head(cfg, params, h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = None
    if want_cache:
        caches = {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    return logits, aux, caches


# ---------------------------------------------------------------------------
# Decode (one token; stacked caches walked with the layers)
# ---------------------------------------------------------------------------
def decode_state_shapes(cfg: ModelConfig, batch: int, window: int) -> Dict:
    """{"layers": {leaf: (shape, dtype)}} of the decode state."""
    _require_dense(cfg)
    W = min(window, cfg.sliding_window) if cfg.sliding_window else window
    L, dt = cfg.n_layers, _dt(cfg)
    kv = ((L, batch, W, cfg.n_kv_heads, cfg.hd), dt)
    return {"layers": {"k": kv, "v": kv,
                       "pos": ((L, batch, W), torch.int32)}}


def init_decode_state(cfg: ModelConfig, batch: int, window: int,
                      device="cuda") -> Dict:
    """Zeros, and -1 (= empty slot) for the int32 position leaves."""
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, dt = spec
        if dt == torch.int32:
            return torch.full(shape, -1, dtype=dt, device=device)
        return torch.zeros(shape, dtype=dt, device=device)
    return make(decode_state_shapes(cfg, batch, window))


def decode_step(cfg: ModelConfig, params: Params, state: Dict,
                token: torch.Tensor, t: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
    """One new token. token: (B,) int; t: (B,) absolute positions.
    Updates ``state``'s caches in place and returns (logits (B,V), state)."""
    _require_dense(cfg)
    h = embed_apply(params["embed"], token[:, None])           # (B,1,D)
    layers = state["layers"]
    for l in range(cfg.n_layers):
        pl = _layer(params["blocks"], l)
        hn = rmsnorm(h, pl["ln1"], cfg.norm_eps)
        a, _ = A.decode_attention(
            pl["attn"], hn, t, _layer(layers, l), n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta, sliding_window=cfg.sliding_window)
        h = h + a
        h = h + mlp_apply(pl["mlp"], rmsnorm(h, pl["ln2"], cfg.norm_eps))
    return _head(cfg, params, h)[:, 0], state
