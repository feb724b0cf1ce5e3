"""Decoder stack of the dense family. Port of the dense branch of
``repro/models/transformer.py``: ``init_params``, ``param_spec``,
``forward`` (training with optional remat, and the prefill -> decode
cache handoff), the decode state and ``decode_step``.

The reference scans stacked per-layer parameters with ``lax.scan``; here
a Python loop walks the same stacked tensors layer by layer (unbound
once per forward, so the backward stacks the per-layer gradients in one
op). ``remat`` checkpoints each layer as ``jax.checkpoint(body)`` does:
only the layer's input is kept and the backward recomputes the layer.
Other families raise ``NotImplementedError`` naming the ROADMAP item
that ports them; the pipeline-stage split (``embed_tokens``,
``forward_stage``, ``head_logits``) waits for ROADMAP A.9.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

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


def param_spec(cfg: ModelConfig) -> Params:
    """The parameter tree as ``meta`` tensors: shapes and dtypes of
    ``init_params``'s tree, nothing allocated."""
    _require_dense(cfg)
    dt = _dt(cfg)
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    qd, kd = cfg.q_dim, cfg.kv_dim

    def m(*shape):
        return torch.empty(shape, dtype=dt, device="meta")
    attn = {"wq": m(L, D, qd), "wk": m(L, D, kd), "wv": m(L, D, kd),
            "wo": m(L, qd, D)}
    if cfg.qkv_bias:
        attn.update(bq=m(L, qd), bk=m(L, kd), bv=m(L, kd))
    p = {"embed": m(V, D), "final_norm": m(D),
         "blocks": {"ln1": m(L, D), "ln2": m(L, D), "attn": attn,
                    "mlp": {"gate": m(L, D, F), "up": m(L, D, F),
                            "down": m(L, F, D)}}}
    if not cfg.tie_embeddings:
        p["lm_head"] = m(V, D)
    return p


def _layer(tree: Dict, l: int) -> Dict:
    """Layer ``l``'s slice of a stacked parameter (or state) tree."""
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l])
            for k, v in tree.items()}


def _unstack(tree: Dict, n: int) -> List[Dict]:
    """The per-layer slices of a stacked tree, all at once (``unbind``:
    autograd stacks their gradients back in one op)."""
    parts = {k: (_unstack(v, n) if isinstance(v, dict) else v.unbind(0))
             for k, v in tree.items()}
    return [{k: parts[k][l] for k in parts} for l in range(n)]


def _head(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    hout = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return unembed_apply(
        params["embed"] if cfg.tie_embeddings else params["lm_head"], hout)


# ---------------------------------------------------------------------------
# Forward (training and prefill)
# ---------------------------------------------------------------------------
def _block(cfg: ModelConfig, pl: Dict, h: torch.Tensor,
           positions: torch.Tensor):
    """One decoder layer: (h, k, v), k post-RoPE (the cache handoff)."""
    hn = rmsnorm(h, pl["ln1"], cfg.norm_eps)
    a, k, v = A.attention(pl["attn"], hn, positions, n_heads=cfg.n_heads,
                          n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                          rope_theta=cfg.rope_theta, causal=True,
                          sliding_window=cfg.sliding_window)
    h = h + a
    h = h + mlp_apply(pl["mlp"], rmsnorm(h, pl["ln2"], cfg.norm_eps))
    return h, k, v


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            remat: bool = False, want_cache: bool = False):
    """Full-sequence forward. tokens: (B, S). Returns
    (logits (B,S,V), aux_loss, caches|None); caches are
    {"layers": {"k","v"}} stacked (L, B, S, Kh, hd), k post-RoPE.
    ``remat`` recomputes each layer in the backward (training only)."""
    _require_dense(cfg)
    if remat and want_cache:
        raise ValueError("forward: remat is for training; the cache "
                         "handoff is a serving path")
    h = embed_apply(params["embed"], tokens)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device)[None].expand(B, S)
    ks, vs = [], []
    for pl in _unstack(params["blocks"], cfg.n_layers):
        if remat:
            h = checkpoint(lambda x, p: _block(cfg, p, x, positions)[0],
                           h, pl, use_reentrant=False)
            continue
        h, k, v = _block(cfg, pl, h, positions)
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
