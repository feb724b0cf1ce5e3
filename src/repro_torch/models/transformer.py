"""Decoder stacks of every decoder-only family: dense, MoE, the VLM
backbone, plain ssm, hybrid (zamba2) and xLSTM. Port of
``repro/models/transformer.py``: ``init_params``, ``param_spec``,
``forward`` (training with optional remat, and the prefill -> decode
cache handoff), the decode state and ``decode_step``. The
encoder-decoder family lives in ``encdec.py``.

The reference scans stacked per-layer parameters with ``lax.scan``; here
a Python loop walks the same stacked tensors layer by layer (unbound
once per forward, so the backward stacks the per-layer gradients in one
op). The hybrid family is a GROUP scan: G groups of k Mamba2 blocks,
each group followed by the one shared attention+MLP block, whose KV
caches are stacked per application, (G, ...). xLSTM (family ssm with
``slstm_every = k``) is a GROUP scan too: G groups of k-1 mLSTM blocks
and one sLSTM block, parameters stacked (G, k-1, ...) and (G, ...).
``remat`` checkpoints one scan element (a layer, or a group) as
``jax.checkpoint(body)`` does: only its input is kept and the backward
recomputes it.

MoE layers replace the MLP with ``moe.moe_apply``; their load-balancing
losses are summed over the layers into ``forward``'s aux. The VLM
backbone is the dense stack over ``[patches; tokens]``: ``forward``
prepends the (B, n_vis, D) patch embeddings (the vision frontend is a
stub, as in the reference).

The pipeline-stage split (``pipeline_exec``): ``embed_tokens`` (the
input side), ``forward_stage`` (a contiguous slice of the stacked
blocks, a layer or a group each, walked by the same body as
``forward``'s, so chaining the slices is ``forward``) and
``head_logits`` (final norm and unembedding).

``decode_step`` updates the state in place (KV caches, SSM, mLSTM and
sLSTM carries), where the reference returns a new tree. Its optional
``live`` (B,) mask leaves a row's state untouched, its KV write
included: the length-masked admission scan (``ModelAPI.prefill_state_fn``)
freezes a row past its prompt with it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..sharding import constrain
from ..utils import tree_leaves
from . import attention as A
from . import moe as MOE
from . import ssm as SSM
from . import xlstm as XL
from .layers import (embed_apply, embed_init, mlp_apply, mlp_init, rmsnorm,
                     unembed_apply)

Params = Dict

# the families whose layer is attention + MLP (or MoE)
ATTN_FAMILIES = ("dense", "vlm", "moe")


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig) -> None:
    """The decoder-only families; enc-dec is ``encdec.py``'s."""
    if cfg.is_encdec or cfg.family not in ATTN_FAMILIES + ("ssm",
                                                           "hybrid"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                         f"decoder-only stack")


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(G groups, k blocks per group): hybrid k Mamba2 blocks (then the
    shared block), xLSTM k-1 mLSTM blocks and one sLSTM block."""
    k = cfg.hybrid_attn_every or cfg.slstm_every
    assert k and cfg.n_layers % k == 0, \
        f"{cfg.name}: {cfg.n_layers} layers not divisible by group {k}"
    return cfg.n_layers // k, k


def n_shared_apps(cfg: ModelConfig) -> int:
    """Hybrid: shared attention applications = group count."""
    if cfg.family != "hybrid" or not cfg.hybrid_attn_every:
        return 0
    return cfg.n_layers // cfg.hybrid_attn_every


def _ssm_kw(cfg: ModelConfig) -> Dict:
    return dict(state=cfg.ssm_state, conv=cfg.ssm_conv,
                expand=cfg.ssm_expand, headdim=cfg.ssm_headdim)


def _regroup(tree: Dict, G: int, k: int) -> Dict:
    """A layer-stacked (L, ...) tree as (G, k, ...)."""
    return {n: (_regroup(v, G, k) if isinstance(v, dict)
                else v.reshape(G, k, *v.shape[1:])) for n, v in tree.items()}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, gen: torch.Generator,
                device="cuda") -> Params:
    """Random parameters from ``gen`` (which must live on ``device``'s
    type), laid out like the reference's tree."""
    _check_family(cfg)
    dt = _dt(cfg)
    L, D = cfg.n_layers, cfg.d_model
    p: Params = {"embed": embed_init(gen, cfg.vocab_size, D, dt, device),
                 "final_norm": torch.ones((D,), dtype=dt, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.vocab_size, D, dt, device)
    if cfg.family in ATTN_FAMILIES:
        p["blocks"] = {
            "ln1": torch.ones((L, D), dtype=dt, device=device),
            "ln2": torch.ones((L, D), dtype=dt, device=device),
            "attn": A.attn_init(gen, D, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                layers=L, dtype=dt, device=device,
                                qkv_bias=cfg.qkv_bias),
        }
        if cfg.family == "moe":
            p["blocks"]["moe"] = MOE.moe_init(gen, D, cfg.d_ff,
                                              cfg.n_experts, layers=L,
                                              dtype=dt, device=device)
        else:
            p["blocks"]["mlp"] = mlp_init(gen, D, cfg.d_ff, layers=L,
                                          dtype=dt, device=device)
        return p
    if cfg.slstm_every:
        G, k = _groups(cfg)
        p["blocks"] = {
            "m_ln": torch.ones((G, k - 1, D), dtype=dt, device=device),
            "s_ln": torch.ones((G, D), dtype=dt, device=device),
            "mlstm": _regroup(XL.mlstm_init(gen, D, n_heads=cfg.n_heads,
                                            layers=G * (k - 1), dtype=dt,
                                            device=device), G, k - 1),
            "slstm": XL.slstm_init(gen, D, n_heads=cfg.n_heads, layers=G,
                                   dtype=dt, device=device),
        }
        return p
    ssm_p = SSM.ssm_init(gen, D, layers=L, dtype=dt, device=device,
                         **_ssm_kw(cfg))
    if cfg.family == "ssm":
        p["blocks"] = {"ln1": torch.ones((L, D), dtype=dt, device=device),
                       "ssm": ssm_p}
        return p
    G, k = _groups(cfg)
    p["blocks"] = {"ssm": _regroup(ssm_p, G, k),
                   "ln1": torch.ones((G, k, D), dtype=dt, device=device)}
    p["shared"] = {
        "ln1": torch.ones((D,), dtype=dt, device=device),
        "ln2": torch.ones((D,), dtype=dt, device=device),
        "attn": A.attn_init(gen, D, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                            layers=None, dtype=dt, device=device,
                            qkv_bias=cfg.qkv_bias),
        "mlp": mlp_init(gen, D, cfg.d_ff, layers=None, dtype=dt,
                        device=device),
    }
    return p


def param_spec(cfg: ModelConfig) -> Params:
    """The parameter tree as ``meta`` tensors: shapes and dtypes of
    ``init_params``'s tree, nothing allocated."""
    _check_family(cfg)
    dt = _dt(cfg)
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    qd, kd = cfg.q_dim, cfg.kv_dim

    def m(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    def attn_mlp(*lead):
        attn = {"wq": m(*lead, D, qd), "wk": m(*lead, D, kd),
                "wv": m(*lead, D, kd), "wo": m(*lead, qd, D)}
        if cfg.qkv_bias:
            attn.update(bq=m(*lead, qd), bk=m(*lead, kd), bv=m(*lead, kd))
        return attn, {"gate": m(*lead, D, F), "up": m(*lead, D, F),
                      "down": m(*lead, F, D)}

    p = {"embed": m(V, D), "final_norm": m(D)}
    if not cfg.tie_embeddings:
        p["lm_head"] = m(V, D)
    if cfg.family in ATTN_FAMILIES:
        attn, mlp = attn_mlp(L)
        p["blocks"] = {"ln1": m(L, D), "ln2": m(L, D), "attn": attn}
        if cfg.family == "moe":
            p["blocks"]["moe"] = {
                n: m(L, *s, dtype=sdt) for n, (s, sdt) in
                MOE.moe_param_shapes(D, F, cfg.n_experts, dt).items()}
        else:
            p["blocks"]["mlp"] = mlp
        return p
    if cfg.slstm_every:
        G, k = _groups(cfg)
        kw = dict(n_heads=cfg.n_heads, layers=None, dtype=dt)
        p["blocks"] = {
            "m_ln": m(G, k - 1, D), "s_ln": m(G, D),
            "mlstm": {n: m(G, k - 1, *s, dtype=sdt) for n, (s, sdt)
                      in XL.mlstm_param_shapes(D, **kw).items()},
            "slstm": {n: m(G, *s, dtype=sdt) for n, (s, sdt)
                      in XL.slstm_param_shapes(D, **kw).items()}}
        return p
    lead = (L,) if cfg.family == "ssm" else _groups(cfg)
    shapes = SSM.ssm_param_shapes(D, layers=None, dtype=dt, **_ssm_kw(cfg))
    p["blocks"] = {"ln1": m(*lead, D),
                   "ssm": {n: m(*lead, *s, dtype=sdt)
                           for n, (s, sdt) in shapes.items()}}
    if cfg.family == "hybrid":
        attn, mlp = attn_mlp()
        p["shared"] = {"ln1": m(D), "ln2": m(D), "attn": attn, "mlp": mlp}
    return p


def _layer(tree: Dict, l) -> Dict:
    """Element ``l`` (an index or a tuple of them) of a stacked parameter
    (or state) tree."""
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
def _attn(cfg: ModelConfig, p: Dict, hn: torch.Tensor,
          positions: torch.Tensor):
    return A.attention(p, hn, positions, n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                       rope_theta=cfg.rope_theta, causal=True,
                       sliding_window=cfg.sliding_window)


def _ffn(cfg: ModelConfig, pl: Dict, hn: torch.Tensor):
    """The layer's MLP, or its MoE layer: (y, aux or None)."""
    if cfg.family == "moe":
        return MOE.moe_apply(pl["moe"], hn, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor,
                             group_size=cfg.moe_group_size)
    return mlp_apply(pl["mlp"], hn), None


def _block(cfg: ModelConfig, pl: Dict, h: torch.Tensor,
           positions: torch.Tensor, shared: Optional[Dict]):
    """One dense, VLM or MoE decoder layer: (h, k, v, aux), k post-RoPE
    (the cache handoff), aux the MoE layer's loss (None for an MLP)."""
    a, k, v = _attn(cfg, pl["attn"], rmsnorm(h, pl["ln1"], cfg.norm_eps),
                    positions)
    h = constrain(h + a, "batch", None, None)
    y, aux = _ffn(cfg, pl, rmsnorm(h, pl["ln2"], cfg.norm_eps))
    return constrain(h + y, "batch", None, None), k, v, aux


def _ssm_block(cfg: ModelConfig, pl: Dict, h: torch.Tensor,
               positions: torch.Tensor, shared: Optional[Dict]):
    """One Mamba2 layer: (h, None, None, None)."""
    y = SSM.ssm_apply(pl["ssm"], rmsnorm(h, pl["ln1"], cfg.norm_eps),
                      **_ssm_kw(cfg))
    return h + y, None, None, None


def _hybrid_group(cfg: ModelConfig, pg: Dict, h: torch.Tensor,
                  positions: torch.Tensor, shared: Dict):
    """k Mamba2 layers, then the shared attention+MLP block: (h, k, v,
    None), k and v of that application."""
    for pl in _unstack(pg, cfg.hybrid_attn_every):
        h = _ssm_block(cfg, pl, h, positions, None)[0]
    a, k, v = _attn(cfg, shared["attn"],
                    rmsnorm(h, shared["ln1"], cfg.norm_eps), positions)
    h = h + a
    h = h + mlp_apply(shared["mlp"], rmsnorm(h, shared["ln2"], cfg.norm_eps))
    return h, k, v, None


def _xlstm_group(cfg: ModelConfig, pg: Dict, h: torch.Tensor,
                 positions: torch.Tensor, shared: Optional[Dict]):
    """k-1 mLSTM blocks, then the sLSTM block: (h, None, None, None)."""
    k = cfg.slstm_every
    for pm in _unstack({"m_ln": pg["m_ln"], "mlstm": pg["mlstm"]}, k - 1):
        h = h + XL.mlstm_apply(pm["mlstm"],
                               rmsnorm(h, pm["m_ln"], cfg.norm_eps),
                               n_heads=cfg.n_heads)
    return h + XL.slstm_apply(pg["slstm"],
                              rmsnorm(h, pg["s_ln"], cfg.norm_eps),
                              n_heads=cfg.n_heads), None, None, None


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            patches: Optional[torch.Tensor] = None, remat: bool = False,
            want_cache: bool = False):
    """Full-sequence forward. tokens: (B, S_txt). For the VLM backbone,
    ``patches`` (B, n_vis, D) are prepended to the token embeddings.
    Returns (logits (B,S,V), aux_loss, caches|None): aux the MoE layers'
    summed load-balancing loss (an f32 zero for the other families);
    caches {"layers": {"k","v"}} stacked (L or G, B, S, Kh, hd), k
    post-RoPE — {"layers": None} for the plain-ssm and xLSTM families,
    which have no KV.
    ``remat`` recomputes each scan element in the backward (training
    only)."""
    _check_family(cfg)
    if remat and want_cache:
        raise ValueError("forward: remat is for training; the cache "
                         "handoff is a serving path")
    h = embed_apply(params["embed"], tokens)
    if cfg.family == "vlm":
        if patches is None:
            raise ValueError(f"{cfg.name}: the VLM forward needs patches")
        h = torch.cat([patches.to(h.dtype), h], dim=1)
    h = constrain(h, "batch", None, None)
    h, aux, ks, vs = _walk(cfg, params["blocks"], h, params.get("shared"),
                           remat=remat, want_cache=want_cache)
    logits = _head(cfg, params, h)
    caches = None
    if want_cache:
        caches = {"layers": ({"k": torch.stack(ks), "v": torch.stack(vs)}
                             if ks else None)}
    return logits, aux, caches


def _walk(cfg: ModelConfig, blocks: Params, h: torch.Tensor,
          shared: Optional[Dict], *, remat: bool, want_cache: bool):
    """The stacked blocks (all of them, or a contiguous slice) over
    ``h``, one scan element (a layer, or a group) at a time: (h, aux,
    ks, vs), aux the summed MoE losses (f32), the per-element caches
    when ``want_cache``."""
    S = h.shape[1]
    # (1, S), broadcast over the batch by RoPE
    positions = torch.arange(S, dtype=torch.int32, device=h.device)[None]
    if cfg.family == "hybrid":
        body = _hybrid_group
    elif cfg.slstm_every:
        body = _xlstm_group
    else:
        body = _block if cfg.family in ATTN_FAMILIES else _ssm_block
    n = {v.shape[0] for v in tree_leaves(blocks)}
    assert len(n) == 1, f"ragged scan axis: {n}"
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    ks, vs = [], []
    for pl in _unstack(blocks, n.pop()):
        if remat:
            def run(x, p):
                out = body(cfg, p, x, positions, shared)
                return out[0], out[3]          # (h, aux)
            h, a = checkpoint(run, h, pl, use_reentrant=False)
            k = None
        else:
            h, k, v, a = body(cfg, pl, h, positions, shared)
        if a is not None:
            aux = aux + a
        if want_cache and k is not None:
            ks.append(k)
            vs.append(v)
    return h, aux, ks, vs


# ---------------------------------------------------------------------------
# Pipeline-stage decomposition (pipeline_exec): embed | block slice | head
# ---------------------------------------------------------------------------
def embed_tokens(cfg: ModelConfig, params: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The input-side pipeline stage: tokens (B, S) -> h (B, S, D). The
    VLM backbone (patches first) and enc-dec have no such stage."""
    _check_family(cfg)
    if cfg.family == "vlm":
        raise ValueError(f"{cfg.name}: the VLM backbone has no token-only "
                         f"input stage")
    return embed_apply(params["embed"], tokens)


def forward_stage(cfg: ModelConfig, blocks: Params, h: torch.Tensor, *,
                  shared: Optional[Params] = None,
                  remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """A contiguous SLICE of the stacked blocks over an incoming
    activation: one pipeline stage's compute, by the same body as the
    slice inside ``forward``, so chaining the stage slices is the full
    forward exactly. Returns (h, aux_slice): the slice's MoE losses (an
    f32 zero for the other families), summed across stages by the
    caller."""
    _check_family(cfg)
    h, aux, _, _ = _walk(cfg, blocks, h, shared, remat=remat,
                         want_cache=False)
    return h, aux


def head_logits(cfg: ModelConfig, params: Params,
                h: torch.Tensor) -> torch.Tensor:
    """The output-side pipeline stage: final norm + (tied) unembedding."""
    return _head(cfg, params, h)


# ---------------------------------------------------------------------------
# Decode (one token; stacked caches and states walked with the layers)
# ---------------------------------------------------------------------------
def decode_state_shapes(cfg: ModelConfig, batch: int, window: int) -> Dict:
    """{"layers": {leaf: (shape, dtype)}} of the decode state, in the
    reference's tree: dense, VLM and MoE {"k","v","pos"} (L, B, ...),
    the window capped at the sliding window (a ring buffer); plain ssm
    {"h","conv"} (L, B, ...); hybrid {"ssm": {"h","conv"} (G, k, B, ...),
    "shared": {"k","v","pos"} (G, B, ...)}; xLSTM {"mlstm": {"C","n","m"}
    (G, k-1, B, ...), "slstm": {"c","n","m","h"} (G, B, ...)}."""
    _check_family(cfg)
    dt = _dt(cfg)
    W = min(window, cfg.sliding_window) if cfg.sliding_window else window

    def kv(n):
        shape = (n, batch, W, cfg.n_kv_heads, cfg.hd)
        return {"k": (shape, dt), "v": (shape, dt),
                "pos": ((n, batch, W), torch.int32)}
    if cfg.family in ATTN_FAMILIES:
        return {"layers": kv(cfg.n_layers)}
    if cfg.slstm_every:
        G, k = _groups(cfg)
        ms = XL.mlstm_state_shapes(batch, cfg.d_model, n_heads=cfg.n_heads)
        ss = XL.slstm_state_shapes(batch, cfg.d_model, n_heads=cfg.n_heads)
        return {"layers": {
            "mlstm": {n: ((G, k - 1, *s), sdt) for n, (s, sdt) in ms.items()},
            "slstm": {n: ((G, *s), sdt) for n, (s, sdt) in ss.items()}}}
    ssm = SSM.ssm_state_shapes(batch, cfg.d_model, dtype=dt, **_ssm_kw(cfg))
    if cfg.family == "ssm":
        return {"layers": {n: ((cfg.n_layers, *s), sdt)
                           for n, (s, sdt) in ssm.items()}}
    G, k = _groups(cfg)
    return {"layers": {"ssm": {n: ((G, k, *s), sdt)
                               for n, (s, sdt) in ssm.items()},
                       "shared": kv(G)}}


def zeros_state(shapes: Dict, device) -> Dict:
    """A decode state from its (shape, dtype) tree: zeros, and -1 (=
    empty slot) for the int32 position leaves."""
    if isinstance(shapes, dict):
        return {k: zeros_state(v, device) for k, v in shapes.items()}
    shape, dt = shapes
    if dt == torch.int32:
        return torch.full(shape, -1, dtype=dt, device=device)
    return torch.zeros(shape, dtype=dt, device=device)


def init_decode_state(cfg: ModelConfig, batch: int, window: int,
                      device="cuda") -> Dict:
    """``zeros_state`` of ``decode_state_shapes``. The mLSTM and sLSTM
    stabilisers ``m`` start at 0 too, as the reference's zero-filled
    state does (the start value only rescales the carries)."""
    return zeros_state(decode_state_shapes(cfg, batch, window), device)


def _decode_attn(cfg: ModelConfig, p: Dict, hn: torch.Tensor,
                 t: torch.Tensor, cache: Dict, live):
    return A.decode_attention(p, hn, t, cache, n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                              rope_theta=cfg.rope_theta,
                              sliding_window=cfg.sliding_window,
                              live=live)[0]


def _write_state(st: Dict, new: Dict, live) -> None:
    """Write a layer's new carries into its state views ``st`` (rows
    where ``live`` is False keep theirs)."""
    for name, v in new.items():
        if live is not None:
            v = torch.where(live.view(-1, *[1] * (v.ndim - 1)), v, st[name])
        st[name].copy_(v)


def _ssm_decode(cfg: ModelConfig, pl: Dict, h: torch.Tensor, st: Dict,
                live) -> torch.Tensor:
    """One Mamba2 layer's decode step; writes its new carry into ``st``."""
    y, new = SSM.ssm_decode_step(pl["ssm"], rmsnorm(h, pl["ln1"],
                                                    cfg.norm_eps),
                                 st, **_ssm_kw(cfg))
    _write_state(st, new, live)
    return h + y


def decode_step(cfg: ModelConfig, params: Params, state: Dict,
                token: torch.Tensor, t: torch.Tensor,
                live: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One new token. token: (B,) int; t: (B,) absolute positions; live:
    optional (B,) bool, False freezes a row's state. Updates ``state`` in
    place and returns (logits (B,V), state)."""
    _check_family(cfg)
    h = embed_apply(params["embed"], token[:, None])           # (B,1,D)
    layers = state["layers"]
    blocks = params["blocks"]
    if cfg.family in ATTN_FAMILIES:
        # MoE: the step's B tokens dispatch together, with capacity
        # min(int(max(1, cf·B·k/E)), B) per expert, as in the reference
        for l in range(cfg.n_layers):
            pl = _layer(blocks, l)
            h = h + _decode_attn(cfg, pl["attn"],
                                 rmsnorm(h, pl["ln1"], cfg.norm_eps), t,
                                 _layer(layers, l), live)
            h = h + _ffn(cfg, pl, rmsnorm(h, pl["ln2"], cfg.norm_eps))[0]
    elif cfg.slstm_every:
        G, k = _groups(cfg)
        for g in range(G):
            for j in range(k - 1):
                pm = _layer(blocks["mlstm"], (g, j))
                st = _layer(layers["mlstm"], (g, j))
                y, new = XL.mlstm_decode_step(
                    pm, rmsnorm(h, blocks["m_ln"][g, j], cfg.norm_eps), st,
                    n_heads=cfg.n_heads)
                _write_state(st, new, live)
                h = h + y
            st = _layer(layers["slstm"], g)
            y, new = XL.slstm_decode_step(
                _layer(blocks["slstm"], g),
                rmsnorm(h, blocks["s_ln"][g], cfg.norm_eps), st,
                n_heads=cfg.n_heads)
            _write_state(st, new, live)
            h = h + y
    elif cfg.family == "ssm":
        for l in range(cfg.n_layers):
            h = _ssm_decode(cfg, _layer(blocks, l), h, _layer(layers, l),
                            live)
    else:
        shared = params["shared"]
        G, k = _groups(cfg)
        for g in range(G):
            for j in range(k):
                h = _ssm_decode(cfg, _layer(blocks, (g, j)), h,
                                _layer(layers["ssm"], (g, j)), live)
            h = h + _decode_attn(cfg, shared["attn"],
                                 rmsnorm(h, shared["ln1"], cfg.norm_eps), t,
                                 _layer(layers["shared"], g), live)
            h = h + mlp_apply(shared["mlp"],
                              rmsnorm(h, shared["ln2"], cfg.norm_eps))
    return _head(cfg, params, h)[:, 0], state
