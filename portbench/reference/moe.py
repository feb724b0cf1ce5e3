"""The MoE decoder (mixtral as the port runs it) in plain PyTorch, in
float32 from the stored bf16 weights, one layer's weights cast at a
time: GQA attention with RoPE over a causal sliding window, then top-k
experts with a capacity per group of tokens (GShard/Switch dispatch):
the tokens flatten in row-major order into groups of ``group_size``,
each expert takes the (token, choice) pairs in token-major order up to
``C = min(int(max(1, cf * Tg * k / E)), Tg)`` and a pair past it gets
nothing. The expert products are computed directly on the tokens each
expert keeps (no one-hot products).

``prefill`` runs whole rows (an admission group's rows that share its
capacity groups) and returns each row's K/V and the logits at chosen
positions; ``decode`` runs one step over every slot of a KV cache, a
ring of ``window`` slots holding each entry's absolute position."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .common import Precision, attend, rmsnorm, rope


def _layer(blocks: Dict, l: int) -> Dict:
    """Layer ``l``'s weights in float32."""
    out = {}
    for k, v in blocks.items():
        out[k] = _layer(v, l) if isinstance(v, dict) else v[l].float()
    return out


def moe(p: Dict, x: torch.Tensor, d: Dict, prec: Precision):
    """x (T, D) in row-major token order -> (T, D)."""
    T, D = x.shape
    E, K = d["n_experts"], d["top_k"]
    Tg = min(d["moe_group_size"] or T, T)
    G = -(-T // Tg)
    xt = torch.cat([x, x.new_zeros((G * Tg - T, D))]) if G * Tg > T else x
    C = min(int(max(1, d["capacity_factor"] * Tg * K / E)), Tg)
    probs = torch.softmax(xt @ p["router"], dim=-1)            # (GTg, E)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = vals[:, :K] / vals[:, :K].sum(-1, keepdim=True)
    choice = idx[:, :K]
    y = torch.zeros_like(xt)
    for g in range(G):
        sl = slice(g * Tg, (g + 1) * Tg)
        ch = choice[sl].reshape(-1)                            # (Tg*K,)
        oh = F.one_hot(ch, E)
        pos = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1)        # queue place
        keep = (pos < C).view(Tg, K)
        for e in range(E):
            hit = (choice[sl] == e) & keep                     # (Tg, K)
            tok = hit.any(-1).nonzero()[:, 0]
            if tok.numel() == 0:
                continue
            w = (gate[sl][tok] * hit[tok]).sum(-1, keepdim=True)
            xe = xt[sl][tok]
            h = F.silu(prec.mm(xe, p["gate"][e])) * prec.mm(xe, p["up"][e])
            y[g * Tg + tok] += w * prec.mm(h, p["down"][e])
    return y[:T]


def _qkv(p: Dict, x, d: Dict, pos, prec: Precision):
    H, Kh = d["n_heads"], d["n_kv_heads"]
    hd = d["head_dim"] or d["d_model"] // H
    lead = x.shape[:-1]
    q = prec.mm(x, p["wq"]).view(*lead, H, hd)
    k = prec.mm(x, p["wk"]).view(*lead, Kh, hd)
    v = prec.mm(x, p["wv"]).view(*lead, Kh, hd)
    return rope(q, pos, d["rope_theta"]), rope(k, pos, d["rope_theta"]), v


def prefill(params: Dict, tokens: torch.Tensor, want: List[Tuple[int, int]],
            d: Dict, prec: Precision, keep_kv: Tuple[int, ...] = ()):
    """tokens (R, S): rows run together (the MoE groups span them).
    Returns (logits (len(want), V) at the (row, position) pairs,
    {row: [(k, v)] per layer} for the rows in ``keep_kv``)."""
    R, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(R, S)
    h = params["embed"][tokens.long()].float()
    kv = {r: [] for r in keep_kv}
    eps = d["norm_eps"]
    for l in range(d["n_layers"]):
        p = _layer(params["blocks"], l)
        x = rmsnorm(h, p["ln1"], eps)
        q, k, v = _qkv(p["attn"], x, d, pos, prec)
        o = attend(q, k, v, pos, pos, d["sliding_window"], prec)
        h = h + prec.mm(o.reshape(R, S, -1), p["attn"]["wo"])
        for r in keep_kv:
            kv[r].append((k[r], v[r]))
        x = rmsnorm(h, p["ln2"], eps)
        h = h + moe(p["moe"], x.reshape(R * S, -1), d, prec).view(R, S, -1)
        del p, x, q, k, v, o
    rows = torch.tensor([w[0] for w in want], device=h.device)
    cols = torch.tensor([w[1] for w in want], device=h.device)
    hl = rmsnorm(h[rows, cols], params["final_norm"].float(), eps)
    return prec.mm(hl, params["lm_head"].float().t()), kv


def decode(params: Dict, cache: Dict, token: torch.Tensor, t: torch.Tensor,
           d: Dict, prec: Precision) -> torch.Tensor:
    """One step over every slot: token, t (B,). ``cache``: per layer
    {"k", "v"} (B, W, Kh, hd) float32 and "pos" (B, W), written in
    place at slot t % W. Returns logits (B, V)."""
    B = token.shape[0]
    h = params["embed"][token.long()].float()                  # (B, D)
    eps = d["norm_eps"]
    bidx = torch.arange(B, device=h.device)
    for l in range(d["n_layers"]):
        p = _layer(params["blocks"], l)
        c = cache[l]
        W = c["k"].shape[1]
        x = rmsnorm(h, p["ln1"], eps)
        q, k, v = _qkv(p["attn"], x[:, None], d, t[:, None], prec)
        slot = (t % W).long()
        c["k"][bidx, slot] = k[:, 0]
        c["v"][bidx, slot] = v[:, 0]
        c["pos"][bidx, slot] = t.to(c["pos"].dtype)
        o = attend(q, c["k"], c["v"], t[:, None], c["pos"],
                   d["sliding_window"], prec)
        h = h + prec.mm(o.reshape(B, -1), p["attn"]["wo"])
        x = rmsnorm(h, p["ln2"], eps)
        h = h + moe(p["moe"], x, d, prec)
    hl = rmsnorm(h, params["final_norm"].float(), eps)
    return prec.mm(hl, params["lm_head"].float().t())


def gap(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below its row's best, in units of
    the row's standard deviation over the vocabulary (so the number
    means the same at any width)."""
    raw = logits.max(-1).values - logits.gather(
        -1, tokens.long()[:, None])[:, 0]
    return raw / logits.std(-1)

