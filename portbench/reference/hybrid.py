"""The hybrid (zamba2 as the port lays it out) in plain PyTorch: groups
of k Mamba2 (SSD) layers, each group followed by one shared
attention + SwiGLU block, then the final norm and the head. Training:
three AdamW steps on given batches, in float32 from the stored bf16
weights, one sequence's forward and backward at a time (the loss is
the mean over equal-length rows, so the batch's gradient is the mean of
theirs). Returns what the check compares."""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from .common import Precision, adamw_step, attend, rmsnorm, rope, xent


def _ssd(x, Bm, Cm, la, dt, chunk: int, prec: Precision):
    """y_t = sum_{s<=t} (C_t . B_s) exp(la_{s+1} + ... + la_t) dt_s x_s,
    chunk by chunk: within a chunk as a masked product, across chunks
    through the carried state. x (S, nh, P); Bm, Cm (S, N); la, dt
    (S, nh)."""
    S, nh, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x, Bm, Cm, la, dt = (torch.cat([t, t.new_zeros((pad,)
                                                         + t.shape[1:])])
                             for t in (x, Bm, Cm, la, dt))
    xs = (x * dt[..., None]).view(nc, chunk, nh, P)
    Bc, Cc = Bm.view(nc, chunk, N), Cm.view(nc, chunk, N)
    cum = torch.cumsum(la.view(nc, chunk, nh), dim=1)          # (nc,c,nh)
    seg = cum[:, :, None, :] - cum[:, None, :, :]              # (nc,t,s,nh)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    seg = seg.masked_fill(~causal[None, :, :, None], float("-inf"))
    G = prec.einsum("ctn,csn->cts", Cc, Bc)                    # (nc,t,s)
    Wm = G[..., None] * torch.exp(seg)                         # (nc,t,s,nh)
    y = prec.einsum("ctsh,cshp->cthp", Wm, xs)
    # each chunk's own state contribution, then the carried states
    tail = torch.exp(cum[:, -1:, :] - cum)                     # (nc,c,nh)
    Sc = prec.einsum("cshp,csn->chpn", xs * tail[..., None], Bc)
    h = x.new_zeros((nh, P, N))
    hs = []
    for c in range(nc):
        hs.append(h)
        h = torch.exp(cum[c, -1])[:, None, None] * h + Sc[c]
    H = torch.stack(hs)                                        # (nc,nh,P,N)
    y = y + prec.einsum("ctn,chpn->cthp", Cc, H) * torch.exp(
        cum)[..., None]
    return y.reshape(nc * chunk, nh, P)[:S]


def _mamba(p: Dict, u, d: Dict, prec: Precision):
    """One Mamba2 layer on u (S, D)."""
    D_in = d["ssm_expand"] * d["d_model"]
    N, P = d["ssm_state"], d["ssm_headdim"]
    nh = D_in // P
    zxbcdt = prec.mm(u, p["in_proj"])
    z = zxbcdt[:, :D_in]
    xbc = zxbcdt[:, D_in:2 * D_in + 2 * N]
    dtr = zxbcdt[:, 2 * D_in + 2 * N:]
    K = p["conv_w"].shape[0]
    xp = torch.cat([xbc.new_zeros((K - 1, xbc.shape[1])), xbc])
    conv = sum(xp[i:i + xbc.shape[0]] * p["conv_w"][i] for i in range(K))
    xbc = F.silu(conv)
    x = xbc[:, :D_in].view(-1, nh, P)
    Bm, Cm = xbc[:, D_in:D_in + N], xbc[:, D_in + N:]
    dt = F.softplus(dtr + p["dt_bias"])
    la = -torch.exp(p["A_log"]) * dt
    y = _ssd(x, Bm, Cm, la, dt, d["ssd_chunk"], prec)
    y = y + x * p["D"][:, None]
    y = y.reshape(-1, D_in) * F.silu(z)
    y = rmsnorm(y, p["norm_w"], 1e-5)
    return prec.mm(y, p["out_proj"])


def _shared(p: Dict, h, d: Dict, prec: Precision):
    S = h.shape[0]
    H, Kh = d["n_heads"], d["n_kv_heads"]
    hd = d["head_dim"] or d["d_model"] // H
    pos = torch.arange(S, device=h.device)
    x = rmsnorm(h, p["ln1"], d["norm_eps"])
    q = prec.mm(x, p["attn"]["wq"]).view(1, S, H, hd)
    k = prec.mm(x, p["attn"]["wk"]).view(1, S, Kh, hd)
    v = prec.mm(x, p["attn"]["wv"]).view(1, S, Kh, hd)
    q, k = rope(q, pos, d["rope_theta"]), rope(k, pos, d["rope_theta"])
    o = attend(q, k, v, pos[None], pos[None], d["sliding_window"], prec)
    h = h + prec.mm(o.reshape(S, H * hd), p["attn"]["wo"])
    x = rmsnorm(h, p["ln2"], d["norm_eps"])
    m = F.silu(prec.mm(x, p["mlp"]["gate"])) * prec.mm(x, p["mlp"]["up"])
    return h + prec.mm(m, p["mlp"]["down"])


def _unflat(flat: Dict) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def loss(flat: Dict, tokens, targets, d: Dict, prec: Precision):
    """Mean next-token cross-entropy of one sequence (S,)."""
    p = _unflat(flat)
    h = p["embed"][tokens.long()]
    blocks = p["blocks"]
    G, k = blocks["ln1"].shape[:2]
    for g in range(G):
        for j in range(k):
            pl = {n: v[g, j] for n, v in blocks["ssm"].items()}
            h = h + _mamba(pl, rmsnorm(h, blocks["ln1"][g, j],
                                       d["norm_eps"]), d, prec)
        h = _shared(p["shared"], h, d, prec)
    h = rmsnorm(h, p["final_norm"], d["norm_eps"])
    return xent(prec.mm(h, p["lm_head"].t()), targets)


def train(flat_bf16: Dict, batches: List[Dict], d: Dict, hp: Dict,
          prec: Precision, rows=None) -> Dict:
    """``len(batches)`` AdamW steps from the stored weights. ``rows``
    (default all) are the rows of each batch the step averages over.
    Returns the losses, every leaf's norm of the first step's clipped
    gradient (the first moment over 1 - b1), every leaf's norm of its
    change over the steps, and every leaf's first gradient norm before
    clipping."""
    params = dict(flat_bf16)
    mu = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
          for k, v in params.items()}
    nu = {k: torch.zeros_like(m) for k, m in mu.items()}
    losses, first = [], None
    for step, b in enumerate(batches, start=1):
        use = rows if rows is not None else range(b["tokens"].shape[0])
        grads = {k: torch.zeros_like(m) for k, m in mu.items()}
        total = 0.0
        for r in use:
            leaves = {k: v.to(torch.float32, copy=True).requires_grad_(True)
                      for k, v in params.items()}
            l = loss(leaves, b["tokens"][r], b["targets"][r], d, prec)
            gs = torch.autograd.grad(l, list(leaves.values()))
            for k, g in zip(leaves, gs):
                grads[k].add_(g, alpha=1.0 / len(use))
            total += float(l.detach()) / len(use)
            del leaves, gs, l
        losses.append(total)
        if first is None:
            first = {k: float(g.norm()) for k, g in grads.items()}
        adamw_step(params, grads, mu, nu, step, hp)
        if step == 1:
            clipped = {k: float(m.norm()) / (1 - hp["b1"])
                       for k, m in mu.items()}
    change = {k: float((params[k].float() - flat_bf16[k].float()).norm())
              for k in params}
    return {"loss": losses, "grad": clipped, "change": change,
            "grad_raw": first}
