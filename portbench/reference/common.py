"""Shared plain pieces: products at a stated precision, RMSNorm, RoPE,
causal (windowed) attention, cross-entropy and AdamW."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a per-tensor scale (amax to the
    format's largest value); the gradient passes straight through."""
    s = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t.detach())


class _GradE5M2(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to float8 e5m2 at
    a per-tensor scale (an fp8 recipe's gradient format)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        s = g.abs().amax().clamp(min=1e-30) / E5M2_MAX
        return (g / s).to(torch.float8_e5m2).to(g.dtype) * s


class Precision:
    """``f32``: the reference; ``fp8``: the control, every product's
    operands in e4m3 and, in the backward, its incoming gradient in
    e5m2."""

    def __init__(self, name: str = "f32"):
        assert name in ("f32", "fp8"), name
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return fp8(t) if self.name == "fp8" else t

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        return _GradE5M2.apply(y) if self.name == "fp8" else y

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` (w laid out (in, out))."""
        return self._out(self.q(x) @ self.q(w))

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        return self._out(torch.einsum(eq, self.q(a), self.q(b)))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE; x (B, S, H, hd), pos (B, S) or (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = pos.to(torch.float32)[..., None] * inv
    if ang.ndim == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, qpos, kpos, window: Optional[int], prec: Precision,
           block: int = 1024):
    """softmax(q kᵀ / sqrt(hd)) v over the keys at or before each query
    (and within ``window`` of it), in f32, ``block`` queries at a time.
    q (B, Sq, H, hd); k, v (B, Sk, Kh, hd); qpos (B, Sq); kpos (B, Sk)
    absolute positions, -1 for a key that does not exist."""
    B, Sq, H, hd = q.shape
    g = H // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    outs = []
    for i in range(0, Sq, block):
        qb = q[:, i:i + block]
        s = prec.einsum("bqhd,bkhd->bhqk", qb, k) / math.sqrt(hd)
        qp = qpos[:, i:i + block, None]
        kp = kpos[:, None, :]
        ok = (kp >= 0) & (kp <= qp)
        if window is not None:
            ok = ok & (qp - kp < window)
        s = s.masked_fill(~ok[:, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(prec.einsum("bhqk,bkhd->bqhd", p, v))
    return torch.cat(outs, dim=1)


def xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long())


def adamw_lr(step: int, base: float, warmup: int, total: int) -> float:
    """The warm-up then cosine schedule at 1-based ``step``."""
    if step < warmup:
        return base * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return 0.5 * base * (1 + math.cos(math.pi * prog))


def adamw_step(params: Dict, grads: Dict, mu: Dict, nu: Dict, step: int,
                hp: Dict) -> None:
    """One AdamW update in place (f32 arithmetic, each parameter stored
    back in its own dtype): global-norm clipping, bias corrections,
    decoupled decay on matrices only. ``step`` is 1-based."""
    b1, b2, eps, wd = hp["b1"], hp["b2"], hp["eps"], hp["weight_decay"]
    lr = adamw_lr(step, hp["lr"], hp["warmup"], hp["total_steps"])
    gn = math.sqrt(sum(float(g.double().square().sum()) for g in
                       grads.values()))
    scale = min(1.0, hp["clip_norm"] / (gn + 1e-9))
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step
    for k, p in params.items():
        g = grads[k] * scale
        mu[k].mul_(b1).add_(g, alpha=1 - b1)
        nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
        d = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
        if p.ndim >= 2:
            d = d + wd * p.float()
        params[k] = (p.float() - lr * d).to(p.dtype)
