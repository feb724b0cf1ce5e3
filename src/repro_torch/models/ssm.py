"""Mamba2 (SSD) block. Port of ``repro/models/ssm.py``.

State space, per head (state N, head dim P):
``h_t = a_t h_{t-1} + dt_t x_t B_tᵀ``, ``y_t = C_t h_t + D x_t``, with the
scalar decay ``a_t = exp(-exp(A_log) dt_t)``. ``ssm_apply`` is the
full-sequence forward (prefill, training): the scan runs the
``mamba2_scan`` kernel, where the reference runs the same chunked SSD in
jnp. ``ssm_decode_step`` is the O(1)-state decode step in plain torch
ops; the reference has no kernel for it either.

The scan's result stays in f32 through the D-skip, the gate and the
RMSNorm, and is cast to the activations' dtype only before
``out_proj``, at the reference's rounding points.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.mamba2_scan import mamba2_scan
from ..sharding import constrain, project
from .layers import dense_init


def ssm_dims(d_model: int, expand: int, headdim: int) -> Tuple[int, int]:
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    return d_inner, n_heads


def ssm_param_shapes(d_model: int, *, state: int, conv: int, expand: int,
                     headdim: int, layers: Optional[int],
                     dtype: torch.dtype) -> Dict:
    """{name: (shape, dtype)} of one (stack of) Mamba2 block(s):
    ``A_log``, ``D`` and ``dt_bias`` stay f32, as in the reference."""
    d_inner, nh = ssm_dims(d_model, expand, headdim)
    lead = () if layers is None else (layers,)
    # in_proj emits [z (gate), x, B, C, dt]
    d_proj = 2 * d_inner + 2 * state + nh
    f32 = torch.float32
    return {"in_proj": ((*lead, d_model, d_proj), dtype),
            "conv_w": ((*lead, conv, d_inner + 2 * state), dtype),
            "A_log": ((*lead, nh), f32), "D": ((*lead, nh), f32),
            "dt_bias": ((*lead, nh), f32),
            "out_proj": ((*lead, d_inner, d_model), dtype),
            "norm_w": ((*lead, d_inner), dtype)}


def ssm_init(gen: torch.Generator, d_model: int, *, state: int, conv: int,
             expand: int, headdim: int, layers: Optional[int],
             dtype: torch.dtype, device) -> Dict:
    d_inner, _ = ssm_dims(d_model, expand, headdim)
    shapes = ssm_param_shapes(d_model, state=state, conv=conv,
                              expand=expand, headdim=headdim, layers=layers,
                              dtype=dtype)

    def full(name, value):
        shape, dt = shapes[name]
        return torch.full(shape, value, dtype=dt, device=device)
    conv_w = torch.randn(shapes["conv_w"][0], generator=gen,
                         dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d_model, shapes["in_proj"][0][-1],
                              layers=layers, dtype=dtype, device=device),
        "conv_w": (conv_w * 0.1).to(dtype),
        "A_log": full("A_log", 0.0), "D": full("D", 1.0),
        "dt_bias": full("dt_bias", 0.0),
        "out_proj": dense_init(gen, d_inner, d_model, layers=layers,
                               dtype=dtype, device=device),
        "norm_w": full("norm_w", 1.0),
    }


def _split_proj(p: Dict, u: torch.Tensor, d_inner: int, state: int):
    """(z, xbc, dt): views of the one input projection (per rank on the
    dry-run's DTensors, ``sharding.project``)."""
    zxbcdt = project(u, p["in_proj"], "column")
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:2 * d_inner + 2 * state],
            zxbcdt[..., 2 * d_inner + 2 * state:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B,S,C) with taps (K,C), then SiLU."""
    K = w.shape[0]
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i]
    return F.silu(out)


def _gated_norm_out(p: Dict, y: torch.Tensor, z: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """Gated RMSNorm in f32, then the out-projection in ``dtype`` (per
    rank on the dry-run's DTensors)."""
    y = y * F.silu(z.float())
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-5) * p["norm_w"].float()
    y = constrain(y.to(dtype), "batch", None, "ff")
    return project(y, p["out_proj"], "row")


def ssm_apply(p: Dict, u: torch.Tensor, *, state: int, conv: int,
              expand: int, headdim: int, chunk: int = 256) -> torch.Tensor:
    """Training/prefill forward. u: (B,S,D) -> (B,S,D). The conv
    output's x, B and C go to the scan kernel as strided views. The two
    projections run per rank on the dry-run's DTensors."""
    B, S, D = u.shape
    d_inner, nh = ssm_dims(D, expand, headdim)
    z, xbc, dt = _split_proj(p, u, d_inner, state)
    xbc = _causal_conv(xbc, p["conv_w"])
    # the heads over "ff", as d_inner is at out_proj (a no-op w/o rules).
    # The reference has no such hint: GSPMD carries in_proj's "ff" shard
    # into the heads, where DTensor gathers the slices of a shard that
    # does not align with them and would scan every head on every rank.
    x = constrain(xbc[..., :d_inner].unflatten(-1, (nh, headdim)),
                  "batch", None, "ff", None)                    # (B,S,nh,P)
    Bmat = xbc[..., d_inner:d_inner + state]
    Cmat = xbc[..., d_inner + state:]
    dt = F.softplus(constrain(dt, "batch", None, "ff").float()
                    + p["dt_bias"])                             # (B,S,nh)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)                  # in (0,1)
    y = mamba2_scan(x.transpose(1, 2), Bmat, Cmat, a.transpose(1, 2),
                    dt.transpose(1, 2), chunk=chunk,
                    out_dtype=torch.float32).transpose(1, 2)    # (B,S,nh,P)
    y = y + x.float() * p["D"][..., None]
    return _gated_norm_out(p, y.reshape(B, S, d_inner), z, u.dtype)


# ---------------------------------------------------------------------------
# O(1)-state decode
# ---------------------------------------------------------------------------
def ssm_state_shapes(batch: int, d_model: int, *, state: int, conv: int,
                     expand: int, headdim: int, dtype: torch.dtype) -> Dict:
    """{"h": ((B,nh,P,N), f32), "conv": ((B,K-1,C), dtype)}."""
    d_inner, nh = ssm_dims(d_model, expand, headdim)
    return {"h": ((batch, nh, headdim, state), torch.float32),
            "conv": ((batch, conv - 1, d_inner + 2 * state), dtype)}


def ssm_init_state(batch: int, d_model: int, *, state: int, conv: int,
                   expand: int, headdim: int, dtype: torch.dtype,
                   device) -> Dict:
    shapes = ssm_state_shapes(batch, d_model, state=state, conv=conv,
                              expand=expand, headdim=headdim, dtype=dtype)
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in shapes.items()}


def ssm_decode_step(p: Dict, u: torch.Tensor, st: Dict, *, state: int,
                    conv: int, expand: int, headdim: int
                    ) -> Tuple[torch.Tensor, Dict]:
    """u: (B,1,D); st: {"h": (B,nh,P,N), "conv": (B,K-1,C)}. Returns
    (out (B,1,D), new state); ``st`` is not modified."""
    B, _, D = u.shape
    d_inner, nh = ssm_dims(D, expand, headdim)
    z, xbc, dt = _split_proj(p, u, d_inner, state)
    window = torch.cat([st["conv"], xbc], dim=1)                # (B,K,C)
    xbc_c = F.silu(torch.sum(window * p["conv_w"], dim=1, keepdim=True))
    x = xbc_c[:, 0, :d_inner].reshape(B, nh, headdim)
    Bv = xbc_c[:, 0, d_inner:d_inner + state].float()
    Cv = xbc_c[:, 0, d_inner + state:].float()
    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]            # (B,nh)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)                  # (B,nh)
    h = st["h"] * a[..., None, None] + torch.einsum(
        "bhp,bs,bh->bhps", x.float(), Bv, dt)
    y = torch.einsum("bs,bhps->bhp", Cv, h)
    y = y + x.float() * p["D"][..., None]
    out = _gated_norm_out(p, y.reshape(B, 1, d_inner), z, u.dtype)
    return out, {"h": h, "conv": window[:, 1:]}
