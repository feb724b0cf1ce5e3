"""xLSTM blocks: mLSTM (matrix memory, chunkwise) and sLSTM (scalar
memory, sequential), arXiv:2405.04517. Port of ``repro/models/xlstm.py``.

mLSTM is linear-attention-like: ``C_t = f_t C_{t-1} + i_t v_t k_tᵀ``
with exponential gating stabilised in log space. ``mlstm_apply`` is the
full-sequence forward (prefill, training): the chunked recurrence runs
the ``mlstm_chunkwise`` kernel, where the reference runs the same chunked
math in jnp. Its result stays in f32 through the RMSNorm and the
``silu(z)`` gate and is cast to the activations' dtype only before
``down``, at the reference's rounding points. ``mlstm_decode_step`` is
the O(1)-state step in plain torch ops; the reference has no kernel for
it either.

sLSTM has a true hidden-to-hidden recurrence: ``slstm_apply`` is a loop
over time (the reference's ``lax.scan``), one step of small ops each.

The decode steps return the new state; ``transformer.decode_step``
writes it into the decode state in place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.mlstm_kernel import mlstm_chunkwise
from ..sharding import constrain, project
from .layers import dense_init


def _rmsnorm_f32(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The blocks' own RMSNorm of an f32 tensor (eps 1e-5), kept in f32."""
    var = torch.mean(y * y, dim=-1, keepdim=True)
    return y * torch.rsqrt(var + 1e-5) * w.float()


def _logsigmoid(t: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on the dry-run's DTensors per rank on the shards
    (``local_map``: DTensor has no rule for its backward)."""
    if type(t) is torch.Tensor:
        return F.logsigmoid(t)
    from ..kernels import meta
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in t.placements)
    return meta.run(F.logsigmoid, (t,), (pl,), pl)


def _merge_heads(y: torch.Tensor) -> torch.Tensor:
    """(B,S,NH,hd) -> (B,S,NH*hd). On the dry-run's DTensors per rank,
    in y's own layout: the gradient, which ``down``'s per-rank product
    returns sharded over "ff", is regathered to it first (DTensor cannot
    split a dim sharded unevenly over the heads)."""
    if type(y) is torch.Tensor:
        return y.flatten(2)
    from ..kernels import meta
    return meta.run(lambda t: t.flatten(2), (y,), (y.placements,),
                    y.placements)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_dims(d_model: int, n_heads: int,
               proj_factor: float = 2.0) -> Tuple[int, int]:
    """(d_in, head dim) of an mLSTM block."""
    d_in = int(proj_factor * d_model)
    return d_in, d_in // n_heads


def mlstm_param_shapes(d_model: int, *, n_heads: int, layers: Optional[int],
                       dtype: torch.dtype) -> Dict:
    """{name: (shape, dtype)} of one (stack of) mLSTM block(s): the gate
    projections ``wi``, ``wf`` and the forget bias ``fb`` stay f32, as in
    the reference."""
    d_in, _ = mlstm_dims(d_model, n_heads)
    lead = () if layers is None else (layers,)
    f32 = torch.float32
    return {"up": ((*lead, d_model, 2 * d_in), dtype),
            "wq": ((*lead, d_in, d_in), dtype),
            "wk": ((*lead, d_in, d_in), dtype),
            "wv": ((*lead, d_in, d_in), dtype),
            "wi": ((*lead, d_in, n_heads), f32),
            "wf": ((*lead, d_in, n_heads), f32),
            "fb": ((*lead, n_heads), f32),
            "norm_w": ((*lead, d_in), dtype),
            "down": ((*lead, d_in, d_model), dtype)}


def mlstm_init(gen: torch.Generator, d_model: int, *, n_heads: int,
               layers: Optional[int], dtype: torch.dtype, device) -> Dict:
    d_in, _ = mlstm_dims(d_model, n_heads)
    shapes = mlstm_param_shapes(d_model, n_heads=n_heads, layers=layers,
                                dtype=dtype)

    def dense(name, in_dim, **kw):
        return dense_init(gen, in_dim, shapes[name][0][-1], layers=layers,
                          dtype=shapes[name][1], device=device, **kw)

    return {
        "up": dense("up", d_model), "wq": dense("wq", d_in),
        "wk": dense("wk", d_in), "wv": dense("wv", d_in),
        "wi": dense("wi", d_in, scale=0.02),
        "wf": dense("wf", d_in, scale=0.02),
        "fb": torch.full(shapes["fb"][0], 3.0, dtype=torch.float32,
                         device=device),
        "norm_w": torch.ones(shapes["norm_w"][0], dtype=dtype, device=device),
        "down": dense("down", d_in),
    }


def _mlstm_in(p: Dict, u: torch.Tensor, n_heads: int):
    """The block's projections: (q, k, v) (B,S,NH,hd) in u's dtype (k
    already divided by sqrt(hd)), (logi, logf) (B,S,NH) f32, and the gate
    input z (B,S,d_in)."""
    B, S, _ = u.shape
    d_in = p["wq"].shape[-1]
    hd = d_in // n_heads
    hz = project(u, p["up"], "column")
    h, z = hz[..., :d_in], hz[..., d_in:]
    # the head split's layout set on the flat projections (the dry-run's
    # DTensors cannot split a dim sharded unevenly over the heads)
    q, k, v = (constrain(project(h, p[w], "column"), "batch", None,
                         "heads").unflatten(-1, (n_heads, hd))
               for w in ("wq", "wk", "wv"))
    k = k / math.sqrt(hd)
    hf = h.float()
    logi = project(hf, p["wi"], "column")
    logf = _logsigmoid(project(hf, p["wf"], "column") + p["fb"])
    return q, k, v, logi, logf, z


def _mlstm_out(p: Dict, y: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """f32 y (B,S,d_in) through the norm and the silu(z) gate, then
    ``down`` in the activations' dtype."""
    y = _rmsnorm_f32(y, p["norm_w"]) * F.silu(z.float())
    return project(y.to(dtype), p["down"], "row")


def mlstm_apply(p: Dict, u: torch.Tensor, *, n_heads: int) -> torch.Tensor:
    """Chunkwise mLSTM. u: (B,S,D) -> (B,S,D). q, k, v and the gates go
    to the kernel as (B,NH,S,·) views of the (B,S,NH,·) projections."""
    q, k, v, logi, logf, z = _mlstm_in(p, u, n_heads)
    y = mlstm_chunkwise(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), logi.transpose(1, 2),
                        logf.transpose(1, 2), out_dtype=torch.float32).transpose(1, 2)
    return _mlstm_out(p, _merge_heads(y), z, u.dtype)


def mlstm_state_shapes(batch: int, d_model: int, *, n_heads: int) -> Dict:
    """{"C": (B,NH,hd,hd), "n": (B,NH,hd), "m": (B,NH)}, all f32."""
    _, hd = mlstm_dims(d_model, n_heads)
    f32 = torch.float32
    return {"C": ((batch, n_heads, hd, hd), f32),
            "n": ((batch, n_heads, hd), f32),
            "m": ((batch, n_heads), f32)}


def mlstm_decode_step(p: Dict, u: torch.Tensor, st: Dict, *,
                      n_heads: int) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent step. u: (B,1,D); st: {"C","n","m"}. Returns
    (out (B,1,D), new state); ``st`` is not modified."""
    B = u.shape[0]
    q, k, v, logi, logf, z = _mlstm_in(p, u, n_heads)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    logi, logf = logi[:, 0], logf[:, 0]                          # (B,NH)
    m_new = torch.maximum(logf + st["m"], logi)
    fw = torch.exp(logf + st["m"] - m_new)
    iw = torch.exp(logi - m_new)
    C = (fw[..., None, None] * st["C"]
         + iw[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n = fw[..., None] * st["n"] + iw[..., None] * k
    num = (q[..., None, :] @ C)[..., 0, :]                      # (B,NH,hd)
    den = torch.abs(torch.sum(q * n, dim=-1))
    den = torch.maximum(den, torch.exp(-m_new))[..., None]
    y = (num / den).reshape(B, 1, -1)
    return _mlstm_out(p, y, z, u.dtype), {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_param_shapes(d_model: int, *, n_heads: int, layers: Optional[int],
                       dtype: torch.dtype) -> Dict:
    """{name: (shape, dtype)} of one (stack of) sLSTM block(s): four
    gates (i, f, z, o) from the input (``wx``) and, block-diagonal per
    head, from the hidden state (``wr``); the bias ``b`` stays f32."""
    hd = d_model // n_heads
    lead = () if layers is None else (layers,)
    return {"wx": ((*lead, d_model, 4 * d_model), dtype),
            "wr": ((*lead, n_heads, hd, 4 * hd), dtype),
            "b": ((*lead, 4 * d_model), torch.float32),
            "norm_w": ((*lead, d_model), dtype),
            "down": ((*lead, d_model, d_model), dtype)}


def slstm_init(gen: torch.Generator, d_model: int, *, n_heads: int,
               layers: Optional[int], dtype: torch.dtype, device) -> Dict:
    hd = d_model // n_heads
    shapes = slstm_param_shapes(d_model, n_heads=n_heads, layers=layers,
                                dtype=dtype)
    wr = torch.randn(shapes["wr"][0], generator=gen, dtype=torch.float32,
                     device=device)
    return {
        "wx": dense_init(gen, d_model, 4 * d_model, layers=layers,
                         dtype=dtype, device=device),
        "wr": (wr / math.sqrt(hd)).to(dtype),
        "b": torch.zeros(shapes["b"][0], dtype=torch.float32, device=device),
        "norm_w": torch.ones(shapes["norm_w"][0], dtype=dtype, device=device),
        "down": dense_init(gen, d_model, d_model, layers=layers, dtype=dtype,
                           device=device),
    }


def _slstm_gates(p: Dict, u: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Input gate pre-activations (B,S,NH,4hd) in f32: ``b`` is cast to
    u's dtype before the add, as the reference does."""
    B, S, D = u.shape
    gx = project(u, p["wx"], "row") + p["b"].to(u.dtype)
    return gx.reshape(B, S, n_heads, 4 * (D // n_heads)).float()


def _slstm_cell(g_x: torch.Tensor, wr: torch.Tensor, c, n, m, h):
    """One sLSTM step. g_x: (B,NH,4hd) f32; wr: (NH,hd,4hd) f32; the
    state (B,NH,hd) f32. Returns (c, n, m, h)."""
    g = g_x + torch.einsum("bhd,hdg->bhg", h, wr)
    gi, gf, gz, go = g.chunk(4, dim=-1)
    logf = F.logsigmoid(gf)
    m_new = torch.maximum(logf + m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(logf + m - m_new)
    c_new = f * c + i * torch.tanh(gz)
    n_new = f * n + i
    h_new = torch.sigmoid(go) * c_new / torch.clamp_min(n_new, 1e-6)
    return c_new, n_new, m_new, h_new


class _SlstmScanMeta(torch.autograd.Function):
    """The sLSTM time loop's closed form on ``meta`` tensors, forward and
    backward. The forward records the recurrent product h wr of every
    step (the counted FLOPs of the loop's ops), its gates read and its
    state read and written, and keeps what the loop's autograd graph
    would hold until the backward where a gradient is needed (about 16
    hd f32 a row and step: the gate pre-activations, the state and the
    cell's intermediates); the backward records twice the forward's
    products (dh wrᵀ and hᵀ dg a step) and returns empty gradients."""

    @staticmethod
    def forward(ctx, gx, wr):
        from ..kernels import meta
        B, S, NH, hd4 = gx.shape
        hs = torch.empty((S, B, NH, hd4 // 4), device="meta")  # the steps'
        y = torch.empty((B, S, NH, hd4 // 4), device="meta")   # h, stacked
        del hs
        meta.record("slstm_scan", 2 * S * B * NH * (hd4 // 4) * hd4,
                    meta.nbytes(gx, wr, y) + 8 * meta.nbytes(y))
        ctx.held = (torch.empty((S, B, NH, 4 * hd4), device="meta")
                    if any(ctx.needs_input_grad) else None)
        ctx.shapes = (gx.shape, wr.shape)
        return y

    @staticmethod
    def backward(ctx, dy):
        from ..kernels import meta
        (B, S, NH, hd4), wshape = ctx.shapes
        dgx = torch.empty((B, S, NH, hd4), device="meta")
        dwr = torch.empty(wshape, device="meta")
        meta.record("slstm_scan_bwd", 4 * S * B * NH * (hd4 // 4) * hd4,
                    meta.nbytes(ctx.held, dy, dgx, dwr))
        ctx.held = None
        return dgx, dwr


def _slstm_scan(gx: torch.Tensor, wr: torch.Tensor) -> torch.Tensor:
    """The sLSTM's time loop. gx: (B,S,NH,4hd) f32 -> h (B,S,NH,hd). On
    ``meta`` tensors (the dry-run's) a closed form stands in for the
    loop, as a kernel's meta rule does (``kernels/meta.py``): tens of
    thousands of traced steps would dominate the trace."""
    B, S, NH, hd4 = gx.shape
    if gx.device.type == "meta":
        return _SlstmScanMeta.apply(gx, wr)
    c = torch.zeros((B, NH, hd4 // 4), dtype=torch.float32,
                    device=gx.device)
    n, h = c, c
    m = torch.full_like(c, -1e30)
    hs = []
    for t in range(S):
        c, n, m, h = _slstm_cell(gx[:, t], wr, c, n, m, h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def slstm_apply(p: Dict, u: torch.Tensor, *, n_heads: int) -> torch.Tensor:
    """Sequential sLSTM over time. u: (B,S,D) -> (B,S,D). On the
    dry-run's DTensors the loop runs per rank on its rows (batch rows
    are independent)."""
    gx = _slstm_gates(p, u, n_heads)
    wr = p["wr"].float()
    if type(gx) is torch.Tensor:
        y = _slstm_scan(gx, wr)
    else:
        from ..kernels import meta
        pl = meta.placements(gx, {0: gx.shape[0]})
        # wr is replicated: its gradient from the batch shards is partial
        y = meta.run(_slstm_scan, (gx, wr),
                     (pl, meta.restrict(pl, ())), pl,
                     in_grad_placements=(pl, meta.partial_over(pl)))
    return project(_rmsnorm_f32(_merge_heads(y), p["norm_w"]).to(u.dtype),
                   p["down"], "row")


def slstm_state_shapes(batch: int, d_model: int, *, n_heads: int) -> Dict:
    """{"c", "n", "m", "h"}: (B,NH,hd) f32 each."""
    shape = ((batch, n_heads, d_model // n_heads), torch.float32)
    return {"c": shape, "n": shape, "m": shape, "h": shape}


def slstm_decode_step(p: Dict, u: torch.Tensor, st: Dict, *,
                      n_heads: int) -> Tuple[torch.Tensor, Dict]:
    """u: (B,1,D); st: {"c","n","m","h"}. Returns (out (B,1,D), new
    state); ``st`` is not modified."""
    B, _, D = u.shape
    c, n, m, h = _slstm_cell(_slstm_gates(p, u, n_heads)[:, 0],
                             p["wr"].float(), st["c"], st["n"], st["m"],
                             st["h"])
    y = _rmsnorm_f32(h.reshape(B, 1, D), p["norm_w"]).to(u.dtype)
    return project(y, p["down"], "row"), {"c": c, "n": n, "m": m, "h": h}
