"""xLSTM mLSTM chunkwise kernel on Hopper, beside its plain PyTorch
version.

Port of ``repro/kernels/mlstm_kernel.py`` (the Pallas TPU kernel). The
layout is the JAX kernel's: q/k/v ``(B, NH, S, hd)``, logi/logf
``(B, NH, S)`` f32; y is like q, in ``out_dtype`` (q's dtype by
default). It computes the matrix-memory recurrence
``C_t = f_t C_{t-1} + i_t k_t v_tᵀ``, ``n_t = f_t n_{t-1} + i_t k_t``,
``y_t = q_t C_t / max(|q_t n_t|, 1)`` (exponential gates, in the
absolute frame) in the chunked form, stabilised in log space: within a
chunk ``W = (q kᵀ) ∘ exp(logD - m)`` with
``logD = lf_t - lf_s + logi_s`` on the lower triangle, the incoming
state's term ``(q ∘ exp(lf - m)) C``, and ``y = num / max(|den|,
exp(-m))``; ``C`` and ``n`` carried from chunk to chunk. Every
``exp(-m)`` cancels, so the chunk length changes only rounding.

``mlstm_chunkwise`` takes the plain version only for CPU tensors; a
CUDA tensor goes to the hand-written kernel ``csrc/mlstm_chunkwise.cu``
or raises: bf16 q/k/v at hd 384 (the model's prefill) to the
tensor-core kernel, whose tiles arrive by TMA (a 16-byte-aligned base
and outer strides of a multiple of 16 bytes, checked here), everything
else to the CUDA-core kernel. The kernel reads every input through element strides (last
dim of q, k, v contiguous), so the model passes its projections as
``(B, NH, S, hd)`` views of ``(B, S, NH, hd)``, uncopied; the y it
returns is a ``(B, NH, S, hd)`` view of a ``(B, S, NH, hd)`` buffer, so
the model's head merge after it is free. Any S works: the ragged tail
is masked, where the Pallas kernel asserts ``S % chunk == 0``. The
kernel works in 64-row chunks, the plain version in ``chunk``-row ones
(the reference model's 256 when the wrapper calls it).

The backward (the Pallas kernel has none: the reference differentiates
its jnp mirror) is the hand-written ``csrc/mlstm_chunkwise_bwd.cu``,
joined to the forward kernel by ``MlstmChunkwiseFn`` wherever autograd
needs a gradient of a CUDA call. **The stabiliser m carries no
gradient.** With ``num = e^{-m} num_abs`` and ``den = e^{-m} den_abs``
(the absolute frame's ``num_abs = q C``, ``den_abs = q·n``, which m
does not enter),
``y = num / max(|den|, e^{-m}) = e^{-m} num_abs / (e^{-m}
max(|den_abs|, 1)) = num_abs / max(|den_abs|, 1)``: every ``e^{-m}``
cancels in both branches of the max, so y does not depend on m and
``∂y/∂m = 0`` exactly (the tests detach m and see every gradient
unchanged). The backward recomputes m from logi and logf and treats it
as a constant. With ``d = max(|den|, e^{-m})`` and
``δ_t = Σ_j dy_tj y_tj`` (from the forward's saved y):
``dnum = dy / d``; ``dden = -sign(den) [|den| > e^{-m}] δ / d``, the
branch decided on the same stabilised values the forward used. Then, per
chunk, carrying dC and dn back from the next chunk (r_s =
exp(lf_end - lf_s + logi_s), g_t = exp(lf_t - m_t), E = exp(logD - m)):

- ``dW = dnum vᵀ + dden`` on the lower triangle, ``dS = dW ∘ E``,
  ``M = dW ∘ W``;
- ``dq = dS k + g ∘ (dnum C0ᵀ + dden n0)``,
  ``dk = dSᵀ q + r ∘ (v dCᵀ + dn)``, ``dv = Wᵀ dnum + r ∘ (k dC)``;
- ``dC0 = e^{lf_end} dC + (g ∘ q)ᵀ dnum``,
  ``dn0 = e^{lf_end} dn + (g dden)ᵀ q``;
- ``dlogi = colsum M + r dr``, and ``dlf = rowsum M - colsum M + g dg -
  r dr`` plus, on the chunk's last row, ``Σ r dr + e^{lf_end}(<dC, C0> +
  <dn, n0>)``, reverse-cumsummed into dlogf (``dg = dnum·(q C0) +
  dden (q·n0)``, ``dr = k·(dC v) + k·dn``).

``mlstm_chunkwise_bwd_plain`` is that recurrence in tensor ops (the CPU
tests hold it against ``jax.vjp`` of the reference's oracle). The kernel
computes the same. bf16 at hd 384 (the model's training path) takes the
tensor-core route, chunk-parallel: a state pass forward over the chunks
stores C0 (bf16) and n0 at each chunk's start, a chunk-parallel launch
the chunk-local terms (W, d, dden, dnum = dy / d, dS, M's sums), a state
pass in reverse dC and dn at each chunk's end, and two chunk-parallel
launches dq, dk and then dv with the gates' gradients, every product on
``wgmma`` with one bf16 operand. f32, and bf16 at hd 32 and 64, take the
CUDA-core kernel: one block per (64 value columns, head, batch row),
the dq, dk, dlogi and dlogf parts of the column blocks reduced by a
last launch. Neither uses atomics: repeated runs are bitwise equal.
Each route's scratch is allocated here (``_bwd_scratch``), also on a
``meta`` tensor (the dry-run's, ``kernels/meta.py``), which gets empty
outputs of the kernel's shapes and reports ``mlstm_cost`` /
``mlstm_bwd_cost``'s work, both directions through the same Function.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build, meta
from .flash_attention import _tma_layout_ok
from .mamba2_scan import _chunked, _like

DIMS = (32, 64, 384)    # the head dims the kernel takes
TC_DIM = 384            # bf16 at this head dim runs on the tensor cores
CHUNK = 64              # the kernel's chunk rows
VT = 64                 # value columns a backward block takes (hd 384)


def _gates(i_i, f_i, causal, stop_m):
    """A chunk's lf = cumsum(logf), logD and the stabiliser m (detached
    with ``stop_m``: it carries no gradient, the module docstring)."""
    lf = torch.cumsum(f_i, dim=-1)                             # (B,NH,c)
    seg = lf[..., :, None] - lf[..., None, :]                  # (B,NH,c,c)
    logD = torch.where(causal, seg + i_i[..., None, :],
                       torch.full_like(seg, -1e30))
    m = torch.maximum(torch.amax(logD, dim=-1), lf)            # stabiliser
    return lf, logD, (m.detach() if stop_m else m)


def mlstm_chunkwise_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          logi: torch.Tensor, logf: torch.Tensor, *,
                          chunk: int = 256,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Plain version: the chunked mLSTM in f32, one chunk at a time as
    the reference's ``mlstm_apply`` runs it (S padded to a whole chunk
    with zeros, the padded rows' outputs dropped)."""
    B, NH, S, hd = q.shape
    qc, kc, vc = (_chunked(t, 2, chunk) for t in (q, k, v))
    ic, fc = _chunked(logi, 2, chunk), _chunked(logf, 2, chunk)
    nchunk = qc.shape[2]
    idx = torch.arange(chunk, device=q.device)
    causal = idx[:, None] >= idx[None, :]

    C = torch.zeros((B, NH, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, NH, hd), dtype=torch.float32, device=q.device)
    ys = []
    for c in range(nchunk):
        q_i, k_i, v_i = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        i_i, f_i = ic[:, :, c], fc[:, :, c]
        lf, logD, m = _gates(i_i, f_i, causal, False)
        W = (q_i @ k_i.transpose(-1, -2)) * torch.exp(logD - m[..., None])
        y_intra = W @ v_i
        den_intra = torch.sum(W, dim=-1)
        qw = q_i * torch.exp(lf - m)[..., None]
        num = y_intra + qw @ C
        den = den_intra + (qw @ n[..., None])[..., 0]
        den = torch.maximum(torch.abs(den), torch.exp(-m))
        ys.append(num / den[..., None])
        # carry update
        decay_to_end = torch.exp(lf[..., -1:] - lf + i_i)       # (B,NH,c)
        kd = k_i * decay_to_end[..., None]
        C = torch.exp(lf[..., -1])[..., None, None] * C \
            + kd.transpose(-1, -2) @ v_i
        n = torch.exp(lf[..., -1])[..., None] * n + torch.sum(kd, dim=-2)
    y = torch.stack(ys, dim=2).reshape(B, NH, nchunk * chunk, hd)[:, :, :S]
    return y.to(out_dtype or q.dtype)


def mlstm_chunkwise_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, logi: torch.Tensor,
                              logf: torch.Tensor, dy: torch.Tensor, *,
                              chunk: int = 256):
    """Plain version of the backward kernel: (dq, dk, dv, dlogi, dlogf),
    each in its input's dtype, by the explicit reverse chunked recurrence
    of the module docstring in tensor ops (no autograd; m a constant): a
    forward sweep for the chunk-start C and n, then the chunks in reverse
    with dC and dn carried back. y (for δ) is recomputed in f32."""
    B, NH, S, hd = q.shape
    qc, kc, vc, dyc = (_chunked(t, 2, chunk) for t in (q, k, v, dy))
    ic, fc = _chunked(logi, 2, chunk), _chunked(logf, 2, chunk)
    nchunk = qc.shape[2]
    idx = torch.arange(chunk, device=q.device)
    causal = idx[:, None] >= idx[None, :]

    def chunk_terms(c):
        i_i = ic[:, :, c]
        lf, logD, m = _gates(i_i, fc[:, :, c], causal, True)
        E = torch.exp(logD - m[..., None])
        r = torch.exp(lf[..., -1:] - lf + i_i)                  # (B,NH,c)
        return lf, m, E, r, torch.exp(lf[..., -1])

    C = torch.zeros((B, NH, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, NH, hd), dtype=torch.float32, device=q.device)
    starts = []
    for c in range(nchunk):
        lf, m, E, r, eend = chunk_terms(c)
        starts.append((C, n))
        kd = kc[:, :, c] * r[..., None]
        C = eend[..., None, None] * C + kd.transpose(-1, -2) @ vc[:, :, c]
        n = eend[..., None] * n + torch.sum(kd, dim=-2)

    dC, dn = torch.zeros_like(C), torch.zeros_like(n)
    dqs, dks, dvs, dis, dfs = [], [], [], [], []
    for c in reversed(range(nchunk)):
        lf, m, E, r, eend = chunk_terms(c)
        (C0, n0), dy_i = starts[c], dyc[:, :, c]
        q_i, k_i, v_i = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        W = (q_i @ k_i.transpose(-1, -2)) * E
        g = torch.exp(lf - m)
        qC = q_i @ C0
        qn = (q_i @ n0[..., None])[..., 0]
        den = W.sum(-1) + g * qn
        emin = torch.exp(-m)
        d = torch.maximum(torch.abs(den), emin)
        y = (W @ v_i + g[..., None] * qC) / d[..., None]
        delta = torch.sum(dy_i * y, dim=-1)
        dnum = dy_i / d[..., None]
        dden = torch.where(torch.abs(den) > emin,
                           -torch.sign(den) * delta / d,
                           torch.zeros_like(den))
        dW = (dnum @ v_i.transpose(-1, -2) + dden[..., None]) * causal
        M = dW * W
        dS = dW * E
        kdC = k_i @ dC                                          # (B,NH,c,hd)
        dvs.append(W.transpose(-1, -2) @ dnum + r[..., None] * kdC)
        dqs.append(dS @ k_i + g[..., None] * (dnum @ C0.transpose(-1, -2))
                   + (g * dden)[..., None] * n0[..., None, :])
        dks.append(dS.transpose(-1, -2) @ q_i + r[..., None] * (
            v_i @ dC.transpose(-1, -2) + dn[..., None, :]))
        dg = torch.sum(dnum * qC, dim=-1) + dden * qn
        dr = torch.sum(v_i * kdC, dim=-1) + (k_i @ dn[..., None])[..., 0]
        dlf = M.sum(-1) - M.sum(-2) + g * dg - r * dr
        dlf[..., -1] += (eend * (torch.sum(dC * C0, dim=(-1, -2))
                                 + torch.sum(dn * n0, dim=-1))
                         + torch.sum(r * dr, dim=-1))
        dis.append(M.sum(-2) + r * dr)
        dfs.append(torch.flip(torch.cumsum(torch.flip(dlf, (-1,)), -1),
                              (-1,)))
        dC = eend[..., None, None] * dC + (q_i * g[..., None]).transpose(
            -1, -2) @ dnum
        dn = eend[..., None] * dn + torch.sum(
            q_i * (g * dden)[..., None], dim=-2)

    def merge(parts):
        t = torch.stack(parts[::-1], dim=2).flatten(2, 3)
        return t.narrow(2, 0, S)

    return (merge(dqs).to(q.dtype), merge(dks).to(k.dtype),
            merge(dvs).to(v.dtype), merge(dis).to(logi.dtype),
            merge(dfs).to(logf.dtype))


def mlstm_cost(B: int, NH: int, S: int, hd: int, in_bytes: int = 2,
               out_bytes: int = 4):
    """(bytes, flops) the chunkwise mLSTM needs: q, k, v read once, logi
    and logf read once, y written once; per ``CHUNK``-row chunk the
    causal half of q kᵀ and of W v, q C, the state update of C, q n and
    n."""
    nbytes = B * NH * S * (3 * hd * in_bytes + 2 * 4 + hd * out_bytes)
    flops = 0
    for s0 in range(0, S, CHUNK):
        c = min(CHUNK, S - s0)
        tri = c * (c + 1) // 2
        flops += 2 * tri * hd * 2 + 2 * c * hd * hd * 2 + 2 * c * hd * 2
    return nbytes, B * NH * flops


def mlstm_bwd_cost(B: int, NH: int, S: int, hd: int, in_bytes: int = 2,
                   out_bytes: int = 4):
    """(bytes, flops) the backward needs: q, k, v, logi, logf, y and dy
    read once, the five gradients written once; per ``CHUNK``-row chunk
    the forward sweep's state update, then q kᵀ, q C0 and dnum vᵀ, Wᵀ
    dnum and k dC, dS k and dnum C0ᵀ, dSᵀ q and v dCᵀ, and the dC update
    (the causal products at half)."""
    nbytes = B * NH * S * (2 * 3 * hd * in_bytes + 2 * 2 * 4
                           + 2 * hd * out_bytes)
    flops = 0
    for s0 in range(0, S, CHUNK):
        c = min(CHUNK, S - s0)
        tri = c * (c + 1) // 2
        flops += 2 * tri * hd * 5 + 2 * c * hd * hd * 6
    return nbytes, B * NH * flops


def _check(name, q, k, v, logi, logf, out_dtype):
    ts = (q, k, v, logi, logf)
    B, NH, S, hd = q.shape
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: tensors on "
                         f"{', '.join(str(t.device) for t in ts)}")
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or k.dtype != q.dtype or v.dtype != q.dtype
            or logi.dtype != torch.float32 or logf.dtype != torch.float32
            or out_dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"{name}: dtypes "
                        f"{', '.join(str(t.dtype) for t in ts)} -> "
                        f"{out_dtype}; want q, k, v float32 or bfloat16, "
                        f"logi, logf float32")
    if (k.shape != q.shape or v.shape != q.shape
            or logi.shape != (B, NH, S) or logf.shape != (B, NH, S)
            or hd not in DIMS or min(B, NH, S) < 1):
        raise ValueError(f"{name}: shapes "
                         f"{', '.join(str(tuple(t.shape)) for t in ts)}; "
                         f"head dim must be one of {DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the last dim of q, k and v must "
                         "be contiguous")


_fns = {}
_bwd_fns = {}


def _kernel(in_dtype: torch.dtype, out_dtype: torch.dtype):
    if not _fns:
        lib = build.load("mlstm_chunkwise")
        names = {torch.float32: "f32", torch.bfloat16: "bf16"}
        for ti, si in names.items():
            for to, so in names.items():
                fn = getattr(lib, f"mlstm_chunkwise_{si}_{so}")
                # q, k, v, logi, logf, y, B, NH, S, hd, strides, stream
                fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p, ctypes.c_void_p])
                fn.restype = ctypes.c_int
                _fns[(ti, to)] = fn
    return _fns[(in_dtype, out_dtype)]


def _bwd_kernel(route: str):
    """The backward's entry point: "tc" (bf16 at hd 384), "f32" or
    "bf16" (the CUDA-core kernel)."""
    if not _bwd_fns:
        lib = build.load("mlstm_chunkwise_bwd")
        for r in ("f32", "bf16"):
            fn = getattr(lib, f"mlstm_chunkwise_bwd_{r}")
            # q, k, v, logi, logf, y, dy, delta, cbuf, nbuf, dqp, dkp,
            # dip, dfp, dq, dk, dv, dlogi, dlogf, B, NH, S, hd, strides,
            # stream
            fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _bwd_fns[r] = fn
        fn = lib.mlstm_chunkwise_bwd_tc
        # q, k, v, logi, logf, y, dy, c0, dc, n0, dn, dnum, tiles, rv, cv,
        # dq, dk, dv, dlogi, dlogf, B, NH, S, hd, strides, stream
        fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fns["tc"] = fn
    return _bwd_fns[route]


def _bwd_scratch(route: str, B: int, NH: int, S: int, hd: int, device):
    """The backward kernel's scratch, by route (the meta path allocates
    the same, so the dry-run's peak follows the kernel). Tensor cores:
    C0 and dC at each chunk's start and end (bf16, rows key dims), n0 and
    dn (f32), dnum = dy / d (bf16), each chunk's dS, dSᵀ and Wᵀ tiles
    (bf16), six f32 vectors a row and two a chunk. CUDA cores: δ, C and
    n at each chunk start, the column blocks' parts of dq, dk, dlogi and
    dlogf (f32)."""
    nch = math.ceil(S / CHUNK)
    f32 = dict(dtype=torch.float32, device=device)
    if route == "tc":
        b16 = dict(dtype=torch.bfloat16, device=device)
        return (torch.empty((B, NH, nch, hd, hd), **b16),
                torch.empty((B, NH, nch, hd, hd), **b16),
                torch.empty((B, NH, nch, hd), **f32),
                torch.empty((B, NH, nch, hd), **f32),
                torch.empty((B, NH, S, hd), **b16),
                torch.empty((B, NH, nch, 3, CHUNK, CHUNK), **b16),
                torch.empty((B, NH, S, 6), **f32),
                torch.empty((B, NH, nch, 2), **f32))
    ncb = max(1, hd // VT)
    return (torch.empty((B, NH, S), **f32),
            torch.empty((B, NH, nch, hd, hd), **f32),
            torch.empty((B, NH, ncb, nch, hd), **f32),
            torch.empty((B, NH, ncb, S, hd), **f32),
            torch.empty((B, NH, ncb, S, hd), **f32),
            torch.empty((B, NH, ncb, S), **f32),
            torch.empty((B, NH, ncb, S), **f32))


def _forward(q, k, v, logi, logf, out_dtype):
    """Launch the forward kernel (on ``meta`` tensors: the empty y and
    the kernel's work recorded)."""
    B, NH, S, hd = q.shape
    if q.device.type != "meta":
        _check("mlstm_chunkwise", q, k, v, logi, logf, out_dtype)
        if q.dtype == torch.bfloat16 and hd == TC_DIM:
            for t in (q, k, v):
                if not _tma_layout_ok(t.shape, t.stride(), t.data_ptr(),
                                      t.element_size()):
                    raise ValueError(
                        "mlstm_chunkwise: the bf16 kernel reads q, k and v "
                        "through TMA, which needs a 16-byte-aligned base "
                        "and every outer stride a multiple of 16 bytes; got "
                        f"strides {t.stride()} at address "
                        f"{t.data_ptr():#x}")
    y = torch.empty((B, S, NH, hd), dtype=out_dtype,
                    device=q.device).transpose(1, 2)
    if meta.counting():
        nb, flops = mlstm_cost(B, NH, S, hd, q.element_size(),
                               y.element_size())
        meta.record("mlstm_chunkwise", flops, nb)
    if q.device.type == "meta":
        return y
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *logi.stride(),
        *logf.stride(), *y.stride()[:3])
    fn = _kernel(q.dtype, out_dtype)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), logi.data_ptr(),
                logf.data_ptr(), y.data_ptr(), B, NH, S, hd,
                ctypes.addressof(strides),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlstm_chunkwise kernel launch failed: "
                           f"CUDA error {rc}")
    mlstm_chunkwise.launches += 1
    return y


def mlstm_chunkwise_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        logi: torch.Tensor, logf: torch.Tensor,
                        y: Optional[torch.Tensor], dy: torch.Tensor):
    """Gradient of ``mlstm_chunkwise`` given the forward's y and dy
    (B,NH,S,hd): (dq, dk, dv, dlogi, dlogf), each in its input's dtype
    and layout. CPU tensors take ``mlstm_chunkwise_bwd_plain`` (y unused);
    CUDA tensors launch the Hopper kernel."""
    if q.device.type == "cpu":
        return mlstm_chunkwise_bwd_plain(q, k, v, logi, logf, dy)
    B, NH, S, hd = q.shape
    if q.device.type != "meta":
        _check("mlstm_chunkwise_bwd", q, k, v, logi, logf, torch.float32)
        for name, t in (("y", y), ("dy", dy)):
            if t is None or t.shape != q.shape or t.device != q.device:
                raise ValueError(f"mlstm_chunkwise_bwd: {name} must be "
                                 f"{tuple(q.shape)} on {q.device}")
    route = ("tc" if q.dtype == torch.bfloat16 and hd == TC_DIM
             else "f32" if q.dtype == torch.float32 else "bf16")
    grads = _bwd(q, k, v, logi, logf, y, dy, route)
    if q.device.type != "meta":
        mlstm_chunkwise_bwd.launches += 1
    return grads


def _bwd(q, k, v, logi, logf, y, dy, route):
    """Launch the backward by ``route`` (``_bwd_kernel``'s; the tools'
    A/B also sends bf16 at hd 384 to the CUDA-core kernel this way)."""
    B, NH, S, hd = q.shape
    y, dy = ((t if t.dtype == torch.float32 and t.stride(-1) == 1
              else t.float().contiguous()) for t in (y, dy))
    if route == "tc" and any(st % 2 for st in dy.stride()):
        dy = dy.contiguous()      # read two floats at a time
    grads = tuple(_like(t) for t in (q, k, v, logi, logf))
    if route == "tc" and q.device.type != "meta":
        for t in (q, k, v):
            if not _tma_layout_ok(t.shape, t.stride(), t.data_ptr(),
                                  t.element_size()):
                raise ValueError(
                    "mlstm_chunkwise_bwd: the bf16 kernel copies q, k and v "
                    "in 16-byte pieces, which needs a 16-byte-aligned base "
                    "and every outer stride a multiple of 16 bytes; got "
                    f"strides {t.stride()} at address {t.data_ptr():#x}")
    scratch = _bwd_scratch(route, B, NH, S, hd, q.device)
    if meta.counting():
        nb, flops = mlstm_bwd_cost(B, NH, S, hd, q.element_size(), 4)
        meta.record("mlstm_chunkwise_bwd", flops, nb)
    if q.device.type == "meta":
        return grads
    dq, dk, dv, dli, dlf = grads
    strides = (ctypes.c_longlong * 36)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *logi.stride(),
        *logf.stride(), *y.stride()[:3], *dy.stride()[:3], *dq.stride()[:3],
        *dk.stride()[:3], *dv.stride()[:3], *dli.stride(), *dlf.stride())
    fn = _bwd_kernel(route)
    ptrs = [t.data_ptr() for t in (q, k, v, logi, logf, y, dy, *scratch,
                                   dq, dk, dv, dli, dlf)]
    with torch.cuda.device(q.device):
        rc = fn(*ptrs, B, NH, S, hd, ctypes.addressof(strides),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlstm_chunkwise_bwd kernel launch failed: "
                           f"CUDA error {rc}")
    return grads


mlstm_chunkwise_bwd.launches = 0


class MlstmChunkwiseFn(torch.autograd.Function):
    """The forward kernel (its y saved for δ) and the backward kernel,
    joined for autograd. CUDA (and ``meta``) tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, logi, logf, out_dtype):
        y = _forward(q, k, v, logi, logf, out_dtype)
        ctx.save_for_backward(q, k, v, logi, logf, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        return (*mlstm_chunkwise_bwd(*ctx.saved_tensors, dy), None)


def _call(q, k, v, logi, logf, out_dtype):
    ts = (q, k, v, logi, logf)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return MlstmChunkwiseFn.apply(q, k, v, logi, logf, out_dtype)
    return _forward(q, k, v, logi, logf, out_dtype)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logi: torch.Tensor, logf: torch.Tensor, *,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """q/k/v: (B,NH,S,hd); logi/logf: (B,NH,S) -> y (B,NH,S,hd) in
    ``out_dtype`` (q's dtype by default). CPU tensors take
    ``mlstm_chunkwise_plain``; CUDA tensors launch the Hopper kernel,
    through ``MlstmChunkwiseFn`` where autograd needs their gradient.
    DTensors (the dry-run's meta shards, or CPU shards) run it per
    rank."""
    out_dtype = out_dtype or q.dtype
    pl = meta.placements(q, {0: q.shape[0], 1: q.shape[1]})
    if pl is not None:
        return meta.run(lambda *t: mlstm_chunkwise(*t, out_dtype=out_dtype),
                        (q, k, v, logi, logf), (pl,) * 5, pl)
    if q.device.type == "cpu":
        return mlstm_chunkwise_plain(q, k, v, logi, logf,
                                     out_dtype=out_dtype)
    return _call(q, k, v, logi, logf, out_dtype)


mlstm_chunkwise.launches = 0
