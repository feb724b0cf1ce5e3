"""Mamba2 chunked SSD scan on Hopper, beside its plain PyTorch version.

Port of ``repro/kernels/mamba2_scan.py`` (the Pallas TPU kernel). The
layout is the JAX kernel's: x ``(B, NH, S, P)``, Bmat/Cmat ``(B, S, N)``
(shared by the heads of a batch row), a/dt ``(B, NH, S)``; y is like x,
in ``out_dtype`` (x's dtype by default). It computes the recurrence
``h_t = a_t h_{t-1} + dt_t x_t B_tᵀ``, ``y_t = C_t h_t`` in the chunked
form, with the ``log(a + 1e-20)`` epsilon and the -1e30 mask of the
reference.

``mamba2_scan`` takes the plain version only for CPU tensors; a CUDA
tensor goes to the hand-written kernel ``csrc/mamba2_scan.cu`` or
raises. bf16 inputs (the model's prefill) run the tensor-core kernel:
``wgmma`` products with f32 accumulators, W, the scaled x and the copy
of h fed as hi/lo bf16 pairs (about 16 bits), h carried in f32, the
next chunks' tiles loading while a chunk computes; f32 inputs run the
CUDA-core kernel, which the f32 checks hold to 1e-3. The kernel reads
every input through element strides (last dim of x, Bmat and Cmat
contiguous), so the model passes its causal conv's output as views,
uncopied; the y it returns is a ``(B, NH, S, P)`` view
of a ``(B, S, NH, P)`` buffer, so the model's head merge after it is
free. Any S works: the ragged tail is masked, where the Pallas kernel
asserts ``S % chunk == 0``. The kernel always works in 64-row chunks;
``chunk`` is the plain version's, and changes only rounding.

The backward (the Pallas kernel has none: the reference differentiates
its jnp mirror) is the hand-written ``csrc/mamba2_scan_bwd.cu``, joined
to the forward kernel by ``Mamba2ScanFn`` wherever autograd needs a
gradient of a CUDA call. It runs the chunked recurrence in reverse:
within a chunk (la = cumsum log(a + 1e-20), L = exp(la_t - la_s) on the
lower triangle, W = (C Bᵀ) ∘ L, xdt = x dt) the forward is
``y = W xdt + (C ∘ e^la) h0ᵀ`` and
``h1 = e^{la_end} h0 + (xdt ∘ e^{la_end - la})ᵀ B``; given dy and the
dh1 carried back from the next chunk,

- ``dh0 = e^{la_end} dh1 + (dy ∘ e^la)ᵀ C``;
- ``dxdt = Wᵀ dy + e^{la_end - la} ∘ (B dh1ᵀ)``, so
  ``dx = dxdt dt`` and ``ddt = Σ_p dxdt x``;
- with ``dW = (dy xdtᵀ)`` on the lower triangle and ``dG = dW ∘ L``:
  ``dC = dG B + e^la ∘ (dy h0)`` and
  ``dB = dGᵀ C + e^{la_end - la} ∘ (xdt dh1)``, each summed over the
  heads (Bmat and Cmat are shared by them);
- ``dla`` from L (rowsum minus colsum of ``dW ∘ W``), from ``e^la``
  (``Σ_n C dC_state``) and from the decay to the chunk's end (each row
  loses ``Q_s = Σ_n B_s dB_state_s``, the end row gains ``ΣQ`` and
  ``e^{la_end} <dh1, h0>``); reverse-cumsummed into ``d log(a + 1e-20)``
  and divided by ``a + 1e-20`` (not clamped: the reference has the same
  term).

``mamba2_scan_bwd_plain`` is that recurrence in tensor ops (the CPU
tests hold it against ``jax.vjp`` of the reference's oracle). The kernel
computes the same. bf16 at P = N = 64 (the model's training path) takes
the tensor-core route: one launch carries h forward and dh in reverse
over the chunks (bf16 at each chunk boundary), a chunk-parallel launch
computes every other term for a group of ``TC_GROUP`` heads, summing dB
and dC over the group on chip, and a last launch sums the groups; every
product on ``wgmma`` with one bf16 operand. f32, and bf16 at the other
P, N, take the CUDA-core kernel: one block per (head, batch row), each
head's dB and dC summed by a second launch. Neither uses atomics:
repeated runs are bitwise equal. Each route's scratch is allocated here
(``_bwd_scratch``), also on a ``meta`` tensor (the dry-run's,
``kernels/meta.py``), which gets empty outputs of the kernel's shapes
and reports ``scan_flops`` / ``scan_bwd_flops``' work, both directions
through the same Function.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build, meta
from .flash_attention import _tma_layout_ok

DIMS = (16, 32, 64)     # the head dims P and state dims N the kernel takes
CHUNK = 64              # the kernel's chunk rows


def _chunked(t: torch.Tensor, dim: int, chunk: int, fill: float = 0.0):
    """``t`` in f32, padded along ``dim`` to whole ``chunk``-row chunks
    with ``fill``, that dim split into (chunks, chunk)."""
    t = t.float()
    S = t.shape[dim]
    nchunk = max(1, math.ceil(S / chunk))
    pad = nchunk * chunk - S
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        t = torch.cat([t, t.new_full(shape, fill)], dim=dim)
    return t.unflatten(dim, (nchunk, chunk))


def mamba2_scan_plain(x: torch.Tensor, Bmat: torch.Tensor,
                      Cmat: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
                      *, chunk: int = 256,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Plain version: the chunked SSD in f32, one chunk at a time as the
    reference's ``ssm_apply`` runs it (S padded to a whole chunk with
    zeros, the padded rows' outputs dropped)."""
    B, NH, S, P = x.shape
    xc = _chunked(x, 2, chunk)
    nchunk = xc.shape[2]
    Bc, Cc = _chunked(Bmat, 1, chunk), _chunked(Cmat, 1, chunk)
    ac, dtc = _chunked(a, 2, chunk), _chunked(dt, 2, chunk)
    idx = torch.arange(chunk, device=x.device)
    causal = idx[:, None] >= idx[None, :]

    h = torch.zeros((B, NH, P, Bmat.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c in range(nchunk):
        x_i, B_i, C_i = xc[:, :, c], Bc[:, c, None], Cc[:, c, None]
        a_i, dt_i = ac[:, :, c], dtc[:, :, c]
        la = torch.cumsum(torch.log(a_i + 1e-20), dim=-1)     # (B,NH,c)
        seg = la[..., :, None] - la[..., None, :]              # (B,NH,c,c)
        # mask in log space BEFORE exp (0 * inf => NaN grads otherwise)
        seg = torch.where(causal, seg, torch.full_like(seg, -1e30))
        W = (C_i @ B_i.transpose(-1, -2)) * torch.exp(seg)
        xdt = x_i * dt_i[..., None]
        y_intra = W @ xdt
        y_inter = (C_i * torch.exp(la)[..., None]) @ h.transpose(-1, -2)
        decay_to_end = torch.exp(la[..., -1:] - la)            # (B,NH,c)
        S_c = (xdt * decay_to_end[..., None]).transpose(-1, -2) @ B_i
        h = torch.exp(la[..., -1])[..., None, None] * h + S_c
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=2).reshape(B, NH, nchunk * chunk, P)[:, :, :S]
    return y.to(out_dtype or x.dtype)


def mamba2_scan_bwd_plain(x: torch.Tensor, Bmat: torch.Tensor,
                          Cmat: torch.Tensor, a: torch.Tensor,
                          dt: torch.Tensor, dy: torch.Tensor, *,
                          chunk: int = 256):
    """Plain version of the backward kernel: (dx, dB, dC, da, ddt), each
    in its input's dtype, by the explicit reverse chunked recurrence of
    the module docstring in tensor ops (no autograd): a forward sweep for
    the chunk-start states, then the chunks in reverse with dh carried
    back. Rows past S are zeros (a padded with ones, log a = 0), as the
    kernel stages them."""
    B, NH, S, P = x.shape
    N = Bmat.shape[-1]
    xc, dyc = _chunked(x, 2, chunk), _chunked(dy, 2, chunk)
    nchunk = xc.shape[2]
    Bc, Cc = _chunked(Bmat, 1, chunk), _chunked(Cmat, 1, chunk)
    ac, dtc = _chunked(a, 2, chunk, 1.0), _chunked(dt, 2, chunk)
    idx = torch.arange(chunk, device=x.device)
    causal = idx[:, None] >= idx[None, :]

    def chunk_terms(c):
        la = torch.cumsum(torch.log(ac[:, :, c] + 1e-20), dim=-1)
        seg = la[..., :, None] - la[..., None, :]
        L = torch.exp(torch.where(causal, seg, torch.full_like(seg, -1e30)))
        xdt = xc[:, :, c] * dtc[:, :, c, :, None]
        dec = torch.exp(la[..., -1:] - la)
        return la, L, xdt, dec, torch.exp(la[..., -1])

    h = torch.zeros((B, NH, P, N), dtype=torch.float32, device=x.device)
    starts = []
    for c in range(nchunk):
        la, L, xdt, dec, eend = chunk_terms(c)
        starts.append(h)
        h = eend[..., None, None] * h + (xdt * dec[..., None]).transpose(
            -1, -2) @ Bc[:, c, None]

    dh = torch.zeros_like(h)
    dxs, dBs, dCs, das, ddts = [], [], [], [], []
    for c in reversed(range(nchunk)):
        la, L, xdt, dec, eend = chunk_terms(c)
        h0, dy_i = starts[c], dyc[:, :, c]
        B_i, C_i = Bc[:, c, None], Cc[:, c, None]              # (B,1,c,N)
        ela = torch.exp(la)
        W = (C_i @ B_i.transpose(-1, -2)) * L
        dW = (dy_i @ xdt.transpose(-1, -2)) * causal
        dG = dW * L
        M = dW * W
        dxdt = W.transpose(-1, -2) @ dy_i + dec[..., None] * (
            B_i @ dh.transpose(-1, -2))
        dC_state = ela[..., None] * (dy_i @ h0)                # (B,NH,c,N)
        dB_state = dec[..., None] * (xdt @ dh)
        dCs.append(dG @ B_i + dC_state)
        dBs.append(dG.transpose(-1, -2) @ C_i + dB_state)
        Q = torch.sum(B_i * dB_state, dim=-1)                  # (B,NH,c)
        dla = (M.sum(-1) - M.sum(-2) + torch.sum(C_i * dC_state, dim=-1)
               - Q)
        dla[..., -1] += eend * torch.sum(dh * h0, dim=(-1, -2)) + Q.sum(-1)
        dl = torch.flip(torch.cumsum(torch.flip(dla, (-1,)), -1), (-1,))
        das.append(dl / (ac[:, :, c] + 1e-20))
        ddts.append(torch.sum(dxdt * xc[:, :, c], dim=-1))
        dxs.append(dxdt * dtc[:, :, c, :, None])
        dh = eend[..., None, None] * dh + (dy_i * ela[..., None]).transpose(
            -1, -2) @ C_i

    def merge(parts, dim):
        t = torch.stack(parts[::-1], dim=dim).flatten(dim, dim + 1)
        return t.narrow(dim, 0, S)

    dB = merge([t.sum(1) for t in dBs], 1)
    dC = merge([t.sum(1) for t in dCs], 1)
    return (merge(dxs, 2).to(x.dtype), dB.to(Bmat.dtype),
            dC.to(Cmat.dtype), merge(das, 2).to(a.dtype),
            merge(ddts, 2).to(dt.dtype))


def scan_flops(B: int, NH: int, S: int, P: int, N: int,
               chunk: int = 256) -> int:
    """The reference's ``chunk``-row chunks: C Bᵀ, its mask, W (x dt),
    the incoming state's term and the state update."""
    c = chunk
    per_chunk = 2 * c * c * N + c * c + 2 * c * c * P + 4 * c * N * P
    return B * NH * math.ceil(S / c) * per_chunk


def scan_bwd_flops(B: int, NH: int, S: int, P: int, N: int) -> int:
    """The backward kernel's products at its ``CHUNK``-row chunks: the
    forward sweep's state update; then C Bᵀ and dy xdtᵀ, Wᵀ dy, dG B,
    dGᵀ C (each 2 c² of N or P), and B dh1ᵀ, dy h0, xdt dh1 and the dh
    update (each 2 c N P)."""
    c = CHUNK
    per_chunk = 2 * c * N * P + 2 * c * c * (N + P) + 2 * c * c * (P + 2 * N) \
        + 4 * 2 * c * N * P
    return B * NH * math.ceil(S / c) * per_chunk


def _like(t: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """An empty tensor of ``t``'s shape whose dims lie in memory in the
    order of ``t``'s strides (a gradient in its input's layout, also
    where ``t`` is a slice of a wider buffer)."""
    order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    out = torch.empty([t.shape[d] for d in order], dtype=dtype or t.dtype,
                      device=t.device)
    return out.permute([order.index(d) for d in range(t.dim())])


def _check(name, x, Bmat, Cmat, a, dt, out_dtype):
    ts = (x, Bmat, Cmat, a, dt)
    B, NH, S, P = x.shape
    N = Bmat.shape[-1]
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"{name}: tensors on "
                         f"{', '.join(str(t.device) for t in ts)}")
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or Bmat.dtype != x.dtype or Cmat.dtype != x.dtype
            or a.dtype != torch.float32 or dt.dtype != torch.float32
            or out_dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"{name}: dtypes "
                        f"{', '.join(str(t.dtype) for t in ts)} -> "
                        f"{out_dtype}; want x, B, C float32 or bfloat16, "
                        f"a, dt float32")
    if (Bmat.shape != (B, S, N) or Cmat.shape != (B, S, N)
            or a.shape != (B, NH, S) or dt.shape != (B, NH, S)
            or P not in DIMS or N not in DIMS or min(B, NH, S) < 1):
        raise ValueError(f"{name}: shapes "
                         f"{', '.join(str(tuple(t.shape)) for t in ts)}")
    if any(t.stride(-1) != 1 for t in (x, Bmat, Cmat)):
        raise ValueError(f"{name}: the last dim of x, Bmat and Cmat "
                         "must be contiguous")


_fns = {}
_bwd_fns = {}


def _kernel(in_dtype: torch.dtype, out_dtype: torch.dtype):
    if not _fns:
        lib = build.load("mamba2_scan")
        names = {torch.float32: "f32", torch.bfloat16: "bf16"}
        for ti, si in names.items():
            for to, so in names.items():
                fn = getattr(lib, f"mamba2_scan_{si}_{so}")
                # x, Bm, Cm, a, dt, y, B, NH, S, P, N, strides, stream
                fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                               + [ctypes.c_void_p, ctypes.c_void_p])
                fn.restype = ctypes.c_int
                _fns[(ti, to)] = fn
    return _fns[(in_dtype, out_dtype)]


def _bwd_kernel(route: str):
    """The backward's entry point: "tc" (bf16 at P = N = 64), "f32" or
    "bf16" (the CUDA-core kernel)."""
    if not _bwd_fns:
        lib = build.load("mamba2_scan_bwd")
        for r in ("f32", "bf16"):
            fn = getattr(lib, f"mamba2_scan_bwd_{r}")
            # x, Bm, Cm, a, dt, dy, hbuf, dbp, dcp, dx, dBm, dCm, da,
            # ddt, B, NH, S, P, N, strides, stream
            fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _bwd_fns[r] = fn
        fn = lib.mamba2_scan_bwd_tc
        # x, Bm, Cm, a, dt, dy, hbuf, dhbuf, dbp, dcp, dx, dBm, dCm, da,
        # ddt, B, NH, S, P, N, strides, stream
        fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fns["tc"] = fn
    return _bwd_fns[route]


TC_GROUP = 4            # heads a block of the tensor-core backward sums


def _bwd_scratch(route: str, B: int, NH: int, S: int, P: int, N: int,
                 device):
    """The backward kernel's scratch, by route (the meta path allocates
    the same, so the dry-run's peak follows the kernel). Tensor cores: h
    at each chunk's start and dh at its end (bf16), dB and dC summed over
    each group of ``TC_GROUP`` heads (f32). CUDA cores: h at each chunk
    start, each head's dB and dC (f32)."""
    nch = math.ceil(S / CHUNK)
    f32 = dict(dtype=torch.float32, device=device)
    if route == "tc":
        ng = math.ceil(NH / TC_GROUP)
        b16 = dict(dtype=torch.bfloat16, device=device)
        return (torch.empty((B, NH, nch, P, N), **b16),
                torch.empty((B, NH, nch, P, N), **b16),
                torch.empty((B, ng, S, N), **f32),
                torch.empty((B, ng, S, N), **f32))
    return (torch.empty((B, NH, nch, P, N), **f32),
            torch.empty((B, NH, S, N), **f32),
            torch.empty((B, NH, S, N), **f32))


def _forward(x, Bmat, Cmat, a, dt, chunk, out_dtype):
    """Launch the forward kernel (on ``meta`` tensors: the empty y and
    the kernel's work recorded)."""
    B, NH, S, P = x.shape
    N = Bmat.shape[-1]
    if x.device.type != "meta":
        _check("mamba2_scan", x, Bmat, Cmat, a, dt, out_dtype)
    y = torch.empty((B, S, NH, P), dtype=out_dtype,
                    device=x.device).transpose(1, 2)
    if meta.counting():
        meta.record("mamba2_scan", scan_flops(B, NH, S, P, N, chunk),
                    meta.nbytes(x, Bmat, Cmat, a, dt, y))
    if x.device.type == "meta":
        return y
    strides = (ctypes.c_longlong * 16)(
        *x.stride()[:3], *Bmat.stride()[:2], *Cmat.stride()[:2],
        *a.stride(), *dt.stride(), *y.stride()[:3])
    fn = _kernel(x.dtype, out_dtype)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
                a.data_ptr(), dt.data_ptr(), y.data_ptr(), B, NH, S, P, N,
                ctypes.addressof(strides),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba2_scan kernel launch failed: "
                           f"CUDA error {rc}")
    mamba2_scan.launches += 1
    return y


def mamba2_scan_bwd(x: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor,
                    a: torch.Tensor, dt: torch.Tensor, dy: torch.Tensor, *,
                    chunk: int = 256):
    """Gradient of ``mamba2_scan`` given dy (B,NH,S,P): (dx, dB, dC, da,
    ddt), each in its input's dtype and layout. CPU tensors take
    ``mamba2_scan_bwd_plain``; CUDA tensors launch the Hopper kernel."""
    if x.device.type == "cpu":
        return mamba2_scan_bwd_plain(x, Bmat, Cmat, a, dt, dy, chunk=chunk)
    B, NH, S, P = x.shape
    N = Bmat.shape[-1]
    if x.device.type != "meta":
        _check("mamba2_scan_bwd", x, Bmat, Cmat, a, dt, torch.float32)
        if dy.shape != x.shape or dy.device != x.device:
            raise ValueError(f"mamba2_scan_bwd: dy {tuple(dy.shape)} on "
                             f"{dy.device}, want {tuple(x.shape)}")
    route = ("tc" if x.dtype == torch.bfloat16 and P == N == 64
             else "f32" if x.dtype == torch.float32 else "bf16")
    grads = _bwd(x, Bmat, Cmat, a, dt, dy, route)
    if x.device.type != "meta":
        mamba2_scan_bwd.launches += 1
    return grads


def _bwd(x, Bmat, Cmat, a, dt, dy, route):
    """Launch the backward by ``route`` (``_bwd_kernel``'s; the tools'
    A/B also sends bf16 at P = N = 64 to the CUDA-core kernel this way)."""
    B, NH, S, P = x.shape
    N = Bmat.shape[-1]
    if dy.dtype != torch.float32 or dy.stride(-1) != 1 or (
            route == "tc" and x.device.type != "meta"
            and (any(st % 4 for st in dy.stride()) or dy.data_ptr() % 16)):
        dy = dy.float().contiguous()    # the tc route reads 16-byte pieces
    if route == "tc" and x.device.type != "meta":
        for t in (x, Bmat, Cmat):
            if not _tma_layout_ok(t.shape, t.stride(), t.data_ptr(),
                                  t.element_size()):
                raise ValueError(
                    "mamba2_scan_bwd: the bf16 kernel copies x, Bmat and Cmat "
                    "in 16-byte pieces, which needs a 16-byte-aligned base "
                    "and every outer stride a multiple of 16 bytes; got "
                    f"strides {t.stride()} at address {t.data_ptr():#x}")
    grads = tuple(_like(t) for t in (x, Bmat, Cmat, a, dt))
    scratch = _bwd_scratch(route, B, NH, S, P, N, x.device)
    if meta.counting():
        meta.record("mamba2_scan_bwd", scan_bwd_flops(B, NH, S, P, N),
                    meta.nbytes(x, Bmat, Cmat, a, dt, dy, *grads))
    if x.device.type == "meta":
        return grads
    dx, dB, dC, da, ddt = grads
    strides = (ctypes.c_longlong * 29)(
        *x.stride()[:3], *Bmat.stride()[:2], *Cmat.stride()[:2],
        *a.stride(), *dt.stride(), *dy.stride()[:3], *dx.stride()[:3],
        *dB.stride()[:2], *dC.stride()[:2], *da.stride(), *ddt.stride())
    fn = _bwd_kernel(route)
    ptrs = [t.data_ptr() for t in (x, Bmat, Cmat, a, dt, dy, *scratch, dx,
                                   dB, dC, da, ddt)]
    with torch.cuda.device(x.device):
        rc = fn(*ptrs, B, NH, S, P, N, ctypes.addressof(strides),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba2_scan_bwd kernel launch failed: "
                           f"CUDA error {rc}")
    return grads


mamba2_scan_bwd.launches = 0


class Mamba2ScanFn(torch.autograd.Function):
    """The forward kernel and the backward kernel, joined for autograd.
    CUDA (and ``meta``) tensors only."""

    @staticmethod
    def forward(ctx, x, Bmat, Cmat, a, dt, chunk, out_dtype):
        ctx.save_for_backward(x, Bmat, Cmat, a, dt)
        ctx.chunk = chunk
        return _forward(x, Bmat, Cmat, a, dt, chunk, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        grads = mamba2_scan_bwd(*ctx.saved_tensors, dy, chunk=ctx.chunk)
        return (*grads, None, None)


def _call(x, Bmat, Cmat, a, dt, chunk, out_dtype):
    ts = (x, Bmat, Cmat, a, dt)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return Mamba2ScanFn.apply(x, Bmat, Cmat, a, dt, chunk, out_dtype)
    return _forward(x, Bmat, Cmat, a, dt, chunk, out_dtype)


def mamba2_scan(x: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor,
                a: torch.Tensor, dt: torch.Tensor, *, chunk: int = 256,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (B,NH,S,P); Bmat/Cmat: (B,S,N); a/dt: (B,NH,S) -> y (B,NH,S,P)
    in ``out_dtype`` (x's dtype by default). CPU tensors take
    ``mamba2_scan_plain``; CUDA tensors launch the Hopper kernel, through
    ``Mamba2ScanFn`` where autograd needs their gradient."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return mamba2_scan_plain(x, Bmat, Cmat, a, dt, chunk=chunk,
                                 out_dtype=out_dtype)
    ts = (x, Bmat, Cmat, a, dt)
    if x.device.type == "meta":
        B, NH = x.shape[:2]
        pl = meta.placements(x, {0: B, 1: NH})
        bc = meta.restrict(pl, (0,))          # B and C have no head dim
        # B and C are shared by the heads: their gradient from a head
        # shard is partial over the mesh dims that shard the heads
        gbc = None if pl is None else meta.partial_over(pl, keep=(0,))
        return meta.run(lambda *t: _call(*t, chunk, out_dtype), ts,
                        (pl, bc, bc, pl, pl), pl,
                        in_grad_placements=(pl, gbc, gbc, pl, pl))
    return _call(x, Bmat, Cmat, a, dt, chunk, out_dtype)


mamba2_scan.launches = 0
