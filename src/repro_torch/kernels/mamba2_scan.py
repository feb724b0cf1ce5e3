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

The kernel is forward-only, as the Pallas kernel is: a CUDA call that
autograd would have to differentiate raises. A ``meta`` tensor (the
dry-run's, ``kernels/meta.py``) gets an empty y, and raises where a
CUDA tensor would; either reports ``scan_flops``' work. The plain
version stays
differentiable by autograd (the CPU tests hold its gradient against
``jax.grad`` of the reference).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build, meta

DIMS = (16, 32, 64)     # the head dims P and state dims N the kernel takes
BACKWARD_ITEM = "ROADMAP B.6 (the SSD scan's backward, hybrid training)"


def mamba2_scan_plain(x: torch.Tensor, Bmat: torch.Tensor,
                      Cmat: torch.Tensor, a: torch.Tensor, dt: torch.Tensor,
                      *, chunk: int = 256,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Plain version: the chunked SSD in f32, one chunk at a time as the
    reference's ``ssm_apply`` runs it (S padded to a whole chunk with
    zeros, the padded rows' outputs dropped)."""
    B, NH, S, P = x.shape
    N = Bmat.shape[-1]
    nchunk = max(1, math.ceil(S / chunk))
    pad = nchunk * chunk - S

    def padc(t, dim):
        t = t.float()
        if pad == 0:
            return t
        shape = list(t.shape)
        shape[dim] = pad
        return torch.cat([t, t.new_zeros(shape)], dim=dim)

    xc = padc(x, 2).reshape(B, NH, nchunk, chunk, P)
    Bc = padc(Bmat, 1).reshape(B, nchunk, chunk, N)
    Cc = padc(Cmat, 1).reshape(B, nchunk, chunk, N)
    ac = padc(a, 2).reshape(B, NH, nchunk, chunk)
    dtc = padc(dt, 2).reshape(B, NH, nchunk, chunk)
    idx = torch.arange(chunk, device=x.device)
    causal = idx[:, None] >= idx[None, :]

    h = torch.zeros((B, NH, P, N), dtype=torch.float32, device=x.device)
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


def scan_flops(B: int, NH: int, S: int, P: int, N: int,
               chunk: int = 256) -> int:
    """The reference's ``chunk``-row chunks: C Bᵀ, its mask, W (x dt),
    the incoming state's term and the state update."""
    c = chunk
    per_chunk = 2 * c * c * N + c * c + 2 * c * c * P + 4 * c * N * P
    return B * NH * math.ceil(S / c) * per_chunk


def _meta(x, Bmat, Cmat, a, dt, chunk, out_dtype):
    B, NH, S, P = x.shape
    y = torch.empty((B, S, NH, P), dtype=out_dtype,
                    device="meta").transpose(1, 2)
    meta.record("mamba2_scan", scan_flops(B, NH, S, P, Bmat.shape[-1],
                                          chunk),
                meta.nbytes(x, Bmat, Cmat, a, dt, y))
    return y


_fns = {}


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


def mamba2_scan(x: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor,
                a: torch.Tensor, dt: torch.Tensor, *, chunk: int = 256,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (B,NH,S,P); Bmat/Cmat: (B,S,N); a/dt: (B,NH,S) -> y (B,NH,S,P)
    in ``out_dtype`` (x's dtype by default). CPU tensors take
    ``mamba2_scan_plain``; CUDA tensors launch the Hopper kernel."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return mamba2_scan_plain(x, Bmat, Cmat, a, dt, chunk=chunk,
                                 out_dtype=out_dtype)
    ts = (x, Bmat, Cmat, a, dt)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"mamba2_scan: the CUDA kernel is forward-only; see "
            f"{BACKWARD_ITEM}")
    B, NH, S, P = x.shape
    N = Bmat.shape[-1]
    if x.device.type == "meta":
        pl = meta.placements(x, {0: B, 1: NH})
        bc = meta.restrict(pl, (0,))          # B and C have no head dim
        return meta.run(lambda *t: _meta(*t, chunk, out_dtype), ts,
                        (pl, bc, bc, pl, pl), pl)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError("mamba2_scan: tensors on "
                         f"{', '.join(str(t.device) for t in ts)}")
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or Bmat.dtype != x.dtype or Cmat.dtype != x.dtype
            or a.dtype != torch.float32 or dt.dtype != torch.float32
            or out_dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"mamba2_scan: dtypes "
                        f"{', '.join(str(t.dtype) for t in ts)} -> "
                        f"{out_dtype}; want x, B, C float32 or bfloat16, "
                        f"a, dt float32")
    if (Bmat.shape != (B, S, N) or Cmat.shape != (B, S, N)
            or a.shape != (B, NH, S) or dt.shape != (B, NH, S)
            or P not in DIMS or N not in DIMS or min(B, NH, S) < 1):
        raise ValueError("mamba2_scan: shapes "
                         f"{', '.join(str(tuple(t.shape)) for t in ts)}")
    if any(t.stride(-1) != 1 for t in (x, Bmat, Cmat)):
        raise ValueError("mamba2_scan: the last dim of x, Bmat and Cmat "
                         "must be contiguous")
    y = torch.empty((B, S, NH, P), dtype=out_dtype,
                    device=x.device).transpose(1, 2)
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
    if meta.counting():
        meta.record("mamba2_scan", scan_flops(B, NH, S, P, N, chunk),
                    meta.nbytes(x, Bmat, Cmat, a, dt, y))
    return y


mamba2_scan.launches = 0
