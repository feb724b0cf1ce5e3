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

The kernel is forward-only, as the Pallas kernel is: a CUDA call that
autograd would have to differentiate raises. A ``meta`` tensor (the
dry-run's, ``kernels/meta.py``) gets an empty y, and raises where a
CUDA tensor would; either reports ``mlstm_cost``'s work. The plain
version stays differentiable by autograd (the CPU tests hold its
gradient against ``jax.grad`` of the reference).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build, meta
from .flash_attention import _tma_layout_ok

DIMS = (32, 64, 384)    # the head dims the kernel takes
TC_DIM = 384            # bf16 at this head dim runs on the tensor cores
CHUNK = 64              # the kernel's chunk rows
BACKWARD_ITEM = "ROADMAP B.7 (the mLSTM kernel's backward, xLSTM training)"


def mlstm_chunkwise_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          logi: torch.Tensor, logf: torch.Tensor, *,
                          chunk: int = 256,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Plain version: the chunked mLSTM in f32, one chunk at a time as
    the reference's ``mlstm_apply`` runs it (S padded to a whole chunk
    with zeros, the padded rows' outputs dropped)."""
    B, NH, S, hd = q.shape
    nchunk = max(1, math.ceil(S / chunk))
    pad = nchunk * chunk - S

    def padc(t):
        t = t.float()
        if pad == 0:
            return t
        shape = list(t.shape)
        shape[2] = pad
        return torch.cat([t, t.new_zeros(shape)], dim=2)

    qc, kc, vc = (padc(t).reshape(B, NH, nchunk, chunk, hd)
                  for t in (q, k, v))
    ic, fc = (padc(t).reshape(B, NH, nchunk, chunk) for t in (logi, logf))
    idx = torch.arange(chunk, device=q.device)
    causal = idx[:, None] >= idx[None, :]

    C = torch.zeros((B, NH, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, NH, hd), dtype=torch.float32, device=q.device)
    ys = []
    for c in range(nchunk):
        q_i, k_i, v_i = qc[:, :, c], kc[:, :, c], vc[:, :, c]
        i_i, f_i = ic[:, :, c], fc[:, :, c]
        lf = torch.cumsum(f_i, dim=-1)                         # (B,NH,c)
        seg = lf[..., :, None] - lf[..., None, :]              # (B,NH,c,c)
        logD = torch.where(causal, seg + i_i[..., None, :],
                           torch.full_like(seg, -1e30))
        m = torch.maximum(torch.amax(logD, dim=-1), lf)        # stabiliser
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


def _meta(q, k, v, logi, logf, out_dtype):
    B, NH, S, hd = q.shape
    y = torch.empty((B, S, NH, hd), dtype=out_dtype,
                    device="meta").transpose(1, 2)
    nb, flops = mlstm_cost(B, NH, S, hd, q.element_size(),
                           y.element_size())
    meta.record("mlstm_chunkwise", flops, nb)
    return y


_fns = {}


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


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logi: torch.Tensor, logf: torch.Tensor, *,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """q/k/v: (B,NH,S,hd); logi/logf: (B,NH,S) -> y (B,NH,S,hd) in
    ``out_dtype`` (q's dtype by default). CPU tensors take
    ``mlstm_chunkwise_plain``; CUDA tensors launch the Hopper kernel."""
    out_dtype = out_dtype or q.dtype
    if q.device.type == "cpu":
        return mlstm_chunkwise_plain(q, k, v, logi, logf,
                                     out_dtype=out_dtype)
    ts = (q, k, v, logi, logf)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"mlstm_chunkwise: the CUDA kernel is forward-only; see "
            f"{BACKWARD_ITEM}")
    B, NH, S, hd = q.shape
    if q.device.type == "meta":
        pl = meta.placements(q, {0: B, 1: NH})
        return meta.run(lambda *t: _meta(*t, out_dtype), ts,
                        (pl,) * 5, pl)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError("mlstm_chunkwise: tensors on "
                         f"{', '.join(str(t.device) for t in ts)}")
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or k.dtype != q.dtype or v.dtype != q.dtype
            or logi.dtype != torch.float32 or logf.dtype != torch.float32
            or out_dtype not in (torch.float32, torch.bfloat16)):
        raise TypeError(f"mlstm_chunkwise: dtypes "
                        f"{', '.join(str(t.dtype) for t in ts)} -> "
                        f"{out_dtype}; want q, k, v float32 or bfloat16, "
                        f"logi, logf float32")
    if (k.shape != q.shape or v.shape != q.shape
            or logi.shape != (B, NH, S) or logf.shape != (B, NH, S)
            or hd not in DIMS or min(B, NH, S) < 1):
        raise ValueError("mlstm_chunkwise: shapes "
                         f"{', '.join(str(tuple(t.shape)) for t in ts)}; "
                         f"head dim must be one of {DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("mlstm_chunkwise: the last dim of q, k and v must "
                         "be contiguous")
    if q.dtype == torch.bfloat16 and hd == TC_DIM:
        for t in (q, k, v):
            if not _tma_layout_ok(t.shape, t.stride(), t.data_ptr(),
                                  t.element_size()):
                raise ValueError(
                    "mlstm_chunkwise: the bf16 kernel reads q, k and v "
                    "through TMA, which needs a 16-byte-aligned base and "
                    "every outer stride a multiple of 16 bytes; got strides "
                    f"{t.stride()} at address {t.data_ptr():#x}")
    y = torch.empty((B, S, NH, hd), dtype=out_dtype,
                    device=q.device).transpose(1, 2)
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
    if meta.counting():
        nb, flops = mlstm_cost(B, NH, S, hd, q.element_size(),
                               y.element_size())
        meta.record("mlstm_chunkwise", flops, nb)
    return y


mlstm_chunkwise.launches = 0
