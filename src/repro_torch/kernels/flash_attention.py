"""Flash attention (prefill) on Hopper, beside its plain PyTorch version.

Port of ``repro/kernels/flash_attention.py`` (the Pallas TPU kernel) and
of ``repro/kernels/ref.py::attention_ref`` (its oracle). The public layout
is the JAX kernel's: q ``(B, H, Sq, hd)``, k/v ``(B, Kh, Sk, hd)``, head
``h`` reading KV head ``h // (H // Kh)``.

``flash_attention`` takes the plain version only for CPU tensors; a CUDA
tensor goes to the hand-written kernel ``csrc/flash_attention.cu`` or
raises. The dispatch is by dtype: bf16 (every main path) runs on the
tensor cores (``wgmma``, tiles brought by the Tensor Memory Accelerator),
f32 (reference checks, held to 1e-4) on the CUDA cores. The kernel reads
q, k, v through element strides of their three outer dims (last dim
contiguous), so callers pass transposed views of ``(B, S, H, hd)``
projections without copying; for bf16 the TMA also needs a 16-byte-aligned
base and every outer stride a multiple of 16 bytes, which
``_tma_layout_ok`` checks (a layout that fails raises, it is never
copied). The output it returns is a ``(B, H, Sq, hd)`` view of a
``(B, Sq, H, hd)`` buffer, so the model's head merge after it is free.
Unlike the Pallas kernel, any Sq and Sk work (ragged tails are masked, not
asserted).

Training: where autograd needs a gradient of a CUDA tensor,
``flash_attention`` goes through ``FlashAttentionFn``. Its forward runs
the same kernel and also keeps each row's log-sum-exp (``attention_lse_ref``
is its plain version); its backward is ``flash_attention_bwd``, the
hand-written kernel ``csrc/flash_attention_bwd.cu``, which recomputes P
from that LSE. A CPU tensor keeps the plain ``attention_ref``, which
autograd differentiates (``attention_bwd_ref`` is that gradient as a
function). Each wrapper counts its own launches, one a call whatever the
number of CUDA launches inside; a recomputed forward (remat) counts again.

A ``meta`` tensor (the dry-run's, ``kernels/meta.py``) takes the same
path as a CUDA tensor with empty outputs of the kernels' shapes, the
forward's LSE and the backward's scratch included, and reports the
work of ``attention_flops`` / ``attention_bwd_flops`` instead of
launching; no launch is counted.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build, meta

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 112, 128)


def visible_pairs(Sq: int, Sk: int, causal: bool,
                  sliding_window: Optional[int]) -> int:
    """The (query, key) pairs the masks leave visible: for causal rows
    ``i``, ``min(i + 1, window)`` keys each."""
    if not causal:
        return Sq * Sk
    w = min(sliding_window or Sq, Sq)
    return w * (w + 1) // 2 + (Sq - w) * w


def attention_flops(B: int, H: int, Sq: int, Sk: int, hd: int,
                    causal: bool, sliding_window: Optional[int]) -> int:
    """The forward's products, q kᵀ and P v over the visible pairs."""
    return 4 * B * H * hd * visible_pairs(Sq, Sk, causal, sliding_window)


def attention_bwd_flops(B: int, H: int, Sq: int, Sk: int, hd: int,
                        causal: bool, sliding_window: Optional[int]) -> int:
    """The backward's five products over the visible pairs: q kᵀ again,
    dO vᵀ, Pᵀ dO, dS k and dSᵀ q."""
    return 10 * B * H * hd * visible_pairs(Sq, Sk, causal, sliding_window)


def _masked_scores(q, k, causal, sliding_window):
    """f32 scores q k^T / sqrt(hd) with masked keys at ``NEG_INF``."""
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // Kh, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if sliding_window is not None:
        mask = mask & (qpos - kpos < sliding_window)
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True,
                      sliding_window: Optional[int] = None) -> torch.Tensor:
    """Plain version of the forward's saved log-sum-exp: each row's
    natural-log sum of exp over its masked scores, (B, H, Sq) f32. Used
    by tests and ``chip_smoke.py``, not by the main path."""
    return torch.logsumexp(_masked_scores(q, k, causal, sliding_window),
                           dim=-1)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  sliding_window: Optional[int] = None) -> torch.Tensor:
    """Plain version: the full softmax in f32. q: (B,H,Sq,hd);
    k/v: (B,Kh,Sk,hd) -> (B,H,Sq,hd) in q's dtype."""
    vr = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1).float()
    w = torch.softmax(_masked_scores(q, k, causal, sliding_window), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vr).to(q.dtype)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      sliding_window: Optional[int] = None):
    """Plain version of the gradient: autograd of ``attention_ref``.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = attention_ref(*leaves, causal=causal,
                            sliding_window=sliding_window)
        return torch.autograd.grad(out, leaves, dout)


_fns = {}


def _kernel(name: str, dtype: torch.dtype):
    if name not in _fns:
        lib = build.load(name)
        for dt, suffix in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            fn = getattr(lib, f"{name}_{suffix}")
            if name == "flash_attention":
                # q, k, v, out, lse, B, H, Kh, Sq, Sk, hd, strides, scale,
                # causal, window, stream
                fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p])
            else:
                # q, k, v, o, dout, lse, D, dq, dk, dv, B, H, Kh, Sq, Sk,
                # hd, strides, scale, causal, window, stream
                fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                               + [ctypes.c_void_p, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fns.setdefault(name, {})[dt] = fn
    return _fns[name][dtype]


def _tma_layout_ok(shape, strides, data_ptr: int, itemsize: int) -> bool:
    """Whether the Tensor Memory Accelerator can read a tensor of this
    layout: a 16-byte-aligned base and, for every outer dim of more than
    one element, a stride of a multiple of 16 bytes (a dim of size 1 is
    never stepped along). The last dim must be contiguous."""
    if strides[-1] != 1 or data_ptr % 16:
        return False
    return all(n == 1 or (st * itemsize) % 16 == 0
               for n, st in zip(shape[:-1], strides[:-1]))


def _check(name, tensors, q, k):
    """Device, dtype and shape checks shared by both CUDA wrappers."""
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: tensors on "
                         f"{', '.join(str(t.device) for t in tensors)}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: dtypes "
                        f"{', '.join(str(t.dtype) for t in tensors)}; "
                        f"want one of float32 / bfloat16")
    kv = tensors[1:3]
    if (any(t.shape != (B, Kh, Sk, hd) for t in kv) or H % Kh
            or hd not in HEAD_DIMS or min(B, Sq, Sk) < 1
            or any(t.shape != q.shape for t in tensors[3:])):
        raise ValueError(f"{name}: shapes "
                         f"{', '.join(str(tuple(t.shape)) for t in tensors)}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{name}: the head dim must be contiguous")
    if q.dtype == torch.bfloat16:
        for t in tensors:
            if not _tma_layout_ok(t.shape, t.stride(), t.data_ptr(),
                                  t.element_size()):
                raise ValueError(
                    f"{name}: the bf16 kernel reads through TMA, which needs "
                    f"a 16-byte-aligned base and every outer stride a "
                    f"multiple of 16 bytes; got strides {t.stride()} at "
                    f"address {t.data_ptr():#x}")


def _forward(q, k, v, causal, sliding_window, want_lse):
    """Launch the forward kernel; returns (out, lse or None). On meta
    tensors, the empty outputs and the kernel's work recorded."""
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    if q.device.type != "meta":
        _check("flash_attention", (q, k, v), q, k)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if meta.counting():
        meta.record("flash_attention",
                    attention_flops(B, H, Sq, Sk, hd, causal, sliding_window),
                    meta.nbytes(q, k, v, out, lse))
    if q.device.type == "meta":
        return out, lse
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    fn = _kernel("flash_attention", q.dtype)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if want_lse else None,
                B, H, Kh, Sq, Sk, hd, ctypes.addressof(strides),
                1.0 / math.sqrt(hd), int(causal),
                int(sliding_window or 0),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"CUDA error {rc}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: Optional[torch.Tensor], *, causal: bool = True,
                        sliding_window: Optional[int] = None):
    """Gradient of ``flash_attention``: (dq, dk, dv), each in the layout
    (strides) of its input. ``out`` and ``lse`` are the forward's. CPU
    tensors take ``attention_bwd_ref`` (``out``/``lse`` unused); CUDA
    tensors launch the Hopper kernel."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, dout, causal=causal,
                                 sliding_window=sliding_window)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    if q.device.type != "meta":
        _check("flash_attention_bwd", (q, k, v, out, dout), q, k)
    if lse is None or lse.shape != (B, H, Sq) or not lse.is_contiguous() \
            or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError("flash_attention_bwd: lse must be the forward's "
                         "(B, H, Sq) f32 log-sum-exp")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    scratch = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if meta.counting():
        meta.record("flash_attention_bwd",
                    attention_bwd_flops(B, H, Sq, Sk, hd, causal,
                                        sliding_window),
                    meta.nbytes(q, k, v, out, dout, lse, dq, dk, dv))
    if q.device.type == "meta":
        return dq, dk, dv
    ts = (q, k, v, out, dout, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(s for t in ts
                                         for s in t.stride()[:3]))
    fn = _kernel("flash_attention_bwd", q.dtype)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, H, Kh, Sq, Sk, hd, ctypes.addressof(strides),
                1.0 / math.sqrt(hd), int(causal), int(sliding_window or 0),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"CUDA error {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel (keeping the LSE) and the backward kernel,
    joined for autograd. CUDA tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window):
        out, lse = _forward(q, k, v, causal, sliding_window, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sliding_window = causal, sliding_window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=ctx.causal,
                                         sliding_window=ctx.sliding_window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,Sq,hd); k/v: (B,Kh,Sk,hd) -> (B,H,Sq,hd). CPU tensors take
    ``attention_ref``; CUDA tensors launch the Hopper kernel, through
    ``FlashAttentionFn`` where autograd needs their gradient. DTensors
    (the dry-run's meta shards, or CPU shards) run it per rank."""
    if meta._is_dtensor(q):
        return meta.run_heads(lambda *t: flash_attention(
            *t, causal=causal, sliding_window=sliding_window), q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal,
                             sliding_window=sliding_window)
    return _call(q, k, v, causal, sliding_window)


def _call(q, k, v, causal, sliding_window):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, sliding_window)
    return _forward(q, k, v, causal, sliding_window, want_lse=False)[0]


flash_attention.launches = 0
