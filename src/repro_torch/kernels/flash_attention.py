"""Flash attention (prefill) on Hopper, beside its plain PyTorch version.

Port of ``repro/kernels/flash_attention.py`` (the Pallas TPU kernel) and
of ``repro/kernels/ref.py::attention_ref`` (its oracle). The public layout
is the JAX kernel's: q ``(B, H, Sq, hd)``, k/v ``(B, Kh, Sk, hd)``, head
``h`` reading KV head ``h // (H // Kh)``.

``flash_attention`` takes the plain version only for CPU tensors; a CUDA
tensor goes to the hand-written kernel ``csrc/flash_attention.cu`` or
raises. The kernel reads q, k, v through element strides of their three
outer dims (last dim contiguous), so callers pass transposed views of
``(B, S, H, hd)`` projections without copying; the output it returns is
a ``(B, H, Sq, hd)`` view of a ``(B, Sq, H, hd)`` buffer, so the model's
head merge after it is free. Unlike the Pallas kernel, any Sq and Sk work
(ragged tails are masked, not asserted).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  sliding_window: Optional[int] = None) -> torch.Tensor:
    """Plain version: the full softmax in f32. q: (B,H,Sq,hd);
    k/v: (B,Kh,Sk,hd) -> (B,H,Sq,hd) in q's dtype."""
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    g = H // Kh
    kr = k.repeat_interleave(g, dim=1).float()
    vr = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if sliding_window is not None:
        mask = mask & (qpos - kpos < sliding_window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vr).to(q.dtype)


_fns = {}


def _kernel(dtype: torch.dtype):
    if not _fns:
        lib = build.load("flash_attention")
        for name, dt in (("flash_attention_f32", torch.float32),
                         ("flash_attention_bf16", torch.bfloat16)):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fns[dt] = fn
    return _fns[dtype]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sliding_window: Optional[int] = None) -> torch.Tensor:
    """q: (B,H,Sq,hd); k/v: (B,Kh,Sk,hd) -> (B,H,Sq,hd). CPU tensors take
    ``attention_ref``; CUDA tensors launch the Hopper kernel."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal,
                             sliding_window=sliding_window)
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: tensors on {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; want one of float32 / bfloat16")
    if (k.shape != (B, Kh, Sk, hd) or v.shape != k.shape or H % Kh
            or hd not in HEAD_DIMS or min(B, Sq, Sk) < 1):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    fn = _kernel(q.dtype)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, Kh, Sq, Sk, hd, ctypes.addressof(strides),
                1.0 / math.sqrt(hd), int(causal),
                int(sliding_window or 0),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
