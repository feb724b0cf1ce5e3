"""Flash decode on Hopper, beside its plain PyTorch version.

Port of ``repro/kernels/flash_decode.py`` (the Pallas TPU kernel) and of
``repro/kernels/ref.py::decode_ref`` (its oracle): one-token attention
over a KV cache. Layout as in the JAX kernel: q ``(B, H, hd)``, k/v
``(B, Kh, W, hd)``, ``valid`` ``(B, W)`` int32 (1 = the slot may be
attended; the caller encodes causality and ring-buffer validity in it).
A row with no valid slot returns the mean of v, as the reference does.

``flash_decode`` takes the plain version only for CPU tensors; a CUDA
tensor goes to the hand-written kernel ``csrc/flash_decode.cu`` or
raises; a ``meta`` tensor (the dry-run's, ``kernels/meta.py``) gets an
empty output. Either reports ``decode_flops`` over every slot (valid or
not: the mask is never read back). It is one launch (one count) a call:
a thread-block cluster per
(batch row, KV head) splits the cache into ranges of 64-key tiles,
reads no K or V of a tile whose slots are all invalid (unless the row
has no valid slot at all), and merges the splits' softmax states
through distributed shared memory in a fixed order, so two runs are
bitwise equal. bf16 groups of 4 to 16 query heads a KV head score and
sum on the tensor cores (the heads as the rows of ``mma.sync``, K and V
tiles brought by TMA, P rounded to bf16) where TMA can read the cache
views; the rest runs on the CUDA cores. No scratch is allocated. k and v are read through
element strides (last dim contiguous): the model passes its ``(B, W,
Kh, hd)`` cache as a permuted view, never a copy. Any W works (no
``W % block`` assert).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, meta

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 112, 128)
MAX_GROUP = 16


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Plain version in f32. q: (B,H,hd); k/v: (B,Kh,W,hd);
    valid: (B,W) -> (B,H,hd) in q's dtype."""
    B, H, hd = q.shape
    g = H // k.shape[1]
    kr = k.repeat_interleave(g, dim=1).float()
    vr = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhd,bhwd->bhw", q.float(), kr) / math.sqrt(hd)
    s = torch.where(valid[:, None, :] > 0, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhw,bhwd->bhd", w, vr).to(q.dtype)


def decode_flops(H: int, hd: int, n_valid: int) -> int:
    """q kᵀ and P v over the valid slots (``n_valid`` over all rows)."""
    return 4 * H * hd * n_valid


def _meta(q, k, v, valid):
    """Every slot counted valid: a meta cache holds no positions."""
    B, H, hd = q.shape
    out = torch.empty((B, H, hd), dtype=q.dtype, device="meta")
    meta.record("flash_decode", decode_flops(H, hd, valid.numel()),
                meta.nbytes(q, k, v, valid, out))
    return out


_lib = {}


def _kernel(dtype: torch.dtype):
    if not _lib:
        lib = build.load("flash_decode")
        for name, dt in (("flash_decode_f32", torch.float32),
                         ("flash_decode_bf16", torch.bfloat16)):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 11
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib[dt] = fn
    return _lib[dtype]


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); k/v: (B,Kh,W,hd); valid: (B,W) int32 -> (B,H,hd).
    CPU tensors take ``decode_ref``; CUDA tensors launch the Hopper
    kernel."""
    if q.device.type == "cpu":
        return decode_ref(q, k, v, valid)
    B, H, hd = q.shape
    Kh, W = k.shape[1], k.shape[2]
    if q.device.type == "meta":
        # batch, and q's heads where they divide; a sharded window is
        # gathered (the kernel merges its splits inside one launch)
        return meta.run_heads(_meta, q, k, v, valid)
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k, v, valid)):
        raise ValueError(f"flash_decode: tensors on {q.device}, {k.device},"
                         f" {v.device}, {valid.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype \
            or valid.dtype != torch.int32:
        raise TypeError(f"flash_decode: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {valid.dtype}")
    if (k.shape != (B, Kh, W, hd) or v.shape != k.shape
            or valid.shape != (B, W) or H % Kh or H // Kh > MAX_GROUP
            or hd not in HEAD_DIMS or min(B, W) < 1):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, valid "
                         f"{tuple(valid.shape)}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1 \
            or valid.stride(-1) != 1:
        raise ValueError("flash_decode: the last dim must be contiguous")
    fn = _kernel(q.dtype)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                out.data_ptr(), B, H, Kh, W, hd,
                q.stride(0), q.stride(1),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                valid.stride(0), out.stride(0), out.stride(1),
                1.0 / math.sqrt(hd),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: "
                           f"CUDA error {rc}")
    flash_decode.launches += 1
    if meta.counting():
        meta.record("flash_decode", decode_flops(H, hd, valid.numel()),
                    meta.nbytes(q, k, v, valid, out))
    return out


flash_decode.launches = 0
