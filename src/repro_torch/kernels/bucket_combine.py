"""Bucket combine on Hopper, beside its plain PyTorch version.

Port of ``repro/kernels/bucket_combine.py`` (the Pallas TPU kernel):
one schedule round's local reduce over the bucketed f32 gradient buffer
of the collective execution engine. With ``g`` the round's gate ("this
rank is a destination of the round's partial permutation"):

* ``op="add"``  — reduce rounds: ``acc + where(g, y, 0)``
* ``op="copy"`` — broadcast/hydration rounds: ``where(g, y, acc)``

Two layouts: ``(rows, bucket_elems)`` with a scalar gate (one rank, as
the TPU kernel runs inside ``shard_map``), and the port's stacked team
``(n, rows, bucket_elems)`` with an ``(n,)`` gate vector, one rank per
leading row (``core/collective.py::RankStack``), which one launch
covers. A zero-row buffer returns ``acc`` without a launch, as the
Pallas guard does.

``bucket_combine`` takes the plain version only for CPU tensors; a CUDA
tensor goes to the hand-written kernel ``csrc/bucket_combine.cu`` or
raises. On the card the gate must be an int32 tensor on the same device:
it is never read back to the host, so a sync costs no host round trip
per round.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# The bucket layout's cap on one bucket row (3 operands of the TPU kernel
# had to fit VMEM). The CUDA kernel walks any row length, so the wrapper
# does not check it; the layout keeps the reference's value so its
# layouts compare with the reference's field for field.
MAX_BUCKET_BYTES = 4 * 1024 * 1024
OPS = ("add", "copy")


def combine_ref(acc: torch.Tensor, y: torch.Tensor, gate,
                *, op: str = "add") -> torch.Tensor:
    """Plain version. ``gate``: a scalar for ``(rows, be)`` operands, an
    ``(n,)`` vector for ``(n, rows, be)``."""
    g = torch.as_tensor(gate, device=acc.device).bool()
    g = g.reshape(g.shape + (1,) * (acc.ndim - g.ndim))
    if op == "add":
        return acc + torch.where(g, y, torch.zeros_like(y))
    return torch.where(g, y, acc)


_fn = []


def _kernel():
    if not _fn:
        fn = build.load("bucket_combine").bucket_combine_f32
        # acc, y, gate, out, n, per_rank, acc_rs, y_rs, out_rs, add, stream
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_longlong] * 4
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def bucket_combine(acc: torch.Tensor, y: torch.Tensor, gate, *,
                   op: str = "add") -> torch.Tensor:
    """Combine one round's incoming ``y`` into ``acc``; returns a new
    tensor. CPU tensors take ``combine_ref``; CUDA tensors launch the
    Hopper kernel."""
    if op not in OPS:
        raise ValueError(f"bucket_combine: op {op!r}, want one of {OPS}")
    if acc.ndim not in (2, 3) or acc.shape != y.shape:
        raise ValueError(f"bucket_combine: shapes {tuple(acc.shape)}, "
                         f"{tuple(y.shape)}")
    if acc.shape[-2] == 0:
        return acc
    if acc.device.type == "cpu":
        return combine_ref(acc, y, gate, op=op)
    n = acc.shape[0] if acc.ndim == 3 else 1
    if (acc.device.type != "cuda" or y.device != acc.device
            or not isinstance(gate, torch.Tensor)
            or gate.device != acc.device):
        raise ValueError(f"bucket_combine: acc on {acc.device}, y on "
                         f"{y.device}, gate "
                         f"{getattr(gate, 'device', type(gate).__name__)}")
    if acc.dtype != torch.float32 or y.dtype != torch.float32 \
            or gate.dtype != torch.int32:
        raise TypeError(f"bucket_combine: dtypes {acc.dtype}, {y.dtype}, "
                        f"gate {gate.dtype}; want float32, float32, int32")
    if gate.numel() != n or not gate.is_contiguous():
        raise ValueError(f"bucket_combine: gate of {gate.numel()} for "
                         f"{n} ranks")
    rows, be = acc.shape[-2:]
    for t in (acc, y):
        if t.stride(-1) != 1 or t.stride(-2) != be:
            raise ValueError("bucket_combine: each rank's (rows, "
                             "bucket_elems) block must be contiguous")
    out = torch.empty_like(acc, memory_format=torch.contiguous_format)
    rs = [t.stride(0) if t.ndim == 3 else 0 for t in (acc, y, out)]
    with torch.cuda.device(acc.device):
        rc = _kernel()(acc.data_ptr(), y.data_ptr(), gate.data_ptr(),
                       out.data_ptr(), n, rows * be, *rs, int(op == "add"),
                       torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bucket_combine kernel launch failed: "
                           f"CUDA error {rc}")
    bucket_combine.launches += 1
    return out


bucket_combine.launches = 0
