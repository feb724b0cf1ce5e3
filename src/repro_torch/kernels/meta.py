"""The kernels' meta rules: what each wrapper does with a ``meta`` tensor.

The dry-run (``launch/dryrun.py``) traces a cell's step on tensors that
hold no data: ``meta`` tensors, or DTensors whose local shards are
``meta``. A kernel cannot run there, and its plain version is no stand-in
(the plain attention builds the full ``(B, H, Sq, Sk)`` score matrix, a
per-GPU peak the kernel path never reaches). So each wrapper, on a
``meta`` input and only there, returns empty outputs of the kernel's
shapes, dtypes and layouts, and reports the kernel's work in closed form
to ``count_work`` (a launch on the card reports the same, so a step's
count on the card and on meta compare). A CPU tensor still takes the
plain version and a CUDA tensor still launches the kernel.

On DTensor inputs the rule runs per rank through ``local_map``, on
placements the kernel accepts: batch over whichever mesh axes shard it,
heads over an axis where the head counts divide, every other sharded dim
gathered first (DTensor inserts, and the dry-run reports, the
collective). The work it reports is then one rank's.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

import torch

# the active ``count_work`` sinks, innermost last. Process-wide, not
# thread-local: autograd runs a CUDA backward on its own thread, whose
# kernel calls belong to the step that started it
_sinks: List[Dict[str, Dict[str, float]]] = []
_lock = threading.Lock()


@contextlib.contextmanager
def count_work():
    """Yields ``{kernel: {"flops", "bytes", "calls"}}``, which every kernel
    call inside the body, a launch or a meta rule, on any thread, adds
    its closed-form work to (launch counters are the wrappers' own, and
    untouched)."""
    work: Dict[str, Dict[str, float]] = {}
    with _lock:
        _sinks.append(work)
    try:
        yield work
    finally:
        with _lock:
            _sinks.remove(work)


def counting() -> bool:
    """Whether a ``count_work`` is active (a launch skips computing its
    work when none is)."""
    return bool(_sinks)


def record(name: str, flops: float, nbytes: float) -> None:
    """Add one call's work (its inputs read once, outputs written once)
    to the innermost active ``count_work``, if any."""
    if not _sinks:
        return
    with _lock:
        work = _sinks[-1]
        w = work.setdefault(name, {"flops": 0.0, "bytes": 0.0,
                                   "calls": 0})
        w["flops"] += flops
        w["bytes"] += nbytes
        w["calls"] += 1


def nbytes(*ts: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def placements(t, keep: Dict[int, int]):
    """Placements for DTensor ``t`` that the kernel accepts: each mesh dim
    that shards a tensor dim of ``keep`` ({dim: size of the dim it must
    divide}) stays sharded, every other becomes ``Replicate``. ``None``
    for a plain tensor."""
    if not _is_dtensor(t):
        return None
    from torch.distributed.tensor import Replicate, Shard
    out, used = [], {}
    for i, p in enumerate(t.placements):
        d = getattr(p, "dim", None)
        n = t.device_mesh.size(i)
        if (isinstance(p, Shard) and d in keep
                and keep[d] % (used.get(d, 1) * n) == 0):
            used[d] = used.get(d, 1) * n
            out.append(Shard(d))
        else:
            out.append(Replicate())
    return tuple(out)


def restrict(pl, dims):
    """``pl`` with every ``Shard`` of a dim outside ``dims`` replicated:
    the same mesh layout for an operand that lacks some of the dims."""
    if pl is None:
        return None
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in pl)


def run(fn, args, in_placements, out_placements, in_grad_placements=None):
    """``fn(*args)``, one output; where the tensor arguments are
    DTensors, per rank through ``local_map`` on the given placements
    (``None`` for a non-tensor argument), the inputs redistributed to
    them first. ``in_grad_placements``: the inputs' gradients' placements
    where they are not the inputs' own (a replicated table's gradient
    from sharded rows is partial)."""
    if not any(_is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    kw = {} if in_grad_placements is None else {
        "in_grad_placements": tuple(in_grad_placements)}
    return local_map(fn, out_placements=(out_placements,),
                     in_placements=tuple(in_placements),
                     redistribute_inputs=True, **kw)(*args)


def partial_over(pl):
    """Placements of a replicated operand's gradient when the other
    operand is sharded by ``pl``: partial on every mesh dim ``pl``
    shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in pl)
