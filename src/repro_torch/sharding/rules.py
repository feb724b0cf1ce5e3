"""Logical-axis sharding: models annotate tensors with *logical* axes;
rules map logical axes to mesh axes per architecture/policy. Port of
``repro/sharding/rules.py`` on PyTorch's ``DeviceMesh`` and DTensor.

Model code calls ``constrain(x, "batch", "seq", "embed")``. Under an active
``use_rules(...)`` context the logical names resolve to mesh axes and a
DTensor is redistributed to them; with no context (every serving and
training path) it is a no-op — the same model code runs everywhere.

A spec is a tuple with one entry per tensor dim: ``None`` (not sharded),
a mesh-axis name, or a tuple of names (the dim split over several mesh
axes, major first) — what the reference's ``PartitionSpec`` holds.
``spec_to_placements`` turns it into DTensor placements.

Parameter shardings are derived from the *paths* of the parameter tree
(``"blocks/attn/wq"``) by pattern rules (``param_specs``); the port's
tree has the reference's paths, so the patterns are the reference's.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from ..utils import tree_flatten, tree_unflatten

Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names -> mesh axis (or tuple of axes, or None)."""

    mesh: Any = None                  # a DeviceMesh
    logical: Dict[str, object] = field(default_factory=dict)
    # path-pattern -> tuple of logical axis names (one per tensor dim);
    # first match wins; unmatched params are fully replicated.
    params: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = ()

    def resolve(self, *names: Optional[str]) -> Spec:
        return tuple(None if n is None else self.logical.get(n)
                     for n in names)

    def spec_for_path(self, path: str, ndim: int) -> Spec:
        for pat, lnames in self.params:
            if re.search(pat, path):
                if len(lnames) > ndim:
                    raise ValueError(f"rule {pat} has {len(lnames)} axes, "
                                     f"param {path} has {ndim} dims")
                if len(lnames) < ndim:
                    # extra LEADING dims are stack dims (group scans add a
                    # second one); they are never sharded
                    lnames = (None,) * (ndim - len(lnames)) + tuple(lnames)
                return self.resolve(*lnames)
        return ()


_tls = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_tls, "rules", None)
    _tls.rules = rules
    try:
        yield rules
    finally:
        _tls.rules = prev


def spec_to_placements(spec: Spec, mesh):
    """DTensor placements (one per mesh dim) of ``spec``: ``Shard(d)`` on
    each mesh dim that tensor dim ``d`` names, ``Replicate()`` on the
    rest. A tuple of axes on one dim must follow the mesh's own order
    (the reference's major-first split)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} on dim {d} are not "
                             f"in the mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} uses mesh axis {names[i]!r} "
                                 f"twice")
            out[i] = Shard(d)
    return tuple(out)


def _divisible(spec: Spec, shape, mesh) -> Spec:
    """``spec`` with every dim its mesh axes do not divide left unsharded
    (GSPMD pads such a dim; DTensor would shard it unevenly, a batch of 1
    over 16 ranks, which its view rules then refuse)."""
    names = list(mesh.mesh_dim_names)
    out = []
    for n, entry in zip(shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        size = 1
        for a in axes:
            size *= mesh.size(names.index(a))
        out.append(entry if n % size == 0 else None)
    return tuple(out)


def constrain(x, *logical_axes: Optional[str]):
    """Annotate activation ``x`` with logical axes (no-op w/o rules): a
    DTensor is redistributed to the resolved placements (a dim the
    resolved axes do not divide stays unsharded)."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = spec_to_placements(
        _divisible(rules.resolve(*logical_axes), x.shape, rules.mesh),
        rules.mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(rules.mesh, want)
    if not x.to_local().is_contiguous():
        # an uneven shard's redistribution can leave a padded local view,
        # which DTensor's own view rules then refuse
        x = DTensor.from_local(x.to_local().contiguous(), rules.mesh, want,
                               run_check=False, shape=x.shape,
                               stride=x.stride())
    return x


def project(x, w, parallel: str):
    """``x @ w`` for a tensor-parallel projection: ``parallel`` is
    "column" (``w`` is (in, out), its output dim tensor-parallel), "row"
    (its input dim) or "vocab" (``x @ w.t()`` for a (vocab, in) table,
    the unembedding, its vocab dim tensor-parallel). On a plain tensor,
    or with no rules, it is that product itself.

    On the dry-run's DTensors it runs per rank (``kernels.meta.run``),
    forward and both gradients on the local shards, mesh dim by mesh
    dim, with ``w``'s placements its parameter's rule gave it (a dim a
    mesh dim does not divide is gathered) and ``x``'s batch the rules':

    * where ``w``'s tensor-parallel dim is sharded, it keeps that shard;
      the output is sharded ("column", "vocab") or partial ("row") until
      the next ``constrain``;
    * where ``x``'s batch is sharded, ``w`` is gathered and its gradient
      is partial there, the pending reduce of a weight gradient;
    * where ``w``'s other dim is sharded (FSDP) and the batch is not (a
      batch the data axes do not divide, or a decode step, whose tokens
      are fewer than the weight's elements and move instead), ``w``
      keeps its shard and ``x`` is split to match, its output partial or
      sharded there.

    DTensor's own ``matmul`` flattens the token dims, and its backward
    can make a strided shard of them, each of whose redistribution plans
    is a graph search; it also replicates products to save bytes."""
    vocab, col = parallel == "vocab", parallel != "row"
    mm = (lambda a, b: a @ b.t()) if vocab else (lambda a, b: a @ b)
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return mm(x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return mm(x, w)
    from ..kernels import meta
    mesh = rules.mesh
    # w's tensor-parallel dim, and its other (FSDP) dim
    tp_dim, fs_dim = (1, 0) if parallel == "column" else (0, 1)

    def sharding(d):
        """The mesh dims that shard ``w``'s dim ``d`` (none unless they
        divide it)."""
        on = [p.is_shard(d) for p in w.placements]
        size = math.prod(mesh.size(i) for i, o in enumerate(on) if o)
        return on if w.shape[d] % size == 0 else [False] * len(on)
    spec = _divisible(rules.resolve("batch"), x.shape[:1], mesh)
    bt = [p.is_shard() for p in spec_to_placements(spec, mesh)]
    tp, fs = sharding(tp_dim), sharding(fs_dim)
    if x.numel() < w.numel():
        bt = [b and not f for b, f in zip(bt, fs)]
    fs = [f and not b and not t for f, b, t in zip(fs, bt, tp)]

    def pick(on_batch, on_tp, on_fsdp):
        return tuple(on_batch if b else on_tp if t else on_fsdp if f
                     else Replicate() for b, t, f in zip(bt, tp, fs))
    R, P, S0, Sl = Replicate(), Partial(), Shard(0), Shard(x.ndim - 1)
    wpl = pick(R, Shard(tp_dim), Shard(fs_dim))
    if col:
        xpl, opl, dxpl = pick(S0, R, Sl), pick(S0, Sl, P), pick(S0, P, Sl)
    else:
        xpl, opl, dxpl = pick(S0, Sl, R), pick(S0, P, Sl), pick(S0, Sl, P)
    dwpl = pick(P, Shard(tp_dim), Shard(fs_dim))
    return meta.run(mm, (x, w), (xpl, wpl), opl,
                    in_grad_placements=(dxpl, dwpl))


def param_specs(params, rules: ShardingRules):
    """Spec tree matching ``params`` (a nested dict of tensors) via the
    path rules."""
    paths, leaves = tree_flatten(params)
    return tree_unflatten(paths, [
        rules.spec_for_path("/".join(p), x.ndim)
        for p, x in zip(paths, leaves)])


def param_shardings(params, rules: ShardingRules):
    """Placements tree matching ``params``."""
    paths, specs = tree_flatten(param_specs(params, rules))
    return tree_unflatten(paths, [spec_to_placements(s, rules.mesh)
                                  for s in specs])
