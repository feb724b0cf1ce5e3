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
