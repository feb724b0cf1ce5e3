"""Bucketed flattening of gradient trees for the execution engine.
Port of ``repro/collective_exec/buckets.py``.

The grad tree is raveled leaf by leaf into an f32 vector, the *alive
flag* (1.0 for a contributing worker, 0.0 for a departed one) is
appended, and the vector is zero-padded up to a ``(n_buckets,
bucket_elems)`` buffer whose rows are multiples of 128 elements. One
round of the schedule then moves the whole buffer and one
``bucket_combine`` launch combines it, instead of one op per leaf.
Because the flag rides the same all-reduce as the payload, the reduced
buffer's flag slot holds the live contributor count: the masked mean
costs no second collective.

**Reverse-layer order + readiness groups**: leaves are ordered by
reverse topological depth (output-side parameters first, stacked
blocks next, input-side embeddings last), the order backprop finalizes
them, and contiguous runs of one readiness class form bucket groups,
each padded to whole buckets so each group's sub-buffer is a standalone
collective operand. ``block_groups=K`` splits the stacked-blocks group
into K row ranges of the layer axis, last rows first (the order the
backward walks the layers).

Leaves are taken in ``jax.tree_util`` order (dict keys sorted, see
``utils.tree_flatten``) and the defaults (128-element rows, 1 << 16
elements per bucket, the reference's row cap) are kept, so a layout
equals the reference's field for field.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..kernels.bucket_combine import MAX_BUCKET_BYTES
from ..utils import Path, tree_flatten, tree_unflatten

LANES = 128                        # rows stay multiples of 128 elements
DEFAULT_BUCKET_ELEMS = 1 << 16     # 256 KiB f32 rows

# readiness classes, in the order backprop finalizes gradients:
#   0 = output side (loss head: grads ready first)
#   1 = interior blocks (stacked-layer leaves)
#   2 = input side (embeddings: accumulated until the very end)
_OUTPUT_NAMES = ("lm_head", "final_norm", "head", "out_norm")
_INPUT_NAMES = ("embed", "patch_proj", "frame_proj")


def _path_names(path: Path) -> List[str]:
    return [str(p).lower() for p in path]


def _leaf_class(path: Path) -> int:
    for n in _path_names(path):
        if any(tag in n for tag in _OUTPUT_NAMES):
            return 0
        if any(tag in n for tag in _INPUT_NAMES):
            return 2
    return 1


def _rows_elems(size: int, shape: Tuple[int, ...],
                rows: Optional[Tuple[int, int]]) -> int:
    """Raveled elems a leaf contributes to a group: the whole leaf, or
    its [rlo, rhi) slice of the leading layer axis."""
    if rows is None:
        return size
    rlo, rhi = rows
    return (rhi - rlo) * (size // shape[0])


@dataclass(frozen=True)
class BucketLayout:
    """Static identity of the bucketed buffer. ``paths`` are the leaves'
    key paths in flatten order (the tree structure); ``perm[j]`` is the
    index (into flatten order) of the j-th leaf in buffer order;
    ``group_leaves`` are [lo, hi) ranges into that permuted order, one
    per readiness group; ``group_rows[g]`` restricts group g to a
    [rlo, rhi) slice of its stacked leaves' leading axis (``None`` takes
    whole leaves); ``group_buckets`` is each group's bucket count. The
    alive flag sits at ``flag_index`` (flattened element index), the
    tail of the last group."""

    paths: Tuple[Path, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    payload: int                   # raveled grad elems (without the flag)
    n_buckets: int
    bucket_elems: int
    perm: Tuple[int, ...] = ()
    group_leaves: Tuple[Tuple[int, int], ...] = ()
    group_rows: Tuple[Optional[Tuple[int, int]], ...] = ()
    group_buckets: Tuple[int, ...] = ()
    flag_index: int = -1

    def __post_init__(self):
        if not self.perm:
            object.__setattr__(self, "perm",
                               tuple(range(len(self.sizes))))
        if not self.group_leaves:
            object.__setattr__(self, "group_leaves",
                               ((0, len(self.sizes)),))
        if not self.group_rows:
            object.__setattr__(self, "group_rows",
                               (None,) * len(self.group_leaves))
        if not self.group_buckets:
            object.__setattr__(self, "group_buckets", (self.n_buckets,))
        if self.flag_index < 0:
            object.__setattr__(
                self, "flag_index",
                (self.n_buckets - self.group_buckets[-1])
                * self.bucket_elems + self._group_payload(-1) - 1)

    @property
    def total_elems(self) -> int:
        return self.n_buckets * self.bucket_elems

    @property
    def n_groups(self) -> int:
        return len(self.group_buckets)

    @property
    def groups(self) -> Tuple[Tuple[int, int], ...]:
        """Per-group [start, stop) bucket ranges, readiness order."""
        out, off = [], 0
        for nb in self.group_buckets:
            out.append((off, off + nb))
            off += nb
        return tuple(out)

    def _leaf_elems(self, i: int, rows: Optional[Tuple[int, int]]) -> int:
        return _rows_elems(self.sizes[i], self.shapes[i], rows)

    def _group_payload(self, g: int) -> int:
        """Raveled elems in group g, including the flag in the last."""
        if g == -1:
            g = len(self.group_leaves) - 1
        lo, hi = self.group_leaves[g]
        rows = self.group_rows[g]
        base = sum(self._leaf_elems(self.perm[j], rows)
                   for j in range(lo, hi))
        return base + (1 if g == len(self.group_leaves) - 1 else 0)

    # ----------------------------------------------------------- flatten
    def flatten_into(self, buf: torch.Tensor, tree, alive) -> torch.Tensor:
        """Write ``tree`` (f32-cast) and the alive flag into ``buf``, a
        ``(n_buckets, bucket_elems)`` f32 buffer allocated by the caller
        (a program reuses one per rank across steps); padding is
        re-zeroed. Returns ``buf``."""
        leaves = tree_flatten(tree)[1]
        assert len(leaves) == len(self.sizes), \
            (len(leaves), len(self.sizes))
        assert buf.shape == (self.n_buckets, self.bucket_elems), buf.shape
        flat = buf.view(-1)
        for g, (lo, hi) in enumerate(self.group_leaves):
            rows = self.group_rows[g]
            pos = self.groups[g][0] * self.bucket_elems
            for j in range(lo, hi):
                leaf = leaves[self.perm[j]]
                if rows is not None:
                    leaf = leaf[rows[0]:rows[1]]
                n = leaf.numel()
                flat[pos:pos + n].copy_(leaf.reshape(-1))
                pos += n
            if g == self.n_groups - 1:
                flat[pos:pos + 1].copy_(torch.as_tensor(alive).reshape(1))
                pos += 1
            flat[pos:self.groups[g][1] * self.bucket_elems].zero_()
        return buf

    def flatten(self, tree, alive) -> torch.Tensor:
        """tree -> (n_buckets, bucket_elems) f32, alive flag appended at
        the tail of the last readiness group."""
        device = tree_flatten(tree)[1][0].device
        buf = torch.empty((self.n_buckets, self.bucket_elems),
                          dtype=torch.float32, device=device)
        return self.flatten_into(buf, tree, alive)

    def split_groups(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """Per-group views of a buffer whose second-to-last dim is the
        bucket dim: ``(n_buckets, be)`` or stacked ``(n, n_buckets, be)``."""
        return [buf[..., lo:hi, :] for lo, hi in self.groups]

    def flatten_groups(self, tree, alive) -> List[torch.Tensor]:
        """tree -> per-group ``(g_buckets, bucket_elems)`` f32 buffers."""
        return self.split_groups(self.flatten(tree, alive))

    # --------------------------------------------------------- unflatten
    def unflatten_groups(self, bufs: Sequence[torch.Tensor]
                         ) -> Tuple[Any, torch.Tensor]:
        """Per-group buffers -> (tree, contributor count)."""
        assert len(bufs) == self.n_groups, (len(bufs), self.n_groups)
        return self.unflatten(torch.cat(list(bufs), dim=0))

    def unflatten(self, buf: torch.Tensor) -> Tuple[Any, torch.Tensor]:
        """(n_buckets, bucket_elems) -> (tree, contributor count); each
        leaf cast back to its dtype."""
        flat = buf.reshape(-1)
        leaves: List[Any] = [None] * len(self.sizes)
        pieces: dict = {}              # leaf idx -> [(rlo, rows tensor)]
        off = 0
        for g, (lo, hi) in enumerate(self.group_leaves):
            rows = self.group_rows[g]
            pos = off
            for j in range(lo, hi):
                i = self.perm[j]
                size = self._leaf_elems(i, rows)
                seg = flat[pos:pos + size]
                if rows is None:
                    leaves[i] = seg.reshape(self.shapes[i]).to(
                        self.dtypes[i])
                else:
                    pieces.setdefault(i, []).append(
                        (rows[0], seg.reshape(rows[1] - rows[0],
                                              *self.shapes[i][1:])))
                pos += size
            off += self.group_buckets[g] * self.bucket_elems
        for i, ps in pieces.items():
            stacked = torch.cat(
                [p for _, p in sorted(ps, key=lambda t: t[0])], dim=0)
            leaves[i] = stacked.reshape(self.shapes[i]).to(self.dtypes[i])
        count = flat[self.flag_index]
        return tree_unflatten(list(self.paths), leaves), count


def make_layout(tree, *, bucket_elems: Optional[int] = None,
                order: str = "reverse_topo",
                block_groups: int = 1) -> BucketLayout:
    """Derive the bucket layout from a tree of tensors (typically
    ``api.param_spec()``'s meta tensors).

    ``order="reverse_topo"`` (default) sorts leaves by reverse
    topological depth and records the readiness groups; ``order="tree"``
    keeps flatten order in a single group. ``block_groups=K`` splits the
    stacked-blocks group into K layer-row sub-groups, last rows first.
    """
    assert order in ("reverse_topo", "tree"), order
    assert block_groups >= 1, block_groups
    paths, leaves = tree_flatten(tree)
    assert leaves, "empty gradient tree"
    shapes = tuple(tuple(l.shape) for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    sizes = tuple(int(math.prod(s)) for s in shapes)
    payload = sum(sizes)
    total = payload + 1                       # + alive flag
    if bucket_elems is None:
        bucket_elems = min(DEFAULT_BUCKET_ELEMS,
                           -(-total // LANES) * LANES)
    assert bucket_elems % LANES == 0, bucket_elems
    assert bucket_elems * 4 <= MAX_BUCKET_BYTES, bucket_elems

    if order == "reverse_topo":
        classes = [_leaf_class(p) for p in paths]
    else:
        classes = [1] * len(leaves)

    # stacked-blocks leaves: class 1, under a "blocks" subtree, with one
    # common layer count: the only leaves eligible for row splitting
    stacked = [classes[i] == 1 and "blocks" in _path_names(paths[i])
               and len(shapes[i]) >= 1 and shapes[i][0] > 0
               for i in range(len(leaves))]
    scan_lens = {shapes[i][0] for i in range(len(leaves)) if stacked[i]}
    scan_len = scan_lens.pop() if len(scan_lens) == 1 else 0
    n_row_groups = (min(block_groups, scan_len)
                    if order == "reverse_topo" and scan_len else 1)
    if n_row_groups == 1:
        stacked = [False] * len(leaves)

    if order == "reverse_topo":
        # within class 1, stacked-blocks leaves sort ahead of loose
        # class-1 leaves (a no-op unless rows are split)
        sub = [0 if (classes[i] != 1 or stacked[i] or n_row_groups == 1)
               else 1 for i in range(len(leaves))]
        perm = tuple(sorted(range(len(leaves)),
                            key=lambda i: (classes[i], sub[i], i)))
    else:
        sub = [0] * len(leaves)
        perm = tuple(range(len(leaves)))

    # contiguous runs of one (readiness class, stackedness) -> groups;
    # the stacked-blocks run fans out into n_row_groups row slices,
    # last rows first
    group_leaves: List[Tuple[int, int]] = []
    group_rows: List[Optional[Tuple[int, int]]] = []
    lo = 0
    key_of = lambda i: (classes[i], sub[i], stacked[i])
    for j in range(1, len(perm) + 1):
        if j < len(perm) and key_of(perm[j]) == key_of(perm[lo]):
            continue
        if stacked[perm[lo]] and n_row_groups > 1:
            bounds = [round(k * scan_len / n_row_groups)
                      for k in range(n_row_groups + 1)]
            for k in range(n_row_groups - 1, -1, -1):
                group_leaves.append((lo, j))
                group_rows.append((bounds[k], bounds[k + 1]))
        else:
            group_leaves.append((lo, j))
            group_rows.append(None)
        lo = j

    group_buckets = []
    for g, (glo, ghi) in enumerate(group_leaves):
        elems = sum(_rows_elems(sizes[perm[j]], shapes[perm[j]],
                                group_rows[g])
                    for j in range(glo, ghi))
        if g == len(group_leaves) - 1:
            elems += 1                        # alive flag rides the tail
        group_buckets.append(max(1, -(-elems // bucket_elems)))
    return BucketLayout(paths=tuple(paths), shapes=shapes, dtypes=dtypes,
                        sizes=sizes, payload=payload,
                        n_buckets=sum(group_buckets),
                        bucket_elems=bucket_elems, perm=perm,
                        group_leaves=tuple(group_leaves),
                        group_rows=tuple(group_rows),
                        group_buckets=tuple(group_buckets))
