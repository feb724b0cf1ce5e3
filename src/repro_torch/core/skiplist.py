"""Deterministic skip lists augmented with signal edges (SCSL / SNSL).

This module is the *sequential* topology oracle: it computes the structure the
distributed protocol (``core/phaser.py``) converges to, supplies initial
topologies to ``core/creation.py``, and is compiled into static collective
schedules by ``core/collective.py``.

Determinism: node heights are drawn from a counter-based hash of
``(seed, phaser_id, key)`` so that every rank derives an identical structure
with no communication — a deliberate adaptation of the paper's probabilistic
skip list for the SPMD data plane (DESIGN.md §2). The geometric height
distribution (parameter ``p``) that the paper's complexity analysis assumes is
preserved.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

HEAD = -1  # sentinel key of the designated head (head-signaler / head-waiter)


def det_height(key: int, *, p: float = 0.5, max_height: int = 32,
               seed: int = 0, phaser_id: int = 0) -> int:
    """Geometric(p) height in [1, max_height] from a counter-based hash.

    Height h means the node is present on levels 0..h-1. A *demoted*
    key (straggler pinned to a leaf position) is handled one level up:
    ``SkipList``'s ``leaf_keys`` override forces height 1 without
    perturbing any other key's draw.
    """
    if key == HEAD:
        return max_height + 1  # head is taller than everything: every lane ends there
    digest = hashlib.sha256(
        f"{seed}:{phaser_id}:{key}".encode()).digest()
    # Use digest bits as a stream of Bernoulli(p) trials.
    h = 1
    bits = int.from_bytes(digest, "big")
    # 256 bits is far more than max_height trials even for small p.
    threshold = int(p * (1 << 16))
    while h < max_height:
        chunk = bits & 0xFFFF
        bits >>= 16
        if chunk >= threshold:
            break
        h += 1
    return h


@dataclass
class Node:
    key: int
    height: int
    # nxt[l] / prv[l]: neighbor keys on level l (None == end of lane).
    nxt: List[Optional[int]] = field(default_factory=list)
    prv: List[Optional[int]] = field(default_factory=list)

    def __post_init__(self):
        if not self.nxt:
            self.nxt = [None] * self.height
            self.prv = [None] * self.height

    @property
    def top(self) -> int:
        return self.height - 1


class SkipList:
    """Sorted-by-key skip list with a permanent HEAD sentinel.

    Signal-edge convention (SCSL): the *parent* of node x is its predecessor
    at x's top level; signals flow child -> parent, terminating at HEAD.
    The SNSL uses the same structure with edges reversed (parent -> children)
    for notification diffusion.
    """

    def __init__(self, *, p: float = 0.5, max_height: int = 32, seed: int = 0,
                 phaser_id: int = 0,
                 leaf_keys: Optional[Iterable[int]] = None):
        self.p = p
        self.max_height = max_height
        self.seed = seed
        self.phaser_id = phaser_id
        # demoted keys: pinned to height 1 (leaf of the SCSL reduce
        # tree — fewest dependents) regardless of their hash draw
        self.leaf_keys = frozenset(leaf_keys or ())
        self.nodes: Dict[int, Node] = {}
        head = Node(HEAD, max_height + 1)
        self.nodes[HEAD] = head

    # -- construction -----------------------------------------------------
    @classmethod
    def build(cls, keys: Iterable[int], **kw) -> "SkipList":
        sl = cls(**kw)
        for k in sorted(keys):
            sl.insert(k)
        return sl

    def height_of(self, key: int) -> int:
        if key in self.leaf_keys:
            return 1
        return det_height(key, p=self.p, max_height=self.max_height,
                          seed=self.seed, phaser_id=self.phaser_id)

    def insert(self, key: int, height: Optional[int] = None) -> Node:
        if key in self.nodes:
            raise KeyError(f"duplicate key {key}")
        h = height if height is not None else self.height_of(key)
        node = Node(key, h)
        self.nodes[key] = node
        preds = self._preds(key)
        for l in range(h):
            p = preds[l]
            pn = self.nodes[p]
            s = pn.nxt[l]
            node.prv[l] = p
            node.nxt[l] = s
            pn.nxt[l] = key
            if s is not None:
                self.nodes[s].prv[l] = key
        return node

    def insert_level0(self, key: int) -> Node:
        """Eager insertion: splice at level 0 only (paper's fast step)."""
        return self.insert(key, height=1)

    def promote(self, key: int, target_height: Optional[int] = None) -> None:
        """Lazy promotion: raise ``key`` level by level to its drawn height."""
        node = self.nodes[key]
        tgt = target_height if target_height is not None else self.height_of(key)
        while node.height < tgt:
            l = node.height  # level being joined
            # hand-over-hand walk left along level l-1 to find the level-l pred
            cur = node.prv[l - 1]
            while cur is not None and self.nodes[cur].height <= l:
                cur = self.nodes[cur].prv[l - 1]
            assert cur is not None  # HEAD is on every level
            pn = self.nodes[cur]
            s = pn.nxt[l]
            node.nxt.append(s)
            node.prv.append(cur)
            node.height += 1
            pn.nxt[l] = key
            if s is not None:
                self.nodes[s].prv[l] = key

    def delete(self, key: int) -> None:
        """Level-by-level unlink, top down (paper's deletion)."""
        node = self.nodes[key]
        for l in reversed(range(node.height)):
            p, s = node.prv[l], node.nxt[l]
            if p is not None:
                self.nodes[p].nxt[l] = s
            if s is not None:
                self.nodes[s].prv[l] = p
        del self.nodes[key]

    def _preds(self, key: int) -> List[int]:
        """Predecessor key at every level for an insertion at ``key``."""
        preds = [HEAD] * (self.max_height + 1)
        cur = self.nodes[HEAD]
        for l in reversed(range(self.max_height + 1)):
            while True:
                nk = cur.nxt[l] if l < cur.height else None
                if nk is not None and nk < key:
                    cur = self.nodes[nk]
                else:
                    break
            preds[l] = cur.key
        return preds

    # -- signal-edge topology ---------------------------------------------
    def parent(self, key: int) -> Optional[int]:
        """Signal edge: predecessor at the node's top level (None for HEAD)."""
        if key == HEAD:
            return None
        n = self.nodes[key]
        return n.prv[n.top]

    def children(self, key: int) -> List[int]:
        """All nodes whose signal edge points at ``key`` (deterministic order:
        by (level, position))."""
        out = []
        n = self.nodes[key]
        for l in range(n.height):
            s = n.nxt[l]
            if s is not None and self.nodes[s].top == l:
                # every maximal run of top==l nodes chains leftward into us
                out.append(s)
        return out

    def collection_edges(self) -> List[Tuple[int, int]]:
        """(child, parent) signal edges of the SCSL."""
        return [(k, self.parent(k)) for k in self.keys()]

    def depth(self, key: int) -> int:
        """Hops from ``key`` to HEAD along signal edges (critical path)."""
        d = 0
        cur = key
        while cur != HEAD:
            cur = self.parent(cur)
            d += 1
        return d

    def max_depth(self) -> int:
        return max((self.depth(k) for k in self.keys()), default=0)

    # -- introspection ------------------------------------------------------
    def keys(self) -> List[int]:
        """Participant keys (excluding HEAD) in level-0 order."""
        out = []
        cur = self.nodes[HEAD].nxt[0]
        while cur is not None:
            out.append(cur)
            cur = self.nodes[cur].nxt[0]
        return out

    def level_chain(self, l: int) -> List[int]:
        """Keys present on lane ``l``, following nxt pointers from HEAD."""
        out = []
        cur = self.nodes[HEAD].nxt[l]
        while cur is not None:
            out.append(cur)
            cur = self.nodes[cur].nxt[l]
        return out

    def lanes(self) -> List[List[int]]:
        """Every lane chain, lane 0 first. Lane 0 is always present (it
        may be empty); higher lanes stop at the first empty one."""
        out = []
        l = 0
        while True:
            lane = self.level_chain(l)
            if not lane and l > 0:
                break
            out.append(lane)
            l += 1
        return out

    def fingerprint(self) -> str:
        """Stable digest of the full topology (per-key heights + every
        lane chain + the demotion set). Two parties that derived the
        same structure — e.g. every process of the partitioned control
        plane at an epoch boundary — agree on this string; that is the
        cross-process agreement check of the multi-host runtime."""
        payload = repr((sorted((k, self.nodes[k].height)
                               for k in self.keys()),
                        self.lanes(),
                        sorted(self.leaf_keys))).encode()
        return hashlib.sha256(payload).hexdigest()[:16]

    # -- partitioned (PGAS) view --------------------------------------------
    def partition(self, owner_of) -> Dict[int, "PartitionView"]:
        """Split the global structure into per-owner views: one logical
        skip list over partitioned per-process state (the global-view
        surface of arXiv:2112.00068). ``owner_of`` maps a key (including
        HEAD) to its owning process id; each view carries full link
        state for its own keys and only boundary references to remote
        ones. The union of the views is exactly the global list."""
        get = owner_of if callable(owner_of) else owner_of.__getitem__
        nodes_by_owner: Dict[int, Dict[int, Tuple]] = {}
        for k in [HEAD] + self.keys():
            n = self.nodes[k]
            nodes_by_owner.setdefault(get(k), {})[k] = (
                n.height, tuple(n.nxt), tuple(n.prv))
        out = {}
        for o, nodes in sorted(nodes_by_owner.items()):
            local = set(nodes)
            boundary = sorted({r for (_, nx, pv) in nodes.values()
                               for r in (*nx, *pv)
                               if r is not None and r not in local})
            out[o] = PartitionView(owner=o,
                                   nodes=tuple(sorted(
                                       (k, h, nx, pv)
                                       for k, (h, nx, pv) in nodes.items())),
                                   boundary=tuple(boundary))
        return out

    def check_integrity(self) -> None:
        """Structural invariants (used by tests and the model checker)."""
        keys = self.keys()
        assert keys == sorted(keys), f"level-0 not sorted: {keys}"
        assert len(set(keys)) == len(keys), "duplicate on level 0"
        for k, n in self.nodes.items():
            assert len(n.nxt) == n.height and len(n.prv) == n.height
            for l in range(n.height):
                if k == HEAD and l >= self.max_height + 1:
                    continue
                s = n.nxt[l]
                if s is not None:
                    sn = self.nodes[s]
                    assert l < sn.height, (k, l, s)
                    assert sn.prv[l] == k, f"prv/nxt mismatch at {k}->{s} level {l}"
                    assert s > k or k == HEAD
        # lane l must link exactly the keys of height > l, in sorted order
        l = 0
        while True:
            expect = [k for k in keys if self.nodes[k].height > l]
            assert self.level_chain(l) == expect, f"lane {l} mislinked"
            if not expect:
                break
            l += 1

    def describe(self) -> str:
        lines = []
        hmax = max((self.nodes[k].height for k in self.keys()), default=1)
        for l in reversed(range(hmax)):
            row = [f"L{l}:"]
            for k in self.keys():
                row.append(f"{k:>4}" if self.nodes[k].height > l else "   .")
            lines.append(" ".join(row))
        return "\n".join(lines)


def _canon_links(height: int, nxt, prv) -> Tuple[int, Tuple, Tuple]:
    """Normalize a node's link state to exactly ``height`` levels (link
    lists from protocol actors may carry trailing lanes after partial
    unlinks; the comparison is over the lanes the node is on)."""
    nx = tuple((list(nxt) + [None] * height)[:height])
    pv = tuple((list(prv) + [None] * height)[:height])
    return height, nx, pv


@dataclass(frozen=True)
class PartitionView:
    """One owner's slice of the partitioned skip list.

    ``nodes``: sorted tuple of ``(key, height, nxt, prv)`` for every
    locally-owned key (HEAD included for its owner); ``boundary``: the
    remote keys local links point at. ``diff`` checks a process's live
    actor state against this oracle slice — the per-process half of the
    epoch-boundary verification."""

    owner: int
    nodes: Tuple[Tuple[int, int, Tuple, Tuple], ...]
    boundary: Tuple[int, ...]

    def keys(self) -> List[int]:
        return [k for k, _, _, _ in self.nodes]

    def diff(self, states: Dict[int, Tuple[int, Tuple, Tuple]]) -> List[str]:
        """Mismatches between this view and ``states`` (key ->
        (height, nxt, prv) extracted from the owner's actors). Empty
        list == the partition agrees with the oracle."""
        out = []
        want = {k: _canon_links(h, nx, pv) for k, h, nx, pv in self.nodes}
        for k in sorted(set(want) | set(states)):
            if k not in want:
                out.append(f"key {k}: present locally, absent in oracle")
            elif k not in states:
                out.append(f"key {k}: in oracle view, absent locally")
            else:
                got = _canon_links(*states[k])
                if got != want[k]:
                    out.append(f"key {k}: local {got} != oracle {want[k]}")
        return out
