"""Phaser topologies compiled to static collective schedules (host side).

The SCSL/SNSL signal flow of the phaser becomes a *static schedule* of
point-to-point rounds. Three interchangeable gradient-sync schedules:

* ``phaser_scsl``        — the paper-faithful topology: reduce up the SCSL
                           signal edges to the head, then diffuse down the
                           SNSL (broadcast). Single-port model: every rank
                           receives at most one message per round, exactly
                           like the protocol's FIFO channels.
* ``recursive_doubling`` — the paper's *creation* exchange [2] reused as an
                           all-reduce: log2(n) XOR-partner rounds.
* ``halving_doubling``   — bandwidth-optimal variant: recursive-halving
                           reduce-scatter + recursive-doubling all-gather.
* ``xla_psum``           — the framework's native all-reduce (baseline;
                           the name is kept so schedule identities match
                           the JAX package's).

Schedules are derived once from the deterministic skip-list oracle; an
elastic epoch boundary swaps them. Every kind is valid for **any** team
size: non-power-of-two teams use the elimination derivations. A
``Schedule`` carries a per-round op: ``"add"`` rounds accumulate at the
destination, ``"copy"`` rounds overwrite.

The device executors run over a ``RankStack``: the team of one epoch
kept as the leading dim of one tensor on one device, the in-process
counterpart of the reference's ``shard_map`` mesh axis (its CPU tests
run the same simulation over host devices). ``lax.ppermute`` becomes
``RankStack.ppermute`` (a rank that is not a destination receives
zeros), ``lax.axis_index`` ``RankStack.axis_index``, and ``lax.psum``
the stacked sum broadcast to every rank. Across host processes
(``runtime_dist``) each process stacks its own ranks here and the
process-level schedule's rounds travel over the runtime's transport, as
in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.bucket_combine import bucket_combine
from .skiplist import HEAD, SkipList


# ---------------------------------------------------------------------------
# Schedule derivation (host side, pure Python).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Schedule:
    """A sequence of ppermute rounds. ``rounds[r]`` = tuple of (src, dst)
    pairs, each a partial permutation (distinct srcs, distinct dsts).

    ``ops[r]`` is the destination combine for round ``r``: ``"add"``
    (reduce into the accumulator) or ``"copy"`` (overwrite — the
    broadcast/hydration direction). An empty ``ops`` means every round
    is ``"add"`` (the pre-existing reduce-only schedules)."""

    n: int
    rounds: Tuple[Tuple[Tuple[int, int], ...], ...]
    kind: str = "generic"
    ops: Tuple[str, ...] = ()

    def op(self, r: int) -> str:
        return self.ops[r] if self.ops else "add"

    @property
    def depth(self) -> int:
        return len(self.rounds)

    @property
    def messages(self) -> int:
        return sum(len(r) for r in self.rounds)

    def check(self) -> None:
        assert not self.ops or len(self.ops) == len(self.rounds), \
            (len(self.ops), len(self.rounds))
        assert all(op in ("add", "copy") for op in self.ops), self.ops
        for r in self.rounds:
            srcs = [s for s, _ in r]
            dsts = [d for _, d in r]
            assert len(set(srcs)) == len(srcs), f"src collision in {r}"
            assert len(set(dsts)) == len(dsts), f"dst collision in {r}"
            assert all(0 <= s < self.n and 0 <= d < self.n
                       for s, d in r)


def _fold_head(sl: SkipList) -> Tuple[Dict[int, int], int]:
    """Map the virtual HEAD onto the lowest participant key (the designated
    head-signaler of the paper is a real task in the data plane)."""
    keys = sl.keys()
    assert keys, "empty topology"
    root = keys[0]
    parent = {}
    for k in keys:
        p = sl.parent(k)
        if k == root:
            continue
        parent[k] = root if p == HEAD else p
    return parent, root


def scsl_reduce_schedule(sl: SkipList, ranks: Sequence[int]) -> Schedule:
    """Single-port greedy schedule for the SCSL reduction (children before
    parent; one receive per device per round)."""
    parent, root = _fold_head(sl)
    rank_of = {k: i for i, k in enumerate(ranks)}
    children: Dict[int, List[int]] = {k: [] for k in list(parent) + [root]}
    for c, p in parent.items():
        children.setdefault(p, []).append(c)
    # critical-path weight: height of subtree below each node
    weight: Dict[int, int] = {}

    def w(k: int) -> int:
        if k not in weight:
            weight[k] = 1 + max((w(c) for c in children.get(k, [])),
                                default=0)
        return weight[k]

    for k in children:
        w(k)

    unsent = set(parent)                      # root never sends
    done_round: Dict[int, int] = {}           # node -> round it sent in
    rounds: List[Tuple[Tuple[int, int], ...]] = []
    r = 0
    while unsent:
        eligible: Dict[int, List[int]] = {}
        for k in unsent:
            if all(c in done_round and done_round[c] < r
                   for c in children.get(k, [])):
                eligible.setdefault(parent[k], []).append(k)
        this_round: List[Tuple[int, int]] = []
        for p, cands in eligible.items():
            # heaviest subtree first: keeps the critical path moving
            k = max(cands, key=lambda c: (weight[c], -c))
            this_round.append((rank_of[k], rank_of[p]))
            done_round[k] = r
            unsent.discard(k)
        assert this_round, "schedule stalled (cycle in signal edges?)"
        rounds.append(tuple(sorted(this_round)))
        r += 1
    sched = Schedule(len(ranks), tuple(rounds), kind="scsl_reduce")
    sched.check()
    return sched


def snsl_broadcast_schedule(sl: SkipList, ranks: Sequence[int]) -> Schedule:
    """Broadcast from the head down the notification edges (reverse SCSL
    edge direction; single-port: one send per holder per round)."""
    parent, root = _fold_head(sl)
    rank_of = {k: i for i, k in enumerate(ranks)}
    children: Dict[int, List[int]] = {}
    for c, p in parent.items():
        children.setdefault(p, []).append(c)
    # deeper subtrees notified first
    weight: Dict[int, int] = {}

    def w(k: int) -> int:
        if k not in weight:
            weight[k] = 1 + max((w(c) for c in children.get(k, [])),
                                default=0)
        return weight[k]

    have = {root}
    todo = set(parent)
    rounds: List[Tuple[Tuple[int, int], ...]] = []
    while todo:
        this_round: List[Tuple[int, int]] = []
        used_senders = set()
        for h in sorted(have):
            if h in used_senders:
                continue
            cands = [c for c in children.get(h, []) if c in todo]
            if not cands:
                continue
            c = max(cands, key=lambda x: (w(x), -x))
            this_round.append((rank_of[h], rank_of[c]))
            used_senders.add(h)
            todo.discard(c)
        assert this_round, "broadcast stalled"
        have |= {ranks[d] for _, d in this_round}
        rounds.append(tuple(sorted(this_round)))
    sched = Schedule(len(ranks), tuple(rounds), kind="snsl_broadcast",
                     ops=("copy",) * len(rounds))
    sched.check()
    return sched


def recursive_doubling_schedule(n: int) -> Schedule:
    """XOR-exchange all-reduce rounds (the paper's creation algorithm [2]).

    Power-of-two teams run the pure hypercube exchange. Any other team
    size gets the rank-elimination derivation (the whole-buffer member of
    the Rabenseifner-Träff elimination family, the same fold the creation
    exchange uses in ``core/creation.py``): the ``r = n - 2^k`` extras
    fold their contribution into their hypercube images (one ``add``
    round), the 2^k core runs the XOR exchange, and one final ``copy``
    round re-hydrates the extras with the total. Latency is
    ``log2(2^k) + 2`` rounds instead of falling back to ``phaser_scsl``.
    """
    assert n >= 1, n
    k = 1 << (n.bit_length() - 1)           # largest power of two <= n
    r = n - k
    rounds: List[Tuple[Tuple[int, int], ...]] = []
    ops: List[str] = []
    if r:
        rounds.append(tuple(sorted((k + i, i) for i in range(r))))
        ops.append("add")
    stride = 1
    while stride < k:
        rounds.append(tuple(sorted((i, i ^ stride) for i in range(k))))
        ops.append("add")
        stride *= 2
    if r:
        rounds.append(tuple(sorted((i, k + i) for i in range(r))))
        ops.append("copy")
    sched = Schedule(n, tuple(rounds), kind="recursive_doubling",
                     ops=tuple(ops))
    sched.check()
    return sched


# ---------------------------------------------------------------------------
# Device executors over a stacked team (the reference runs them inside
# shard_map over ``axis_name``).
# ---------------------------------------------------------------------------
def _dst_mask(n: int, round_pairs: Sequence[Tuple[int, int]]):
    m = np.zeros((n,), dtype=np.bool_)
    for _, d in round_pairs:
        m[d] = True
    return m


class RankStack:
    """The ``n`` ranks of one epoch's team as the leading dim of tensors
    on ``device``: row ``r`` of a stacked tensor is rank ``r``'s value.

    Per-round gate vectors live on the device and are built once per
    round's pairs, so executing a schedule reads nothing back to the
    host."""

    def __init__(self, n: int, device="cuda"):
        assert n >= 1, n
        self.n = n
        self.device = torch.device(device)
        self._gates: Dict[Tuple[Tuple[int, int], ...], torch.Tensor] = {}
        self._index = torch.arange(n, device=self.device)

    def axis_index(self, ndim: int = 1) -> torch.Tensor:
        """(n, 1, ...) rank indices, broadcastable against a stacked
        tensor of ``ndim`` dims."""
        return self._index.reshape((self.n,) + (1,) * (ndim - 1))

    def gate(self, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """(n,) int32 on the device: 1 where the rank is a destination
        of the round."""
        key = tuple(pairs)
        g = self._gates.get(key)
        if g is None:
            g = torch.tensor(_dst_mask(self.n, key).astype(np.int32),
                             device=self.device)
            self._gates[key] = g
        return g

    def ppermute(self, x: torch.Tensor,
                 pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute`` over the stacked dim: ``y[dst] = x[src]`` for
        each pair; a rank that is no destination receives zeros. One
        device copy per pair (a partial permutation), no gathered
        temporary."""
        assert x.shape[0] == self.n, (x.shape, self.n)
        y = torch.empty_like(x)
        dsts = set()
        for s, d in pairs:
            y[d].copy_(x[s])
            dsts.add(d)
        for r in range(self.n):
            if r not in dsts:
                y[r].zero_()
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.psum``: the stacked sum, every rank holding it."""
        return x.sum(0, keepdim=True).expand_as(x).contiguous()


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as ``(n, rows, cols)`` with each rank's block contiguous,
    the operand layout of ``bucket_combine``: a stacked bucket buffer
    (or a readiness group's view of one) as it is, anything else as one
    row per rank."""
    if x.ndim == 3 and x.stride(-1) == 1 and x.stride(-2) == x.shape[-1]:
        return x
    return x.reshape(x.shape[0], 1, -1)


def schedule_allreduce(x: torch.Tensor, stack: RankStack,
                       sched: Schedule) -> torch.Tensor:
    """Execute any round ``Schedule`` over the stacked ranks ``x``
    (``(n, ...)``): per round, the destinations of the partial
    permutation either accumulate (``add``) or overwrite (``copy``) the
    incoming value; everyone else keeps their accumulator. Each round's
    combine is one ``bucket_combine`` call covering every rank (the
    kernel on the card, its plain version on the CPU)."""
    acc = _as_rows(x)
    for r, pairs in enumerate(sched.rounds):
        y = stack.ppermute(acc, pairs)
        acc = bucket_combine(acc, y, stack.gate(pairs), op=sched.op(r))
    return acc.reshape(x.shape)


def scsl_allreduce(x: torch.Tensor, stack: RankStack, up: Schedule,
                   down: Schedule) -> torch.Tensor:
    """All-reduce(+) with the phaser SCSL/SNSL schedules: reduce up the
    signal-collection edges, broadcast down the notification edges."""
    uni = Schedule(up.n, up.rounds + down.rounds, kind="phaser_scsl",
                   ops=("add",) * up.depth + ("copy",) * down.depth)
    return schedule_allreduce(x, stack, uni)


def halving_doubling_allreduce(x: torch.Tensor, stack: RankStack,
                               n: int) -> torch.Tensor:
    """Bandwidth-optimal all-reduce over the stacked ranks ``x``
    (``(n, ...)``): recursive-halving reduce-scatter then recursive-
    doubling all-gather over the 2^k core. The ``r = n - 2^k`` extras
    are retired by a vector-halving 2-1 elimination pre-phase and
    re-hydrated with one full-sized copy at the end. Relies on
    ``ppermute`` giving zeros to non-destinations (the extras idle
    through the core's rounds)."""
    if n == 1:
        return x
    k = 1 << (n.bit_length() - 1)           # largest power of two <= n
    r = n - k
    flat = x.reshape(n, -1)
    orig_size = flat.shape[1]
    pad = (-orig_size) % (2 * k)            # even halves at every depth
    if pad:
        flat = torch.cat([flat, flat.new_zeros((n, pad))], dim=1)
    size = flat.shape[1]
    idx = stack.axis_index(2)
    acc = flat
    if r:
        # 2-1 elimination: extra k+i <-> core i swap opposite halves.
        half = size // 2
        lo, hi = acc[:, :half], acc[:, half:]
        is_extra = idx >= k
        has_extra = idx < r
        pairs1 = ([(k + i, i) for i in range(r)]
                  + [(i, k + i) for i in range(r)])
        send1 = torch.where(is_extra, lo, hi)
        got1 = stack.ppermute(send1, pairs1)
        lo = torch.where(has_extra, lo + got1, lo)  # core reduces low half
        hi = torch.where(is_extra, hi + got1, hi)   # extra reduces high half
        got2 = stack.ppermute(hi, [(k + i, i) for i in range(r)])
        hi = torch.where(has_extra, got2, hi)       # extra hands it back
        acc = torch.cat([lo, hi], dim=1)
    # reduce-scatter among the core: after each round a rank owns half
    stride = k // 2
    width = size
    while stride >= 1:
        pairs = [(i, i ^ stride) for i in range(k)]
        keep_low = (idx // stride) % 2 == 0     # low-half keeper this round
        half = width // 2
        low, high = acc[:, :half], acc[:, half:]
        tosend = torch.where(keep_low, high, low)
        keep = torch.where(keep_low, low, high)
        got = stack.ppermute(tosend, pairs)
        acc = keep + got
        width = half
        stride //= 2
    # all-gather back up (doubling)
    stride = 1
    while stride < k:
        pairs = [(i, i ^ stride) for i in range(k)]
        got = stack.ppermute(acc, pairs)
        keep_low = (idx // stride) % 2 == 0
        acc = torch.where(keep_low, torch.cat([acc, got], dim=1),
                          torch.cat([got, acc], dim=1))
        stride *= 2
    if r:
        # re-hydrate the eliminated extras with the full result
        got3 = stack.ppermute(acc, [(i, k + i) for i in range(r)])
        acc = torch.where(idx >= k, got3, acc)
    return acc[:, :orig_size].reshape(x.shape)


# ---------------------------------------------------------------------------
# Host-side reference execution.
# ---------------------------------------------------------------------------


def simulate_schedule(sched: Schedule, xs: Sequence[np.ndarray]
                      ) -> List[np.ndarray]:
    """Host-side reference execution of a round schedule (one value per
    rank): the semantics every device executor must reproduce."""
    assert len(xs) == sched.n, (len(xs), sched.n)
    vals = [np.asarray(x, dtype=np.float64) for x in xs]
    for r, pairs in enumerate(sched.rounds):
        incoming = {d: vals[s] for s, d in pairs}
        if sched.op(r) == "add":
            vals = [vals[i] + incoming[i] if i in incoming else vals[i]
                    for i in range(sched.n)]
        else:
            vals = [incoming.get(i, vals[i]) for i in range(sched.n)]
    return vals


ALLREDUCE_KINDS = ("xla_psum", "phaser_scsl", "recursive_doubling",
                   "halving_doubling")


@dataclass
class PhaserCollective:
    """Bundle: phaser topology over a mesh axis + selected schedule.

    ``kind``:
      xla_psum | phaser_scsl | recursive_doubling | halving_doubling

    ``keys``: the participant keys of the phaser topology. Defaults to
    ``range(n)`` (a fresh team); an elastic runtime passes the *live* key
    set after churn, so the schedule is re-derived from the exact skip
    list the protocol actors converged to (heights are a deterministic
    function of the key, so survivors keep their lanes). Mesh rank i
    executes the role of ``sorted(keys)[i]``.

    ``leaf_keys``: demoted (straggler) keys pinned to height 1 — leaves
    of the SCSL reduce tree with the fewest dependents. Part of the
    topology identity: the oracle, the fingerprint and the program-cache
    key all carry it.
    """

    n: int
    axis_name: str
    kind: str = "xla_psum"
    p: float = 0.5
    seed: int = 0
    keys: Optional[Tuple[int, ...]] = None
    leaf_keys: Tuple[int, ...] = ()
    up: Optional[Schedule] = None
    down: Optional[Schedule] = None
    rd: Optional[Schedule] = None

    def __post_init__(self):
        assert self.kind in ALLREDUCE_KINDS, self.kind
        if self.keys is None:
            self.keys = tuple(range(self.n))
        else:
            self.keys = tuple(sorted(self.keys))
        assert len(self.keys) == self.n, (self.n, self.keys)
        self.leaf_keys = tuple(sorted(set(self.leaf_keys)
                                      & set(self.keys)))
        if self.kind == "phaser_scsl":
            sl = SkipList.build(self.keys, p=self.p, seed=self.seed,
                                leaf_keys=self.leaf_keys)
            self.up = scsl_reduce_schedule(sl, list(self.keys))
            self.down = snsl_broadcast_schedule(sl, list(self.keys))
        elif self.kind == "recursive_doubling":
            self.rd = recursive_doubling_schedule(self.n)

    def unified_schedule(self) -> Optional[Schedule]:
        """The single round schedule the execution engine compiles:
        reduce-up + copy-down for ``phaser_scsl``, the (possibly
        elimination-extended) XOR exchange for ``recursive_doubling``.
        ``None`` for the kinds that are not whole-buffer round schedules
        (``xla_psum`` is native; ``halving_doubling`` is segment-level)."""
        if self.kind == "phaser_scsl":
            return Schedule(self.n, self.up.rounds + self.down.rounds,
                            kind="phaser_scsl",
                            ops=("add",) * self.up.depth
                            + ("copy",) * self.down.depth)
        if self.kind == "recursive_doubling":
            return self.rd
        return None

    def all_reduce(self, x: torch.Tensor, stack: RankStack) -> torch.Tensor:
        """All-reduce the stacked ranks ``x`` (``(n, ...)``) with this
        collective's schedule; every rank ends with the sum."""
        assert stack.n == self.n, (stack.n, self.n)
        if self.kind == "xla_psum":
            return stack.psum(x)
        if self.kind == "halving_doubling":
            return halving_doubling_allreduce(x, stack, self.n)
        return schedule_allreduce(x, stack, self.unified_schedule())

    def pmean(self, x: torch.Tensor, stack: RankStack) -> torch.Tensor:
        return self.all_reduce(x, stack) / self.n

    # --- introspection / roofline ------------------------------------------
    def stats(self) -> Dict[str, int]:
        if self.kind == "phaser_scsl":
            return {"rounds": self.up.depth + self.down.depth,
                    "messages": self.up.messages + self.down.messages}
        if self.kind == "recursive_doubling":
            return {"rounds": self.rd.depth, "messages": self.rd.messages}
        if self.kind == "halving_doubling":
            k = 1 << (self.n.bit_length() - 1)
            r = self.n - k
            lg = int(math.log2(k)) if k > 1 else 0
            # core: lg rounds each way; elimination: 2 pre + 1 hydrate
            return {"rounds": 2 * lg + (3 if r else 0),
                    "messages": 2 * lg * k + 4 * r}
        return {"rounds": 1, "messages": self.n}

    # --- host-side execution -----------------------------------------------
    def simulate_allreduce(self, xs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Execute the schedule on host numpy values, one per mesh rank.

        This is the data plane of the *simulated* cluster (the same role
        a point-to-point send plays on a real mesh): the elastic trainer uses
        it to sync per-worker gradients through the exact per-epoch
        schedule, and tests use it to prove every schedule computes the
        same sum as a direct reduction.
        """
        assert len(xs) == self.n, (len(xs), self.n)
        vals = [np.asarray(x, dtype=np.float64) for x in xs]
        if self.kind == "xla_psum":
            total = sum(vals)
            return [total.copy() for _ in range(self.n)]
        if self.kind in ("phaser_scsl", "recursive_doubling"):
            return simulate_schedule(self.unified_schedule(), vals)
        if self.kind == "halving_doubling":
            # mirror halving_doubling_allreduce round for round: 2-1
            # elimination pre-phase (non-pow2), recursive-halving
            # reduce-scatter, doubling all-gather, extra re-hydration
            n = self.n
            if n == 1:
                return [v.copy() for v in vals]
            k = 1 << (n.bit_length() - 1)
            r = n - k
            shape = vals[0].shape
            flat = [v.ravel() for v in vals]
            orig = flat[0].size
            pad = (-orig) % (2 * k)
            acc = [np.concatenate([f, np.zeros((pad,))]) if pad
                   else f.copy() for f in flat]
            size = acc[0].size
            if r:
                half = size // 2
                nxt = [a.copy() for a in acc]
                for i in range(r):
                    e = k + i
                    nxt[i][:half] = acc[i][:half] + acc[e][:half]
                    nxt[e][half:] = acc[e][half:] + acc[i][half:]
                acc = nxt
                for i in range(r):              # extra returns its half
                    acc[i][half:] = acc[k + i][half:]
            width = size
            stride = k // 2
            while stride >= 1:
                half = width // 2
                nxt = []
                for i in range(n):
                    keep_low = (i // stride) % 2 == 0
                    keep = acc[i][:half] if keep_low else acc[i][half:]
                    if i < k:                   # extras idle (masked out)
                        j = i ^ stride
                        sent = (acc[j][half:] if (j // stride) % 2 == 0
                                else acc[j][:half])
                    else:
                        sent = np.zeros((half,))
                    nxt.append(keep + sent)
                acc = nxt
                width = half
                stride //= 2
            stride = 1
            while stride < k:
                nxt = []
                for i in range(n):
                    keep_low = (i // stride) % 2 == 0
                    got = (acc[i ^ stride] if i < k
                           else np.zeros_like(acc[i]))
                    nxt.append(np.concatenate([acc[i], got]) if keep_low
                               else np.concatenate([got, acc[i]]))
                acc = nxt
                stride *= 2
            for i in range(r):                  # hydrate the extras
                acc[k + i] = acc[i].copy()
            return [a[:orig].reshape(shape) for a in acc]
        raise ValueError(self.kind)

    def schedule_fingerprint(self) -> Tuple:
        """Hashable identity of the compiled schedule: changes exactly
        when the topology (live keys / kind) changes — the re-lower key
        for the elastic runtime's epoch swap."""
        if self.kind == "phaser_scsl":
            return (self.kind, self.keys, self.leaf_keys,
                    self.up.rounds, self.down.rounds)
        if self.kind == "recursive_doubling":
            return (self.kind, self.keys, self.rd.rounds, self.rd.ops)
        return (self.kind, self.keys)

    def matches_oracle(self) -> bool:
        """Re-derive the schedule from a fresh deterministic skip-list
        oracle over ``keys`` (demoted keys pinned to leaves) and compare
        structurally (the elastic epoch-swap correctness check)."""
        if self.kind != "phaser_scsl":
            return True
        sl = SkipList.build(self.keys, p=self.p, seed=self.seed,
                            leaf_keys=self.leaf_keys)
        return (self.up == scsl_reduce_schedule(sl, list(self.keys))
                and self.down == snsl_broadcast_schedule(sl,
                                                         list(self.keys)))

