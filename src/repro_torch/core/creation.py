"""Phaser creation: recursive-doubling collective build of the SCSL/SNSL.

The paper builds the skip lists at phaser-creation time with the log(n)
recursive-doubling algorithm of Egecioglu, Koc & Laub [2] *without
wrap-around*: in round r (r = 0..ceil(log2 n)-1) every task i exchanges its
accumulated knowledge with its hypercube neighbor i XOR 2^r (when that
neighbor exists; no wrap-around). After ceil(log2 n) rounds every task knows
the (key, height) table of the whole team and derives its own links locally
— zero additional communication, identical structure on every rank.

This module simulates that exchange faithfully (message/round accounting
included) and verifies convergence to the sequential oracle
(``skiplist.SkipList``). The data-plane analog — the same exchange pattern
as a ppermute schedule — lives in ``core/collective.py`` as
``recursive_doubling_schedule``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .skiplist import HEAD, SkipList, det_height


@dataclass
class CreationStats:
    n: int
    rounds: int
    messages: int
    bytes_exchanged: int  # table entries exchanged (8B keys + 1B heights)


def recursive_doubling_build(
    keys: List[int], *, p: float = 0.5, max_height: int = 32, seed: int = 0,
    phaser_id: int = 0,
) -> Tuple[Dict[int, SkipList], CreationStats]:
    """Run the log-n recursive-doubling exchange among ``keys``.

    Returns ({rank: locally derived SkipList}, stats). Every local structure
    is identical (asserted by tests) and equals the sequential oracle.
    """
    n = len(keys)
    order = sorted(keys)
    # knowledge[i] = set of (key, height) pairs task at position i knows
    heights = {k: det_height(k, p=p, max_height=max_height, seed=seed,
                             phaser_id=phaser_id) for k in order}
    knowledge: List[Dict[int, int]] = [{k: heights[k]} for k in order]

    # Non-power-of-2 teams: fold the ``extras`` (positions >= m, the largest
    # power of two <= n) into their hypercube images, run the pure XOR
    # exchange on the 2^k core, then unfold — the standard no-wrap-around
    # completion of recursive doubling (adds <= 2 rounds, stays O(log n)).
    messages = 0
    entries = 0
    rounds = 0
    m = 1 << (n.bit_length() - 1)   # largest power of two <= n
    extras = n - m
    if extras:
        rounds += 1
        for i in range(m, n):
            messages += 1
            entries += len(knowledge[i])
            knowledge[i - m].update(knowledge[i])
    core_rounds = int(math.log2(m)) if m > 1 else 0
    for r in range(core_rounds):
        stride = 1 << r
        rounds += 1
        updates: List[Optional[Dict[int, int]]] = [None] * m
        for i in range(m):
            j = i ^ stride
            messages += 1          # i -> j (each direction counted once)
            entries += len(knowledge[i])
            merged = dict(knowledge[j])
            merged.update(knowledge[i])
            updates[j] = merged
        for i in range(m):
            if updates[i] is not None:
                knowledge[i] = updates[i]
    if extras:
        rounds += 1
        for i in range(m, n):
            messages += 1
            entries += len(knowledge[i - m])
            knowledge[i] = dict(knowledge[i - m])

    # Each rank derives the full structure locally from its table.
    locals_: Dict[int, SkipList] = {}
    for i, k in enumerate(order):
        assert len(knowledge[i]) == n, (
            f"rank {k} knows {len(knowledge[i])}/{n} after {rounds} rounds")
        sl = SkipList(p=p, max_height=max_height, seed=seed,
                      phaser_id=phaser_id)
        for kk in sorted(knowledge[i]):
            sl.insert(kk, height=knowledge[i][kk])
        locals_[k] = sl
    stats = CreationStats(n=n, rounds=rounds, messages=messages,
                          bytes_exchanged=entries * 9)
    return locals_, stats


def verify_creation(n: int, **kw) -> CreationStats:
    """Build collectively, check all ranks converge to the oracle."""
    keys = list(range(n))
    locals_, stats = recursive_doubling_build(keys, **kw)
    oracle = SkipList.build(keys, **kw)
    oracle_edges = oracle.collection_edges()
    for rank, sl in locals_.items():
        assert sl.collection_edges() == oracle_edges, f"rank {rank} diverged"
        sl.check_integrity()
    return stats
