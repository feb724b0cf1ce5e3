"""1F1B and interleaved pipeline schedules derived from the
point-to-point phase ordering.

A pipeline of S stages over M microbatches is the phaser graph of
``core/p2p.py``: forward edge phasers (c, c+1) carry activations (chunk
c SIG, chunk c+1 WAIT), backward edge phasers (c+1, c) carry cotangents.
``F(c, m)`` signals fwd phase m after waiting on fwd phase m of the
predecessor edge; ``B(c, m)`` signals bwd phase m after waiting on bwd
phase m of the successor edge (and, at the last chunk, on its own
``F`` — a local dependency, no phaser needed).

The schedule is organized in **waves** — global ticks where every active
stage executes the same instruction kind (the SPMD-uniform shape the
compiled program needs). With ``interleave = v`` **virtual stages per
device** (Megatron-style looping placement), the model splits into
``S*v`` chunks and device s owns the NON-contiguous chunks
``s, s+S, ..., s+(v-1)S`` — consecutive chunks always sit on
neighbouring devices (mod S), so per-wave handoffs stay single
``ppermute`` hops. Device s's local F index ``r = f - s`` maps to

* chunk group ``j = (r // S) % v`` (breadth-first chunk rotation:
  S microbatches flow through chunk group j before the device rotates
  to group j+1 — the rotation period S is what lets microbatch 0 reach
  chunk group j+1 exactly when the device finishes group j's round),
* microbatch ``m = (r // (S*v))*S + r % S``  (requires ``M % S == 0``
  for v > 1, as in Megatron's interleaved schedule),

and the backward mirrors it with ``j`` reversed. The wave order is the
same 1F1B interleaving as the plain schedule — ``S*v`` warmup forward
waves, then strict B/F alternation, then the backward tail — because
``B_0`` (last chunk, microbatch 0) needs exactly ``F_{S*v-1}``.

**Why interleave**: the plain 1F1B bubble is 2(S-1) waves of FULL-stage
compute; interleaved waves each do 1/v of a stage, so the fill/drain
cost drops to 2(S-1) *thin* waves — the bubble fraction falls from
``(S-1)/(M+S-1)`` to ``(S-1)/(vM+S-1)``, a factor-v cut at small M (the
dominant regime in BENCH_pipeline.json). The price is in-flight
activations: chunk (s, j) parks at most
``min(M, 2(S-1-s)+1 + (v-1-j)*S)`` live forward activations (proved in
``check()``; for v=1 this is exactly the wave-synchronous bound
``min(M, 2(S-1-s)+1)`` — each individual chunk stays under the
*expanded-graph* wave-synchronous bound ``min(vM, 2(Sv-1-c)+1)``, which
is what "tighter per-chunk in-flight" means here), and the live
microbatch indices per chunk are CONSECUTIVE, so the compiled program's
per-chunk parked-activation rings stay collision-free under modular
indexing (``ring_slots``).

``derive_interleaved`` constructs the schedule (``derive_1f1b`` is the
v=1 case); ``check()`` proves dependency validity, the steady-state F/B
alternation and the per-chunk in-flight bounds; ``as_program()``
linearizes the waves into the p2p instruction stream over the S·v-node
chunk graph; ``verify_phase_order`` drives that stream through the REAL
protocol actors and asserts the observed release order equals the host
counter oracle (``simulate_program``) — the per-epoch proof the example
and tests run (arXiv:1606.05937's notion of a legal phaser execution:
any linearization the counter oracle admits).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core.p2p import Edge, Op, PipelinePhaserGraph, simulate_program


def pipeline_edges(n_chunks: int) -> Tuple[Edge, ...]:
    """Forward activation edges then backward cotangent edges over the
    chunk graph (``n_chunks = S * interleave`` virtual stages)."""
    fwd = [(c, c + 1) for c in range(n_chunks - 1)]
    bwd = [(c + 1, c) for c in range(n_chunks - 1)]
    return tuple(fwd + bwd)


@dataclass(frozen=True)
class PipelineSchedule:
    """A wave-ordered (possibly interleaved) 1F1B schedule. ``waves[t]``
    is ``("F", f)`` or ``("B", b)`` — at tick t every stage s executes
    that wave's instruction for its own (chunk group, microbatch) item
    (or idles outside its range)."""

    n_stages: int
    n_microbatches: int
    waves: Tuple[Tuple[str, int], ...]
    interleave: int = 1

    @property
    def n_waves(self) -> int:
        return len(self.waves)

    @property
    def n_chunks(self) -> int:
        return self.n_stages * self.interleave

    def chunk_of(self, stage: int, group: int) -> int:
        """Virtual-stage (chunk) index of device ``stage``'s chunk
        group ``group`` — the looping placement c = group*S + stage."""
        return group * self.n_stages + stage

    # ------------------------------------------------------------ items
    def _item(self, r: int) -> Optional[Tuple[int, int]]:
        """Local instruction index r -> (chunk group, microbatch)."""
        S, M, v = self.n_stages, self.n_microbatches, self.interleave
        if not 0 <= r < v * M:
            return None
        j = (r // S) % v
        m = (r // (S * v)) * S + r % S
        return j, m

    def fwd_item(self, wave: int, stage: int) -> Optional[Tuple[int, int]]:
        return self._item(wave - stage)

    def bwd_item(self, wave: int, stage: int) -> Optional[Tuple[int, int]]:
        it = self._item(wave - (self.n_stages - 1 - stage))
        if it is None:
            return None
        j, m = it
        return self.interleave - 1 - j, m

    def fwd_mb(self, wave: int, stage: int) -> Optional[int]:
        """v=1 compatibility view: the wave's microbatch index."""
        assert self.interleave == 1
        it = self.fwd_item(wave, stage)
        return None if it is None else it[1]

    def bwd_mb(self, wave: int, stage: int) -> Optional[int]:
        assert self.interleave == 1
        it = self.bwd_item(wave, stage)
        return None if it is None else it[1]

    def chunk_stream(self, stage: int) -> List[Tuple[str, int, int]]:
        """The stage's own instruction sequence in wave order:
        (kind, chunk group, microbatch) triples."""
        out = []
        for kind, w in self.waves:
            it = (self.fwd_item(w, stage) if kind == "F"
                  else self.bwd_item(w, stage))
            if it is not None:
                out.append((kind, it[0], it[1]))
        return out

    def stage_stream(self, stage: int) -> List[Tuple[str, int]]:
        """v=1 view: the stage's (kind, microbatch) sequence."""
        assert self.interleave == 1
        return [(k, m) for k, _, m in self.chunk_stream(stage)]

    # --------------------------------------------------------- analysis
    def chunk_inflight(self) -> Dict[Tuple[int, int], Tuple[int, int]]:
        """(stage, chunk group) -> (peak live forward activations,
        max live microbatch-index span). The span bounds the ring size a
        compiled program needs for that chunk's parked activations."""
        out = {}
        for s in range(self.n_stages):
            live: Dict[int, set] = {j: set()
                                    for j in range(self.interleave)}
            peak = {j: 0 for j in range(self.interleave)}
            span = {j: 0 for j in range(self.interleave)}
            for kind, j, m in self.chunk_stream(s):
                if kind == "F":
                    live[j].add(m)
                    peak[j] = max(peak[j], len(live[j]))
                    span[j] = max(span[j],
                                  max(live[j]) - min(live[j]) + 1)
                else:
                    live[j].discard(m)
            for j in range(self.interleave):
                out[(s, j)] = (peak[j], span[j])
        return out

    def inflight_bound(self, stage: int, group: int) -> int:
        """The per-chunk in-flight cap ``check()`` proves:
        min(M, 2(S-1-s)+1 + (v-1-j)S). For v=1 this is the
        wave-synchronous 1F1B bound; every chunk stays under the
        expanded-graph wave-synchronous cap min(vM, 2(Sv-1-c)+1)."""
        S, v = self.n_stages, self.interleave
        return min(self.n_microbatches,
                   2 * (S - 1 - stage) + 1 + (v - 1 - group) * S)

    @property
    def ring_slots(self) -> int:
        """Parked-activation ring size per chunk: the max live
        microbatch span over every (stage, chunk group) — live indices
        per chunk are consecutive, so modular indexing into a ring of
        this size is collision-free (asserted in ``check()``)."""
        return max((sp for _, sp in self.chunk_inflight().values()),
                   default=1)

    def bubble_fraction(self) -> float:
        """Idle fraction of the wave schedule: (S-1)/(vM+S-1) — the
        fill/drain waves over the total. Interleaving divides the plain
        1F1B fraction (S-1)/(M+S-1) by ~v at small M because each
        interleaved wave computes 1/v of a stage."""
        S, M, v = self.n_stages, self.n_microbatches, self.interleave
        return (S - 1) / (v * M + S - 1)

    # ------------------------------------------------------------ validity
    def check(self) -> None:
        S, M, v = self.n_stages, self.n_microbatches, self.interleave
        assert v == 1 or M % S == 0, \
            f"interleave={v} needs M % S == 0, got M={M}, S={S}"
        nf = v * M + S - 1
        assert sorted(w for k, w in self.waves if k == "F") == list(range(nf))
        assert sorted(w for k, w in self.waves if k == "B") == list(range(nf))
        done: Dict[Tuple[str, int, int], int] = {}
        for t, (kind, w) in enumerate(self.waves):
            for s in range(S):
                if kind == "F":
                    it = self.fwd_item(w, s)
                    if it is None:
                        continue
                    j, m = it
                    c = self.chunk_of(s, j)
                    if c > 0:
                        # activation from the predecessor chunk's F,
                        # strictly earlier wave
                        assert done.get(("F", c - 1, m), t) < t, (t, c, m)
                    done[("F", c, m)] = t
                else:
                    it = self.bwd_item(w, s)
                    if it is None:
                        continue
                    j, m = it
                    c = self.chunk_of(s, j)
                    # own forward must have run (vjp recompute input)
                    assert done.get(("F", c, m), t) < t, (t, c, m)
                    if c < self.n_chunks - 1:
                        # cotangent from the successor chunk's B
                        assert done.get(("B", c + 1, m), t) < t, (t, c, m)
                    done[("B", c, m)] = t
        assert len(done) == 2 * self.n_chunks * M
        # per-chunk in-flight bound + ring contiguity + steady-state F/B
        # alternation: after its first backward a stage never runs two
        # forwards back to back (the 1F1B property); the warmup forward
        # run is capped by the total in-flight bound S(v-1)+2(S-1-s)+1.
        inflight = self.chunk_inflight()
        for s in range(S):
            for j in range(v):
                peak, span = inflight[(s, j)]
                bound = self.inflight_bound(s, j)
                assert peak <= bound, (s, j, peak, bound)
                # live microbatches stay consecutive: the ring of
                # ``ring_slots`` is collision-free under m % ring
                assert span <= bound, (s, j, span, bound)
            run = 0
            seen_b = False
            warm = min(v * M, S * (v - 1) + 2 * (S - 1 - s) + 1)
            for kind, j, m in self.chunk_stream(s):
                if kind == "F":
                    run += 1
                    assert run <= (1 if seen_b else warm), (s, run)
                else:
                    run = 0
                    seen_b = True

    # ----------------------------------------------------- p2p linearization
    def as_program(self) -> List[Op]:
        """The wave schedule as a p2p instruction stream over the chunk
        graph: each F/B wave emits its chunks' wait/signal ops in
        dependency order (ascending chunk for F — a chunk's input was
        signaled a wave earlier; descending for B)."""
        Vc = self.n_chunks
        ops: List[Op] = []
        for kind, w in self.waves:
            items = []                   # (chunk, microbatch) this wave
            for s in range(self.n_stages):
                it = (self.fwd_item(w, s) if kind == "F"
                      else self.bwd_item(w, s))
                if it is not None:
                    items.append((self.chunk_of(s, it[0]), it[1]))
            for c, m in sorted(items, reverse=(kind == "B")):
                if kind == "F":
                    if c > 0:
                        ops.append(("wait", (c - 1, c), m))
                    if c < Vc - 1:
                        ops.append(("signal", (c, c + 1)))
                else:
                    if c < Vc - 1:
                        ops.append(("wait", (c + 1, c), m))
                    if c > 0:
                        ops.append(("signal", (c, c - 1)))
        return ops

    def fingerprint(self) -> Tuple:
        return (self.n_stages, self.n_microbatches, self.interleave,
                self.waves)


def derive_interleaved(n_stages: int, n_microbatches: int,
                       interleave: int = 1) -> PipelineSchedule:
    """The interleaved 1F1B wave order: S·v warmup forward waves (the
    first backward — last chunk, microbatch 0 — needs exactly
    F_{Sv-1}), then strict B/F alternation, then the cooldown backward
    tail. For v=1 this is the canonical wave-synchronous 1F1B."""
    S, M, v = n_stages, n_microbatches, interleave
    assert S >= 1 and M >= 1 and v >= 1, (S, M, v)
    assert v == 1 or M % S == 0, \
        f"interleave={v} needs M % S == 0 (chunk rotation period), " \
        f"got M={M}, S={S}"
    nf = v * M + S - 1
    warm = min(S * v, nf)
    waves: List[Tuple[str, int]] = [("F", f) for f in range(warm)]
    b = 0
    for f in range(warm, nf):
        waves.append(("B", b))
        waves.append(("F", f))
        b += 1
    waves.extend(("B", bb) for bb in range(b, nf))
    sched = PipelineSchedule(S, M, tuple(waves), interleave=v)
    sched.check()
    return sched


def derive_1f1b(n_stages: int, n_microbatches: int) -> PipelineSchedule:
    """The canonical non-interleaved 1F1B wave order: S warmup forward
    waves, then strict B/F alternation, then the cooldown backward tail."""
    return derive_interleaved(n_stages, n_microbatches, 1)


def verify_phase_order(sched: PipelineSchedule, *,
                       seed: int = 0) -> Dict[str, int]:
    """Prove the schedule against the point-to-point protocol: drive its
    instruction stream through real phaser actors (one per chunk-graph
    edge, SIG/WAIT modes) and assert (1) every wait is already satisfied
    when reached, (2) the observed global release order equals the host
    counter oracle's, and (3) each edge phaser's converged SCSL/SNSL
    match the mode-filtered skip-list oracle. Returns protocol stats."""
    if sched.n_chunks == 1:
        return {"edges": 0, "messages": 0, "releases": 0}
    edges = pipeline_edges(sched.n_chunks)
    prog = sched.as_program()
    g = PipelinePhaserGraph(sched.n_chunks, edges, seed=seed)
    got = g.run_program(prog)
    want = simulate_program(edges, prog)
    assert [(e.edge, e.phase) for e in got] == \
        [(e.edge, e.phase) for e in want], "release order diverged"
    g.verify_topologies()
    return g.stats()
