"""The port's copy of the paper's protocol layer against the JAX package:
recursive-doubling creation, the explicit-state model checker with
message-class decomposition, the §3 bounds, the SIG/WAIT point-to-point
phasers and their pipeline graphs, the 1F1B schedules, and the
``ElasticController`` facade. Each case runs the same inputs through
``repro.*`` and ``repro_torch.*`` and asks for equal results: stats,
link tables, explored-state counts, verdicts, release orders, waves.
All of it is pure Python, so equal means equal (floats of the bounds
and fits included)."""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import complexity as ref_cx
from repro.core import modelcheck as ref_mc
from repro.core import p2p as ref_p2p
from repro.core.creation import recursive_doubling_build as ref_build
from repro.core.creation import verify_creation as ref_verify_creation
from repro.core.phaser import SIG_MODE as REF_SIG
from repro.core.phaser import SIG_WAIT as REF_SIG_WAIT
from repro.core.phaser import WAIT_MODE as REF_WAIT
from repro.pipeline_exec import derive_interleaved as ref_derive
from repro.pipeline_exec import pipeline_edges as ref_edges
from repro.pipeline_exec import verify_phase_order as ref_verify_order
from repro.runtime_elastic import ElasticController as RefController
from repro_torch.core import complexity as cx
from repro_torch.core import modelcheck as mc
from repro_torch.core import p2p
from repro_torch.core.creation import (recursive_doubling_build,
                                       verify_creation)
from repro_torch.core.phaser import SIG_MODE, SIG_WAIT, WAIT_MODE
from repro_torch.core.skiplist import SkipList
from repro_torch.pipeline_exec import (derive_1f1b, derive_interleaved,
                                       pipeline_edges, verify_phase_order)
from repro_torch.runtime_elastic import ElasticController


# ------------------------------------------------------------- creation
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 16, 33, 64])
def test_creation_matches_reference(n):
    """Equal ``CreationStats`` and, on every rank, the link table the
    reference derives (which is the sequential oracle's)."""
    got = verify_creation(n)
    want = ref_verify_creation(n)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    lg = math.ceil(math.log2(n)) if n > 1 else 0
    assert got.rounds <= lg + 2
    locals_, stats = recursive_doubling_build(list(range(n)), seed=4)
    ref_locals, ref_stats = ref_build(list(range(n)), seed=4)
    assert dataclasses.asdict(stats) == dataclasses.asdict(ref_stats)
    assert sorted(locals_) == sorted(ref_locals)
    oracle = SkipList.build(list(range(n)), seed=4).collection_edges()
    for r, sl in locals_.items():
        assert sl.collection_edges() == ref_locals[r].collection_edges() \
            == oracle, r


# -------------------------------------------------------- model checker
def _stats(res):
    return [dataclasses.asdict(s) for s in res]


SCENARIOS = {
    "eager_insert": (lambda m: m.scenario_eager_insert(3, signals=1),
                     50_000),
    "delete": (lambda m: m.scenario_delete(4), 50_000),
    "insert_delete": (lambda m: m.scenario_insert_delete(3), 100_000),
    "double_insert": (lambda m: m.scenario_double_insert(3), 100_000),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_check_decomposed_matches_reference(name):
    """Per message class: equal focus, explored states, transitions,
    quiescent states, truncation and violations (none)."""
    make, cap = SCENARIOS[name]
    got = mc.check_decomposed(make(mc), max_states=cap)
    want = ref_mc.check_decomposed(make(ref_mc), max_states=cap)
    assert _stats(got) == _stats(want)
    assert len(got) == 12
    for s in got:
        assert not s.truncated and s.violations == [], s.focus
        assert s.quiescent >= 1


def test_check_full_matches_reference():
    got = mc.check_full(mc.scenario_eager_insert(2, signals=1),
                        max_states=100_000)
    want = ref_mc.check_full(ref_mc.scenario_eager_insert(2, signals=1),
                             max_states=100_000)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert not got.truncated and got.violations == []


def test_decomposition_is_cheaper_than_full():
    """The paper's Table-1 motivation, through the port (the reference's
    own test runs the JAX package's copy): joint exploration blows up,
    per-message-class exploration stays small."""
    full = mc.check_full(mc.scenario_eager_insert(3, signals=2),
                         max_states=50_000)
    dec = mc.check_decomposed(mc.scenario_eager_insert(3, signals=2),
                              max_states=50_000)
    dec_total = sum(s.states for s in dec)
    assert full.states > 10 * dec_total, (full.states, dec_total)


def _inject_reparent_bug(monkeypatch, phx, M):
    """Revert the SCSL re-parent to fire-and-forget (no CHILD_ADD_ACK
    handshake, no grant clamping): the historical bug of the reference's
    mutation test, patched into ``phx.PhaserActor``."""
    orig = phx.PhaserActor._reparent

    def buggy(self, st, new_parent, effective):
        if st.lid == phx.SNSL:
            return orig(self, st, new_parent, effective)
        iv = st.adv_open_iv()
        if iv is None:
            return
        old = iv[2]
        if old == new_parent:
            return
        switch = max(effective, st.closed + 1, iv[0])
        end = st.adv_close(switch)
        self._send(old, M.CHILD_DEL(self.rank, old, from_phase=end,
                                    lid=st.lid))
        st.adv_open(end, new_parent)
        self._send(new_parent, M.CHILD_ADD(self.rank, new_parent,
                                           from_phase=end, lid=st.lid))

    def buggy_child_add(self, m):
        st = self.st(m.lid)
        child = m.child if m.child is not None else m.src
        st.book_add(child, m.from_phase)
        if st.lid == phx.SNSL:
            rel = self.head_released if self.is_head else st.released
            if rel >= 0:
                self._send(child, M.ADV(self.rank, child, phase=rel,
                                        lid=phx.SNSL))
        elif self.is_head:
            self._try_release_head()
        else:
            self._try_close_sc()

    monkeypatch.setattr(phx.PhaserActor, "_reparent", buggy)
    monkeypatch.setattr(phx.PhaserActor, "_on_CHILD_ADD", buggy_child_add)


def test_checker_detects_injected_bug(monkeypatch):
    """Mutation test against the port's ``PhaserActor``: the checker
    reports the bug, with the same violations as the reference's checker
    under the same mutation of the reference's actor."""
    from repro.core import messages as ref_M
    from repro.core import phaser as ref_phx
    from repro_torch.core import messages as M
    from repro_torch.core import phaser as phx
    _inject_reparent_bug(monkeypatch, phx, M)
    _inject_reparent_bug(monkeypatch, ref_phx, ref_M)
    found, ref_found = [], []
    for cls in [("TUS",), ("SIG",), ("UNL", "UNL_ACK", "DEREG")]:
        found += mc.check(mc.scenario_insert_delete(3), cls,
                          max_states=50_000).violations
        ref_found += ref_mc.check(ref_mc.scenario_insert_delete(3), cls,
                                  max_states=50_000).violations
    assert found, "checker failed to catch the injected bug"
    assert found == ref_found


# ----------------------------------------------------------- complexity
def test_complexity_bounds_match_reference():
    for p in (0.25, 0.5, 0.75):
        assert cx.expected_height(p) == ref_cx.expected_height(p)
        for n in (1, 2, 3, 7, 64, 1000, 10 ** 6):
            for f in ("expected_depth", "signal_bound", "insertion_bound",
                      "deletion_bound"):
                assert getattr(cx, f)(n, p) == getattr(ref_cx, f)(n, p), \
                    (f, n, p)
        for C in (1, 4, 100):
            assert cx.lazy_promotion_bound(C, p) == \
                ref_cx.lazy_promotion_bound(C, p)


@pytest.mark.parametrize("curve", ["log", "linear", "noisy_log"])
def test_fit_and_is_logarithmic_match_reference(curve):
    xs = [2 ** k for k in range(1, 11)]
    rng = np.random.default_rng(0)
    ys = {"log": [3 * math.log2(x) + 1 for x in xs],
          "linear": [0.5 * x + 2 for x in xs],
          "noisy_log": [2 * math.log2(x) + float(rng.normal(0, 0.3))
                        for x in xs]}[curve]
    got_ok, got = cx.is_logarithmic(xs, ys)
    want_ok, want = ref_cx.is_logarithmic(xs, ys)
    assert got_ok == want_ok == (curve != "linear")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert cx.Fit.log_fit(xs, ys).predict(48) == \
        ref_cx.Fit.log_fit(xs, ys).predict(48)


# ------------------------------------------------- SIG/WAIT point to point
def _both(modes, seed):
    """The same point-to-point phaser in both packages."""
    ref_modes = {r: {SIG_MODE: REF_SIG, WAIT_MODE: REF_WAIT,
                     SIG_WAIT: REF_SIG_WAIT}[m] for r, m in modes.items()}
    return (p2p.P2PPhaser(modes, seed=seed),
            ref_p2p.P2PPhaser(ref_modes, seed=seed))


def _released(ph, ranks):
    return [ph.released(r) for r in ranks]


def test_sig_wait_producer_consumer_accumulation():
    for p in _both({0: SIG_MODE, 1: WAIT_MODE}, 0):
        assert not p.wait(1, 0)
        p.signal(0, times=3)              # unbounded run-ahead
        assert p.wait(1, 0) and p.wait(1, 2) and not p.wait(1, 3)
        p.verify_topology()


def test_waiters_never_gate_release():
    got, want = _both({0: SIG_MODE, 1: SIG_MODE, 2: WAIT_MODE}, 1)
    seen = []
    for p in (got, want):
        p.signal(0, 2)
        a = p.released(2)
        p.signal(1, 1)
        seen.append((a, p.released(2), p.pending(0),
                     p.ph.net.total_sent()))
        p.verify_topology()
    assert seen[0] == seen[1] == (seen[1][0], 0, 1, seen[1][3])
    assert seen[0][0] == -1


def test_sig_only_cannot_wait_and_wait_only_cannot_signal():
    got, _ = _both({0: SIG_MODE, 1: WAIT_MODE}, 0)
    with pytest.raises(AssertionError):
        got.signal(1)
    with pytest.raises(AssertionError):
        got.wait(0, 0)


def test_mode_filtered_oracle_after_dynamic_add():
    got, want = _both({0: SIG_WAIT, 1: SIG_MODE, 2: WAIT_MODE}, 2)
    for p, (sig, wai) in ((got, (SIG_MODE, WAIT_MODE)),
                          (want, (REF_SIG, REF_WAIT))):
        p.add_participant(0, 3, sig)
        p.add_participant(0, 4, wai)
        p.signal(0), p.signal(1), p.signal(3)
        assert p.released(2) == 0 and p.released(4) == 0
        assert sorted(p.signalers()) == [0, 1, 3]
        assert sorted(p.waiters()) == [0, 2, 4]
        p.verify_topology()
    assert _released(got, range(5)) == _released(want, range(5))


def test_graph_modes_aggregate():
    g = p2p.PipelinePhaserGraph(3, pipeline_edges(3), seed=0)
    assert [g.mode_of(i) for i in range(3)] == [SIG_WAIT] * 3
    g2 = p2p.PipelinePhaserGraph(2, [(0, 1)], seed=0)
    assert g2.mode_of(0) == SIG_MODE and g2.mode_of(1) == WAIT_MODE


def test_watermarks_track_the_phases():
    """``enable_watermarks`` installs the live tracker (``obs/live.py``,
    copied with the layer): its signal / wait watermarks equal the
    reference's after the same run."""
    got, want = _both({0: SIG_MODE, 1: SIG_MODE, 2: WAIT_MODE}, 3)
    snaps = []
    for p in (got, want):
        wm = p.enable_watermarks(pid=0)
        p.signal(0, 3)
        p.signal(1, 2)
        snaps.append({r: (h["signal"], h["wait"], h["mode"]) for r, h
                      in wm.snapshot()["hosts"].items()})
    assert snaps[0] == snaps[1]
    assert snaps[0][2][1] == 1


def _random_program(rng, n):
    """A random valid op stream over a random directed stage graph (the
    reference's hypothesis property, drawn from a seeded generator)."""
    pairs = [(u, v) for u in range(n) for v in range(n) if u != v]
    k = int(rng.integers(1, min(len(pairs), 6) + 1))
    edges = [pairs[i] for i in rng.choice(len(pairs), size=k, replace=False)]
    prog, count = [], {e: 0 for e in edges}
    for _ in range(int(rng.integers(5, 41))):
        e = edges[rng.integers(len(edges))]
        if count[e] and rng.integers(2):
            prog.append(("wait", e, int(rng.integers(count[e]))))
        else:
            prog.append(("signal", e))
            count[e] += 1
    return edges, prog


@pytest.mark.parametrize("seed", range(6))
def test_release_order_matches_reference_and_oracle(seed):
    rng = np.random.default_rng(seed)
    edges, prog = _random_program(rng, int(rng.integers(2, 6)))
    order = lambda log: [(e.edge, e.phase) for e in log]
    g = p2p.PipelinePhaserGraph(max(max(e) for e in edges) + 1, edges,
                                seed=seed % 7)
    rg = ref_p2p.PipelinePhaserGraph(max(max(e) for e in edges) + 1,
                                     edges, seed=seed % 7)
    got = order(g.run_program(prog))
    assert got == order(rg.run_program(prog))
    assert got == order(p2p.simulate_program(edges, prog)) \
        == order(ref_p2p.simulate_program(edges, prog))
    g.verify_topologies()
    assert g.stats() == rg.stats()


# ----------------------------------------------------- 1F1B schedules
GRID = [(S, M, v) for S in (1, 2, 3) for M in (1, 2, 3, 4, 6) for v in
        (1, 2, 3) if v == 1 or M % S == 0]


@pytest.mark.parametrize("S,M,v", GRID)
def test_schedules_match_reference(S, M, v):
    """Equal waves, wave count, ring slots, bubble and per-chunk
    in-flight analysis; ``verify_phase_order`` drives both through the
    real actors with equal protocol stats."""
    got, want = derive_interleaved(S, M, v), ref_derive(S, M, v)
    assert got.waves == want.waves and got.n_waves == want.n_waves
    assert got.ring_slots == want.ring_slots
    assert got.bubble_fraction() == want.bubble_fraction()
    assert got.chunk_inflight() == want.chunk_inflight()
    assert got.as_program() == want.as_program()
    assert pipeline_edges(S * v) == ref_edges(S * v)
    for s in range(S):
        assert got.chunk_stream(s) == want.chunk_stream(s)
    if v == 1:
        assert derive_1f1b(S, M).waves == got.waves
    assert verify_phase_order(got) == ref_verify_order(want)


def test_interleave_needs_microbatches_divisible_by_stages():
    with pytest.raises(AssertionError, match="M % S"):
        derive_interleaved(2, 3, 2)


# --------------------------------------------------- elastic controller
def test_elastic_controller_matches_reference():
    """One event script (joins, a failure, a leave) through both
    controllers: equal epochs, masks, loss scales and stats."""
    script = {1: [("join", None)], 2: [("join", 0)],
              4: [("fail", 1)], 5: [("leave", 3), ("join", None)]}
    ctl = [ElasticController(3, seed=0), RefController(3, seed=0)]
    for step in range(7):
        for c in ctl:
            for kind, arg in script.get(step, []):
                if kind == "join":
                    c.join(step, parent=arg)
                else:
                    c.leave(step, arg, fail=kind == "fail")
            c.step_barrier(step)
        assert ctl[0].loss_scale() == ctl[1].loss_scale()
        assert list(ctl[0].mask) == list(ctl[1].mask)
    eps = [[(e.index, tuple(e.live), e.kind, e.stats()) for e in c.epochs]
           for c in ctl]
    assert eps[0] == eps[1] and len(eps[0]) == 5
    assert ctl[0].collective("recursive_doubling").stats() == \
        ctl[1].collective("recursive_doubling").stats()
    assert ctl[0].stats() == ctl[1].stats()
    assert ctl[0].schedule_epoch == 4
    ctl[0].verify_epoch()
