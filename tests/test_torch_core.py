"""The port's copies of the control plane against the JAX package's:
collective schedules (fingerprints and host simulation) and the elastic
epoch runtime driven through the same churn script."""
import numpy as np
import pytest

from repro.core.collective import ALLREDUCE_KINDS
from repro.core.collective import PhaserCollective as RefCollective
from repro.runtime_elastic import ElasticPhaserRuntime as RefRuntime
from repro_torch.core.collective import ALLREDUCE_KINDS as PORT_KINDS
from repro_torch.core.collective import PhaserCollective
from repro_torch.runtime_elastic import ElasticPhaserRuntime


def test_allreduce_kinds_match():
    assert PORT_KINDS == ALLREDUCE_KINDS


@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("kind", ALLREDUCE_KINDS)
def test_schedule_fingerprints_and_simulation_match(kind, keyed):
    rng = np.random.default_rng(0)
    for n in range(1, 13):
        kw = {}
        if keyed:
            keys = tuple(sorted(rng.choice(100, size=n, replace=False)
                                .tolist()))
            kw = {"keys": keys, "leaf_keys": keys[1::3]}
        ref = RefCollective(n, "data", kind=kind, seed=3, **kw)
        port = PhaserCollective(n, "data", kind=kind, seed=3, **kw)
        assert port.schedule_fingerprint() == ref.schedule_fingerprint()
        assert port.stats() == ref.stats()
        assert port.matches_oracle()
        xs = [rng.standard_normal((5,)) for _ in range(n)]
        for a, b in zip(port.simulate_allreduce(xs),
                        ref.simulate_allreduce(xs)):
            np.testing.assert_array_equal(a, b)


# a join / leave / fail / demote / repromote script over 12 phases
SCRIPT = {1: [("join",)], 2: [("join",), ("leave", 1)],
          4: [("demote", 0)], 5: [("fail", 3), ("join",)],
          7: [("repromote", 0)], 8: [("leave", 0), ("join",)],
          10: [("demote", 5), ("leave", 2)]}


def _drive(rt):
    for step in range(12):
        for op in SCRIPT.get(step, []):
            if op[0] == "join":
                rt.request_join()
            elif op[0] == "leave":
                rt.request_leave(op[1])
            elif op[0] == "fail":
                rt.request_leave(op[1], fail=True)
            elif op[0] == "demote":
                rt.request_demote(op[1])
            else:
                rt.request_repromote(op[1])
        rt.advance()
        rt.verify_epoch()
    return rt


@pytest.mark.parametrize("kind", ALLREDUCE_KINDS)
def test_elastic_runtime_churn_script_matches(kind):
    ref = _drive(RefRuntime(4, seed=1, kind=kind))
    port = _drive(ElasticPhaserRuntime(4, seed=1, kind=kind))
    assert ([(e.index, e.phase_start, e.live, e.kind) for e in port.epochs]
            == [(e.index, e.phase_start, e.live, e.kind)
                for e in ref.epochs])
    assert ([e.collective.schedule_fingerprint() for e in port.epochs]
            == [e.collective.schedule_fingerprint() for e in ref.epochs])
    assert ([(e.step, e.kind, e.worker) for e in port.events]
            == [(e.step, e.kind, e.worker) for e in ref.events])
    assert port.stats() == ref.stats()
    assert port.epoch_key() == ref.epoch_key()
    assert len(port.epochs) > 5
