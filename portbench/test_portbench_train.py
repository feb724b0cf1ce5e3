"""The training cell end to end at a tiny size on the CPU (the plain
kernel versions), against the reference and the cell's limits; the
control (the reference in float8) and each planted fault must come
out not correct."""
import pytest
import torch

from portbench import tiny
from portbench.run import execute

CELL = "zamba2-7b.train_churn"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sound_run_is_correct():
    res = execute(tiny.run_for(CELL, seed=2**31 + 11))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["e2e"]["train_tokens_per_s"] > 0
    # the port's plain path in f32 against the f32 reference
    assert all(c["value"] < 1e-4 for c in res["checks"].values()), \
        res["checks"]


def _unchanged(loop):
    """A step that returns its state unchanged."""
    from repro_torch.optim import AdamW

    class Same(AdamW):
        def update(self, grads, state, params, **kw):
            _, _, om = AdamW.update(self, grads, state, params, **kw)
            return params, state, om
    o = loop.opt
    loop.opt = Same(lr=o.lr, warmup=o.warmup, total_steps=o.total_steps)


def _half_batch(loop):
    """Half of the batch left out, the mean taken over the rest."""
    import dataclasses
    api = loop.api

    @dataclasses.dataclass(frozen=True)
    class Half(type(api)):
        def value_and_grad(self, params, batch, **kw):
            n = batch["tokens"].shape[0]
            half = {k: v[:max(1, n // 2)] for k, v in batch.items()}
            return super().value_and_grad(params, half, **kw)
    loop.api = Half(api.cfg)


def _no_exchange(loop):
    """The exchange between ranks left out: each keeps its own sum."""
    import repro_torch.collective_exec.program as P
    orig = P.execute_flat
    P.execute_flat = lambda buf, pc, stack: [buf]
    loop._restore = lambda: setattr(P, "execute_flat", orig)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _no_exchange])
def test_planted_fault_is_not_correct(fault):
    r = tiny.run_for(CELL, seed=2**31 + 12, seconds=0.2, fault=fault)
    try:
        res = execute(r)
    finally:
        import repro_torch.collective_exec.program as P
        from repro_torch.collective_exec import executor
        P.execute_flat = executor.execute_flat
    assert not res["correct"], res["checks"]


def test_control_is_not_correct():
    """The reference in float8 in the program's place fails a limit."""
    from portbench.drivers import train_elastic as T
    from portbench.reference.common import Precision
    r = tiny.run_for(CELL, seed=2**31 + 13)
    nums = T.compare(T.reference(r, Precision("fp8")),
                     T.reference(r, Precision("f32")))
    assert any(v > r.limits[k] for k, v in nums.items()), nums
