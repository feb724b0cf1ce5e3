"""The serving cell end to end at a tiny size on the CPU (the plain
kernel versions), against the reference and the cell's limits; the
control and each planted fault must come out not correct."""
import pytest
import torch

from portbench import tiny
from portbench.drivers import serve_open_loop as S
from portbench.run import execute, judge

CELL = "mixtral-8x7b.serve_code"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sound_run_is_correct():
    res = execute(tiny.run_for(CELL, seed=2**31 + 21))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    e = res["e2e"]
    assert 0 < e["ttft_p95_ms"] < float("inf")
    assert 0 < e["tpot_p95_ms"] < float("inf")
    assert all(c["value"] < 1e-3 for c in res["checks"].values())


def _token_altered(eng):
    """A served token altered where it is produced (the decode step's
    logits favour one id)."""
    orig = eng._dispatch

    def dispatch(token_b, pos_b):
        logits, state = orig(token_b, pos_b)
        logits = logits.clone()
        logits[:, 7] += 100.0
        return logits, state
    eng._dispatch = dispatch


def _state_unchanged(eng):
    """A decode step that leaves its KV cache as it found it."""
    orig = eng._dispatch

    def dispatch(token_b, pos_b):
        kept = {k: v.clone() for k, v in eng.state["layers"].items()}
        out = orig(token_b, pos_b)
        for k, v in kept.items():
            eng.state["layers"][k].copy_(v)
        return out
    eng._dispatch = dispatch


def _first_token_altered(eng):
    """An admission's first token altered where it is produced."""
    orig = eng._occupy

    def occupy(slot, req, first_tok, length):
        return orig(slot, req, (first_tok + 1) % eng.cfg.vocab_size, length)
    eng._occupy = occupy


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _first_token_altered])
def test_planted_fault_is_not_correct(fault):
    res = execute(tiny.run_for(CELL, seed=2**31 + 22, fault=fault))
    assert not res["correct"], res["checks"]


# At this size the port's plain path in float32 reads 0 exactly, and the
# float8 control reads well above it but not always above the cell's
# limit (fewer near ties among the top logits than at the cell's width;
# PERF.md section 2 gives the card's readings against that limit), so
# the test holds it, by the run's own comparison, to this size's limit.
TEST_SIZE_LIMIT = {"mean_token_gap": 0.02}


def test_control_is_not_correct():
    """The tokens the float8 reference puts first fail the limit."""
    r = tiny.run_for(CELL, seed=2**31 + 23)
    out = S.calibrate(r, controls=True)
    assert out["program"]["mean_token_gap"] == 0.0, out["program"]
    checks, ok = judge(out["control_fp8"], TEST_SIZE_LIMIT)
    assert checks and not ok, checks
