"""The port's ServeEngine against the JAX package's on the same requests
(reduced smollm, f32, batch 4, window 32): identical token streams,
phaser epochs and admission counters. The mix covers every admission
path: prompts of 1..30 tokens in several pow2 buckets, one of 40 (past
the window: token-by-token admission), ``max_new=1`` requests retired
at admission, and more requests than slots (slot reuse)."""
import types

import jax
import numpy as np
import torch

from repro.models.registry import get_api as ref_get_api
from repro.models.registry import get_config as ref_get_config
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import get_api, get_config
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, ServeEngine

# a token is decided by argmax; the frameworks' logits differ by ~1e-6,
# so every argmax the engine consumes must win by more than this
MARGIN = 1e-4

LENGTHS = [5, 30, 1, 12, 40, 3, 17, 8, 2, 29, 16, 7]
MAX_NEW = [4, 6, 1, 5, 3, 1, 6, 2, 5, 4, 3, 6]


class _MarginProbe:
    """Stands in for ``torch`` inside the engine module: ``argmax``
    records the top-2 margin of the rows the engine consumes (decode:
    the active slots; admission: every row it is given)."""

    def __init__(self, eng):
        self.eng = eng
        self.margins = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def argmax(self, x, dim=-1):
        rows = x if x.ndim == 2 else x[None]
        active = [i for i, r in enumerate(self.eng.slot_req)
                  if r is not None]
        if x.ndim == 2 and rows.shape[0] == self.eng.batch and active:
            rows = rows[active]
        top2 = torch.topk(rows.float(), 2, dim=-1).values
        self.margins.extend((top2[:, 0] - top2[:, 1]).tolist())
        return torch.argmax(x, dim=dim)


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new=m) for i, (n, m) in enumerate(zip(LENGTHS, MAX_NEW))]


def test_engine_matches_reference(monkeypatch):
    ref_cfg = ref_get_config("smollm-135m").reduced()
    ref_api = ref_get_api(ref_cfg)
    ref_params = ref_api.init_params(jax.random.key(0))
    cfg = get_config("smollm-135m").reduced()
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             cfg, device="cpu")

    ref_eng = RefEngine(ref_api, ref_params, batch=4, window=32)
    eng = ServeEngine(get_api(cfg), params, batch=4, window=32)
    probe = _MarginProbe(eng)
    monkeypatch.setattr(engine_mod, "torch", probe)

    ref_reqs = _requests(RefRequest, cfg.vocab_size)
    reqs = _requests(Request, cfg.vocab_size)
    for a, b in zip(ref_reqs, reqs):
        ref_eng.submit(a)
        eng.submit(b)
    ref_done = ref_eng.run_until_drained()
    done = eng.run_until_drained()

    assert [r.rid for r in done] == [r.rid for r in ref_done]
    assert all(r.done and len(r.out) == r.max_new for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert min(probe.margins) > MARGIN
    assert len(probe.margins) >= sum(MAX_NEW)

    assert eng.epoch == ref_eng.epoch
    assert len(eng.gate.events) == len(ref_eng.gate.events)
    assert eng.gate.ph.released() == ref_eng.gate.ph.released()
    assert ([(e.index, e.phase_start, e.live) for e in eng.gate.epochs]
            == [(e.index, e.phase_start, e.live)
                for e in ref_eng.gate.epochs])
    counters = eng.metrics.snapshot()["counters"]
    assert counters == ref_eng.metrics.snapshot()["counters"]
    assert counters["serve.admit.sequential"] == 1
    assert counters["serve.admit.kv"] == len(LENGTHS) - 1
    hist = eng.metrics.snapshot()["hists"]["serve.admit.group_size"]
    ref_hist = ref_eng.metrics.snapshot()["hists"]["serve.admit.group_size"]
    assert (hist["count"], hist["total"]) == (ref_hist["count"],
                                              ref_hist["total"])

    # the caches evolved alike, inactive slots' decode writes included
    for leaf in ("k", "v", "pos"):
        np.testing.assert_allclose(
            eng.state["layers"][leaf].numpy(),
            np.asarray(ref_eng.state["layers"][leaf]), rtol=1e-4, atol=1e-4)


def test_reused_slot_shorter_bucket_invalidates_stale_positions():
    cfg = get_config("smollm-135m").reduced()
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(api, params, batch=1, window=32)
    rng = np.random.default_rng(2)
    long_req = Request(0, rng.integers(0, 128, 20).astype(np.int32), 2)
    short_req = Request(1, rng.integers(0, 128, 3).astype(np.int32), 3)
    eng.submit(long_req)
    eng.submit(short_req)
    eng.run_until_drained()
    solo = ServeEngine(api, params, batch=1, window=32)
    alone = Request(1, short_req.prompt, 3)
    solo.submit(alone)
    solo.run_until_drained()
    assert short_req.out == alone.out
    pos = eng.state["layers"]["pos"][:, 0]
    assert int((pos >= 0).sum(dim=-1).max()) == 3 + 2   # prompt + decoded


def test_launch_serve_cli_cpu(capsys):
    rc = launch_serve.main(["--arch", "smollm-135m", "--reduced",
                            "--device", "cpu", "--requests", "5",
                            "--batch", "2", "--window", "16",
                            "--prompt-len", "20", "--max-new", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "served 5/5 requests" in out
    assert "phase-gated batch membership" in out
    assert isinstance(engine_mod.torch, types.ModuleType)
