"""The program's spans (``obs.timeline.span``) in the serve engine and
the train loop: under ``torch.profiler`` each ``serve.step`` is made of
its ``serve.admit``, ``serve.decode`` and ``serve.advance``, the decode
of its launch and read; the train loop's boundary work is one span per
piece; the loop's ``train.step_seconds`` is the device's step time on a
card and the host's on the CPU; and with no profiler and no timeline a
span enters nothing. The spans of the serve engine and the train loop
are host ranges (the profiler marks nothing of them on the device); the
``gradsync.*`` ranges stay marked on the device too."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.data import SyntheticLM
from repro_torch.models.registry import get_api, get_config
from repro_torch.obs import timeline as obs_timeline
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.timeline import Timeline
from repro_torch.optim import AdamW
from repro_torch.runtime_elastic import ElasticPhaserRuntime
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import loop as loop_mod
from repro_torch.train.loop import TrainLoop

STEPS = 5
CHURN = {1: [("join", None)], 3: [("leave", None)]}


def _engine():
    cfg = get_config("smollm-135m").reduced()
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(api, params, batch=4, window=32)
    rng = np.random.default_rng(0)
    for i, (n, m) in enumerate([(5, 3), (12, 4), (3, 1), (20, 2), (7, 5),
                                (9, 2)]):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new=m))
    return eng


def _loop(**kw):
    api = get_api(get_config("smollm-135m").reduced())
    return TrainLoop(api=api, opt=AdamW(lr=3e-3, warmup=2, total_steps=9),
                     data=SyntheticLM(vocab=api.cfg.vocab_size, batch=12,
                                      seq=8, seed=0),
                     runtime=ElasticPhaserRuntime(2, seed=0,
                                                  kind="phaser_scsl"),
                     elastic_events=CHURN, device="cpu", **kw)


def _ranges(prof, prefixes):
    """[(start_us, end_us, name, is a user annotation)] of the profile's
    host events named with one of ``prefixes``, in start order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(prefixes):
            out.append((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name(),
                        e.is_user_annotation()))
    return sorted(out)


def _inside(r, outer):
    return [x for x in r if outer[0] <= x[0] and x[1] <= outer[1]
            and x is not outer]


def _children(r, outer):
    """The ranges directly inside ``outer``."""
    ins = _inside(r, outer)
    return [x for x in ins if not any(y is not x and y[0] <= x[0]
                                      and x[1] <= y[1] for y in ins)]


def test_serve_step_is_made_of_admit_decode_advance():
    eng = _engine()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run_until_drained()
    r = _ranges(prof, ("serve.",))
    assert r and not any(ua for *_, ua in r), "host ranges alone"
    steps = [x for x in r if x[2] == "serve.step"]
    assert len(steps) == eng.metrics.counter("serve.decode.steps").value + 1
    covered = total = 0.0
    for s in steps:
        kids = _children(r, s)
        names = [k[2] for k in kids]
        assert names[:2] == ["serve.admit", "serve.decode"], names
        assert names[2:] in ([], ["serve.advance"]), names
        covered += sum(k[1] - k[0] for k in kids)
        total += s[1] - s[0]
        dec = next(k for k in kids if k[2] == "serve.decode")
        inner = [k[2] for k in _children(r, dec)]
        if inner:   # a step that decoded
            assert inner[:2] == ["serve.decode.launch",
                                 "serve.decode.read"], inner
            assert set(inner[2:]) <= {"serve.leave"}, inner
            assert names[2:] == ["serve.advance"]
        adm = next(k for k in kids if k[2] == "serve.admit")
        assert {k[2] for k in _children(r, adm)} <= {
            "serve.prefill", "serve.splice", "serve.first_read",
            "serve.join", "serve.leave"}
    # the step's own time outside its three children is bookkeeping
    assert covered > 0.9 * total, (covered, total)
    names = [x[2] for x in r]
    for n in ("serve.prefill", "serve.splice", "serve.first_read",
              "serve.join", "serve.leave"):
        assert n in names, n
    assert names.count("serve.join") == names.count("serve.leave") == 6


def test_train_boundary_work_is_spanned():
    tl = Timeline()
    loop = _loop(timeline=tl)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.run(STEPS)
    r = _ranges(prof, ("train.", "epoch.", "gradsync."))
    names = [x[2] for x in r]
    for n in ("train.step", "train.batch", "train.advance"):
        assert names.count(n) == STEPS, (n, names)
    bounds = len(loop.epoch_log)
    assert bounds == 2
    assert names.count("epoch.relower") == names.count("train.verify") \
        == bounds
    assert names.count("train.churn") == len(CHURN)
    # the engine's program syncs inside the step, marked on the device
    steps = [x for x in r if x[2] == "train.step"]
    gs = [x for x in r if x[2].startswith("gradsync.")]
    assert gs and all(any(s[0] <= g[0] and g[1] <= s[1] for s in steps)
                      for g in gs)
    assert all(ua for *_, n, ua in r if n.startswith("gradsync."))
    assert not any(ua for *_, n, ua in r if not n.startswith("gradsync."))
    # the timeline holds the same spans, the step's index on each step
    tn = [e["name"] for e in tl.events if e.get("ph") == "X"
          and e.get("cat") == "host"]
    for n in ("train.step", "train.batch", "train.advance",
              "epoch.relower", "train.verify", "gradsync.grads"):
        assert tn.count(n) == names.count(n), n
    assert [e["args"]["step"] for e in tl.events
            if e["name"] == "train.step"] == list(range(STEPS))


def test_no_profiler_no_timeline_enters_no_range(monkeypatch):
    """Unwatched, a span is the flag read and the ``None`` check: the
    engine and the loop enter no profiler range (counted by patching
    both range types), and do once a profiler records."""
    from torch.autograd import profiler as autograd_profiler
    entered = []

    class Counting:
        def __init__(self, make, name):
            self.inner = make(name)

        def __enter__(self):
            entered.append(1)
            return self.inner.__enter__()

        def __exit__(self, *exc):
            return self.inner.__exit__(*exc)

    def counting(make):
        return lambda name: Counting(make, name)
    monkeypatch.setattr(autograd_profiler, "record_function",
                        counting(autograd_profiler.record_function))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        counting(torch._C._profiler._RecordFunctionFast))
    assert obs_timeline.current() is None and not obs_timeline.profiling()
    assert obs_timeline.span("serve.step") is obs_timeline.span("x",
                                                                device=True)
    _engine().run_until_drained()
    _loop().run(STEPS)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs_timeline.profiling()
        _engine().step()
        _loop().run(2)
    assert len(entered) > 0


class _FakeEvent:
    """A CUDA event stand-in: done once the fake device reaches it."""
    clock = {"now": 0.0, "done_upto": -1}
    made = []

    def __init__(self):
        self.i = len(self.made)
        self.made.append(self)

    def record(self):
        self.t = self.clock["now"]

    def query(self):
        return self.i <= self.clock["done_upto"]

    def synchronize(self):
        self.clock["done_upto"] = max(self.clock["done_upto"], self.i)

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def test_step_clock_observes_device_intervals_without_waiting():
    """Each step's seconds are those between its end event and the one
    before (the run's start for the first), observed only once the
    later event has completed, and the rest at the drain."""
    _FakeEvent.made.clear()
    _FakeEvent.clock.update(now=0.0, done_upto=-1)
    reg = MetricsRegistry()
    clock = loop_mod._StepClock(reg, "cuda", event=_FakeEvent)
    hist = lambda: reg.snapshot()["hists"].get("train.step_seconds",
                                               {"count": 0, "total": 0.0})
    counts = []
    for k, t in enumerate([0.5, 1.25, 2.0]):
        _FakeEvent.clock["now"] = t
        clock.step_end(0.0)
        counts.append(hist()["count"])
        # the device runs a step behind the host: it has reached the
        # event before the one just recorded
        _FakeEvent.clock["done_upto"] = k
    # step 0 is observed once the device has passed step 1's end
    assert counts == [0, 0, 1]
    assert hist()["total"] == pytest.approx(0.5)
    clock.drain()
    h = hist()
    assert h["count"] == 3 and h["total"] == pytest.approx(2.0)


def test_step_seconds_on_the_cpu_is_host_time():
    reg = MetricsRegistry()
    _loop(metrics=reg).run(STEPS)
    h = reg.snapshot()["hists"]["train.step_seconds"]
    assert h["count"] == STEPS and h["total"] > 0
