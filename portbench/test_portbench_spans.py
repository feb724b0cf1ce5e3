"""The program's spans as the traced run reads them: ``trace.reduce`` on
hand-built profiler events (a host span is no kernel, and names the
idle gap it spans), every range the port marks on the device named
with a prefix ``trace`` sets apart from the kernels, and
``advance_ms.train`` read from a tiny traced training run."""
import ast
import json

import pytest
import torch

from portbench import common, tiny, trace
from portbench.metrics import reader
from portbench.run import execute

PORT = common.ROOT / "src" / "repro_torch"
# device-marked ranges that no cell runs: the 2-D pipeline's waves (no
# mix asks for pipeline stages); a cell that runs them needs their
# prefix in ``trace.PREFIXES`` first
NO_CELL = {"pipeline.fwd", "pipeline.bwd"}


class _Ev:
    def __init__(self, name, dev, a_us, b_us):
        from torch.autograd import DeviceType
        self._n = name
        self._d = DeviceType.CUDA if dev else DeviceType.CPU
        self._a, self._b = int(a_us * 1e3), int(b_us * 1e3)

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b


def _prof(events):
    class K:
        def events(self):
            return events

    class P:
        kineto_results = K()

    class Prof:
        profiler = P()
    return Prof()


def test_host_spans_are_no_kernels_and_name_the_gaps():
    """A decode step: two kernels under a device-marked range, the
    host's wait in ``serve.decode.read``, the gate's advance after it,
    then the next step's kernel. The spans are host events: busy time
    is the kernels' union alone, and each idle gap is labelled by the
    innermost span over its middle."""
    ev = [
        # host: the step and its parts, an aten op inside the launch
        _Ev("serve.step", False, 0, 1000),
        _Ev("serve.decode", False, 0, 600),
        _Ev("serve.decode.launch", False, 0, 100),
        _Ev("aten::mm", False, 10, 20),
        _Ev("serve.decode.read", False, 100, 600),
        _Ev("serve.advance", False, 600, 1000),
        _Ev("gradsync.sync", False, 20, 40),
        # device: a mark and the kernels
        _Ev("gradsync.sync", True, 150, 420),
        _Ev("k1", True, 150, 250),
        _Ev("k2", True, 300, 420),
        _Ev("k3", True, 1100, 1150),
    ]
    red = trace.reduce(_prof(ev))
    assert red["busy_s"] == pytest.approx((100 + 120 + 50) / 1e6)
    assert set(red["ranges"]) == {"gradsync.sync"}
    r = red["ranges"]["gradsync.sync"]
    assert r["count"] == 1 and r["device_ms"] == pytest.approx(0.22)
    assert r["host_ms"] == pytest.approx(0.02)
    ops = {k for k, _ in red["breakdown"]["device_ops"]}
    assert ops == {"k1", "k2", "k3"}
    gaps = red["breakdown"]["idle_gaps"]
    # 420..1100 (middle 760: the advance), 250..300 (middle 275: the
    # wait for the tokens)
    assert gaps[0] == ["serve.advance", pytest.approx(680e-6)]
    assert gaps[1] == ["serve.decode.read", pytest.approx(50e-6)]


def _span_calls():
    """(file, name, marked on the device) of every ``span(...)`` call in
    the port, and the files that open a profiler range otherwise."""
    calls, other = [], []
    for p in sorted(PORT.rglob("*.py")):
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            fname = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if fname in ("record_function", "_RecordFunctionFast"):
                other.append(p.relative_to(PORT).as_posix())
            if fname != "span" or not node.args:
                continue
            arg = node.args[0]
            assert isinstance(arg, ast.Constant) and isinstance(
                arg.value, str), (p, ast.dump(arg))
            dev = any(k.arg == "device" and isinstance(k.value, ast.Constant)
                      and k.value.value for k in node.keywords)
            calls.append((p.relative_to(PORT).as_posix(), arg.value, dev))
    return calls, other


def test_every_device_marked_range_is_set_apart_from_kernels():
    """The port opens profiler ranges through ``obs.timeline.span``
    alone; a range it marks on the device is named with a prefix the
    reduction sets apart from the kernels (``trace.PREFIXES``), so no
    new range can become kernel time unseen. Host ranges (the serve
    engine's, the train loop's) are never marked on the device."""
    calls, other = _span_calls()
    assert set(other) == {"obs/timeline.py"}, other
    names = {n for _, n, _ in calls}
    for want in ("serve.step", "serve.admit", "serve.decode",
                 "serve.advance", "serve.decode.launch", "serve.decode.read",
                 "train.step", "train.advance", "epoch.relower",
                 "gradsync.grads"):
        assert want in names, want
    device = {n for _, n, d in calls if d}
    unlisted = {n for n in device if not n.startswith(trace.PREFIXES)}
    assert unlisted == NO_CELL, unlisted
    host = {n for _, n, d in calls if not d}
    assert not host & device
    for f in (common.HERE / "traffic").glob("*.json"):
        assert "pipeline_stages" not in json.loads(f.read_text()), f


def test_advance_ms_read_from_the_loops_timeline():
    read = reader("advance_ms.train")
    assert read({}) is None
    assert read({"spans": [{"name": "train.step", "dur": 9.0}]}) is None
    assert read({"spans": [{"name": "train.advance", "dur": 500.0},
                           {"name": "train.advance", "dur": 1500.0}]}) \
        == pytest.approx(1.0)


def test_traced_training_run_reports_advance_ms():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = execute(tiny.run_for("zamba2-7b.train_churn",
                                   seed=2**31 + 17, trace=True))
    finally:
        torch.set_num_threads(n)
    assert res["correct"], res["checks"]
    v = reader("advance_ms.train")(res["ctx"])
    assert v is not None and v > 0
    spans = [e["name"] for e in res["ctx"]["spans"]]
    assert spans.count("train.advance") == spans.count("train.step") \
        >= res["ctx"]["steps"] > 0
