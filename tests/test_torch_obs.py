"""The port's observability plane (``repro_torch.obs``: trace, recorder,
hub and the ``check`` / ``watch`` CLIs) against the JAX package's
(``repro.obs``).

Each case runs the reference test's steps through both packages and
holds the port to the reference's verdicts: the O(log P) hop check's
result or refusal, the trace store's retention under a cap, a flight
ring's bounds and flush, and the CLIs' exit codes (0 clean, 1 an
invariant broken or an empty stream, 2 unreadable input) and their
outputs on the same files. Everything here is exact: the records carry
no floats but wall-clock stamps, which are left out.
"""
from __future__ import annotations

import json
import os

import pytest

import repro.obs as ref_obs
import repro.runtime_dist as ref_rd
import repro_torch.obs as port_obs
import repro_torch.runtime_dist as port_rd

PKGS = {"reference": (ref_obs, ref_rd), "port": (port_obs, port_rd)}


def _coord(rd, n, **kw):
    return rd.DistCoordinator(rd.InprocCluster(), n, seed=0, obs=True, **kw)


def _deep_chain(n):
    recs = [{"ev": "span", "trace": "signal:0:0:1", "span": (0, 1),
             "parent": None, "name": "signal", "src": 0, "dst": 0,
             "pid": 0, "hop": 0, "depth": 0}]
    prev = (0, 1)
    for i in range(2, n):
        recs.append({"ev": "span", "trace": "signal:0:0:1",
                     "span": (0, i), "parent": prev, "name": "SIG",
                     "src": 0, "dst": 1, "pid": 0, "hop": i - 1,
                     "depth": i - 1})
        prev = (0, i)
    return recs


def test_check_signal_hops_verdicts_match_reference():
    """A 38-deep chain breaks the bound at n=4 in both packages; a
    shallow one passes with the same result dict."""
    for obs, _ in PKGS.values():
        with pytest.raises(AssertionError, match="exceeds the O\\(log P\\)"):
            obs.check_signal_hops(_deep_chain(40), 4)
    got = port_obs.check_signal_hops(_deep_chain(4), 4)
    assert got == ref_obs.check_signal_hops(_deep_chain(4), 4)
    assert 0 < got["max_depth"] <= got["bound"]


def _trace(trace, seq, n):
    recs = [{"ev": "span", "trace": trace, "span": [0, seq * 100 + 1],
             "parent": None, "name": "signal", "src": 0, "dst": 0,
             "pid": 0, "hop": 0, "depth": 0}]
    root = recs[0]["span"]
    for i in range(1, n):
        recs.append({"ev": "span", "trace": trace,
                     "span": [0, root[1] + i], "parent": list(root),
                     "name": "SIG", "src": 0, "dst": 1, "pid": 0,
                     "hop": i, "depth": i})
        recs.append({"ev": "close", "span": [0, root[1] + i],
                     "status": "delivered", "pid": 0})
    return recs


def test_trace_store_retention_matches_reference():
    """Whole-trace eviction under a span cap: the same retained traces,
    dropped spans and evicted traces, every retained tree complete."""
    out = {}
    for label, (obs, _) in PKGS.items():
        st = obs.TraceStore(max_spans=10)
        for t in range(6):
            st.add(_trace(f"signal:0:0:{t}", t, 4))
        assert len(st.spans) <= 14
        assert all(st.problems(t) == [] for t in st.trace_ids())
        out[label] = (st.trace_ids(), st.dropped_spans, st.evicted_traces,
                      {t: st.critical_path(t) for t in st.trace_ids()})
    assert out["port"] == out["reference"]
    assert out["port"][1] > 0 and out["port"][2] > 0


def test_flight_ring_and_checker_cli_match_reference(tmp_path, capsys):
    """A bounded ring keeps the latest window and flushes a coherent
    file; the recorder CLI's verdicts (empty dir 1, a coherent file 0,
    a headerless one 1) in both packages."""
    for label, (obs, _) in PKGS.items():
        from importlib import import_module
        recorder = import_module(obs.__name__ + ".recorder")
        d = tmp_path / label
        d.mkdir()
        fr = obs.FlightRecorder(3, cap=8)
        for i in range(20):
            fr.event("step", step=i)
        assert len(fr) == 8 and fr.dropped == 12
        path = obs.flight_path(str(d), 3)
        assert path.endswith("worker3.flight.jsonl")
        assert fr.flush(path, "test") == 8
        s = obs.check_flight_file(path)
        assert s["problems"] == [] and s["records"] == 8
        recs = [json.loads(line) for line in open(path)][1:]
        assert [r["step"] for r in recs] == list(range(12, 20))
        empty = d / "empty"
        empty.mkdir()
        assert recorder.main([str(empty)]) == 1
        assert recorder.main([str(d), "--min-files", "1"]) == 0
        with open(obs.flight_path(str(d), 1), "w") as f:
            f.write(json.dumps({"ev": "event", "kind": "step", "pid": 1,
                                "t": 1.0}) + "\n")
        assert recorder.main([str(d)]) == 1
        capsys.readouterr()


def _spans_file(rd, tmp, name):
    rt = _coord(rd, 3)
    rt.advance(step=0)
    rt.advance(step=1)
    rt.close()
    trace = str(tmp / f"{name}.json")
    rt.export_obs(trace, None)
    return str(tmp / f"{name}.spans.jsonl")


@pytest.mark.parametrize("case", ["clean", "lost", "broken", "absent",
                                  "garbled"])
def test_check_cli_exit_codes_match_reference(case, tmp_path, capsys):
    """``python -m repro_torch.obs.check``: 0 on a clean traced run and
    on one with a lost-shard marker mid-file, 1 on an unclosed non-root
    span, 2 on a missing or unparsable file; the same code and the same
    report as the reference's checker on the same file."""
    from repro.obs import check as ref_check
    from repro_torch.obs import check
    spans = _spans_file(port_rd, tmp_path, "run")
    args = ["--hosts", "3"]
    if case == "clean":
        path, args, code = spans, args + ["--summary", "--require-ops",
                                          "signal"], 0
    elif case == "lost":
        recs = [json.loads(l) for l in open(spans)]
        recs.insert(len(recs) // 2, {"ev": "lost", "pid": 99})
        path, code = str(tmp_path / "lost.spans.jsonl"), 0
        with open(path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in recs)
    elif case == "broken":
        path, args, code = str(tmp_path / "bad.spans.jsonl"), \
            ["--hosts", "2", "--summary"], 1
        with open(path, "w") as f:
            for r in _deep_chain(3):
                f.write(json.dumps(r) + "\n")
    elif case == "absent":
        path, code = str(tmp_path / "absent.jsonl"), 2
    else:
        path, code = str(tmp_path / "garbled.jsonl"), 2
        with open(path, "w") as f:
            f.write("not json at all\n")
    assert check.main([path, *args]) == code
    got = capsys.readouterr().out
    assert ref_check.main([path, *args]) == code
    assert got == capsys.readouterr().out
    if case == "clean":
        assert got.startswith("OK ") and "sig_depth=" in got
    if case == "lost":
        assert json.loads(got)["lost_pids"] == [99]
    if case == "broken":
        assert "FAIL" in got
    # the port's traced run exports the reference's span log
    if case == "clean":
        ref_spans = _spans_file(ref_rd, tmp_path, "ref")
        assert open(ref_spans).read() == open(spans).read()


def test_watch_cli_exit_codes(tmp_path, capsys):
    """``python -m repro_torch.obs.watch``: renders a live-out stream
    with a crash in it (0), 1 on an empty stream, 2 on a missing file,
    ``--json`` the raw last frame; the reference's watch renders the
    port's stream the same."""
    from repro.obs import watch as ref_watch
    from repro_torch.obs import watch
    out = str(tmp_path / "run.live.jsonl")
    rt = port_rd.DistCoordinator(port_rd.InprocCluster(), 3, seed=0,
                                 live_out=out)
    for s in range(3):
        rt.advance(step=s)
    rt.cluster.kill_host(1)
    rt.advance(step=3)
    rt.close()
    frames = port_obs.read_frames(out)
    assert frames[-1]["gen"] >= 1 and frames[-1]["live"] == [0, 2]
    assert watch.main([out, "--once"]) == 0
    text = capsys.readouterr().out
    assert "live phaser run" in text and "dead" in text
    assert f"gen {frames[-1]['gen']}" in text
    assert ref_watch.main([out, "--once"]) == 0
    assert capsys.readouterr().out == text
    empty = str(tmp_path / "empty.jsonl")
    open(empty, "w").close()
    assert watch.main([empty, "--once"]) == 1
    assert watch.main([str(tmp_path / "gone.jsonl"), "--once"]) == 2
    capsys.readouterr()
    assert watch.main([out, "--once", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["gen"] == frames[-1]["gen"]


def test_hub_export_reflects_retention_and_survives_reload(tmp_path):
    """A capped hub store exports a span log that offline checks agree
    with: the retention marker first, then complete per-trace records,
    the same as the reference's hub writes for the same run."""
    logs = {}
    for label, (obs, rd) in PKGS.items():
        rt = _coord(rd, 3)
        rt.obs.store.max_spans = 20
        for s in range(5):
            rt.advance(step=s)
        rt.close()
        assert rt.obs.store.dropped_spans > 0
        trace = str(tmp_path / f"{label}.json")
        rt.export_obs(trace, None)
        path = str(tmp_path / f"{label}.spans.jsonl")
        recs = [json.loads(l) for l in open(path)]
        assert recs[0]["ev"] == "retention"
        st = obs.TraceStore(max_spans=None)
        st.add(recs)
        assert st.dropped_spans == rt.obs.store.dropped_spans
        assert all(st.problems(t) == [] for t in st.trace_ids())
        assert os.path.basename(obs.spans_path(trace)) == \
            f"{label}.spans.jsonl"
        logs[label] = recs
    assert logs["port"] == logs["reference"]
