"""Flight recorder: a bounded per-process ring of recent spans/events.

The obs plane's export path only runs when a run ends cleanly — the
moments worth debugging (SIGKILL, orphan exit, eviction) are exactly
when it never runs. Every ``ShardPhaser`` therefore owns a
``FlightRecorder`` unconditionally (always-on: the ring is a deque
append, no I/O, no timestamps on the hot tee path), and the runtime
flushes it to ``*.flight.jsonl`` at the failure edges:

* worker **crash**      — the serve loop's exception path;
* worker **orphan exit** — coordinator silent past the heartbeat
  horizon (exit code 2);
* cooperative **eviction** — the coordinator asks the departing host
  to flush before shutdown;
* **SIGKILL-survivor recovery** — after a non-cooperative eviction the
  coordinator flushes its own ring and every survivor's, so the
  last-N-records window around the death is on disk even though the
  corpse itself wrote nothing.

Ring contents: the ``Tracer``'s span/close records (teed by reference —
no copy), plus sparse timestamped lifecycle events (release, rebuild,
membership, step) that bracket the spans in wall-clock time.

``python -m repro_torch.obs.recorder DIR`` checks a directory of flight
files for coherence (CI's chaos-smoke asserts a non-empty post-kill
record): exit 0 coherent, 1 incoherent/empty, 2 unreadable.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from collections import deque
from typing import Dict, List, Optional

_DEFAULT_CAP = 4096

# record kinds a coherent flight file may contain
_KNOWN_EV = {"flight", "span", "close", "lost", "event"}


class FlightRecorder:
    """Bounded ring of recent obs records for one process."""

    def __init__(self, pid: int, *, cap: int = _DEFAULT_CAP):
        self.pid = pid
        self.cap = cap
        self.dropped = 0
        self.flushes = 0
        self._ring: deque = deque(maxlen=cap)

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, rec: Dict) -> None:
        """Tee one record (by reference — the hot path of the tracer
        must not copy)."""
        if len(self._ring) == self.cap:
            self.dropped += 1
        self._ring.append(rec)

    def event(self, kind: str, **fields) -> None:
        """Sparse lifecycle event; carries a wall-clock stamp so the
        surrounding span records are bracketed in time."""
        self.record({"ev": "event", "kind": kind, "pid": self.pid,
                     "t": round(time.time(), 6), **fields})

    def flush(self, path: str, reason: str) -> int:
        """Write header + ring to ``path`` (latest flush wins: the ring
        IS the last-N-records window). Returns records written; never
        raises — the flush sites are exit paths."""
        try:
            recs = list(self._ring)
            header = {"ev": "flight", "pid": self.pid, "reason": reason,
                      "t": round(time.time(), 6), "n": len(recs),
                      "dropped": self.dropped, "cap": self.cap}
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(json.dumps(header) + "\n")
                for r in recs:
                    f.write(json.dumps(r) + "\n")
            os.replace(tmp, path)       # readers never see a torn file
            self.flushes += 1
            return len(recs)
        except Exception:
            return 0


def flight_path(directory: str, pid: int) -> str:
    name = "coord" if pid < 0 else f"worker{pid}"
    return os.path.join(directory, f"{name}.flight.jsonl")


def check_flight_file(path: str) -> Dict:
    """Coherence check of one flight file: parses line-by-line, header
    first, known record kinds, event timestamps monotone. Returns a
    summary dict with ``problems`` (empty == coherent)."""
    problems: List[str] = []
    records = 0
    events = 0
    spans = 0
    header: Optional[Dict] = None
    last_t: Optional[float] = None
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                problems.append(f"line {i + 1}: not JSON")
                continue
            ev = rec.get("ev")
            if i == 0:
                if ev != "flight":
                    problems.append("first record is not the flight "
                                    "header")
                else:
                    header = rec
                continue
            records += 1
            if ev not in _KNOWN_EV:
                problems.append(f"line {i + 1}: unknown ev {ev!r}")
            if ev == "span":
                spans += 1
            elif ev == "event":
                events += 1
                t = rec.get("t")
                if t is not None:
                    if last_t is not None and t < last_t - 1.0:
                        problems.append(f"line {i + 1}: event time "
                                        "regressed")
                    last_t = t
    if header is not None and header.get("n") != records:
        problems.append(f"header n={header.get('n')} but "
                        f"{records} records follow")
    if records == 0:
        problems.append("empty flight record")
    return {"path": path, "records": records, "spans": spans,
            "events": events,
            "pid": header.get("pid") if header else None,
            "reason": header.get("reason") if header else None,
            "dropped": header.get("dropped") if header else None,
            "problems": problems}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="flight-record coherence checker (chaos-smoke CI)")
    ap.add_argument("dir", help="directory of *.flight.jsonl files")
    ap.add_argument("--min-files", type=int, default=1,
                    help="fail unless at least this many flight files "
                         "exist (post-kill recovery flushes one per "
                         "survivor + the coordinator)")
    args = ap.parse_args(argv)

    paths = sorted(glob.glob(os.path.join(args.dir, "*.flight.jsonl")))
    summaries = []
    failures: List[str] = []
    if len(paths) < args.min_files:
        print(json.dumps({"dir": args.dir, "files": len(paths),
                          "ok": False,
                          "failures": [f"found {len(paths)} flight "
                                       f"files, need {args.min_files}"]},
                         indent=2))
        return 1
    for path in paths:
        try:
            s = check_flight_file(path)
        except OSError as e:
            print(json.dumps({"dir": args.dir, "ok": False,
                              "failures": [f"{path}: unreadable ({e})"]},
                             indent=2))
            return 2
        summaries.append(s)
        failures.extend(f"{os.path.basename(path)}: {p}"
                        for p in s["problems"])
    print(json.dumps({"dir": args.dir, "files": len(paths),
                      "records": sum(s["records"] for s in summaries),
                      "per_file": [{k: s[k] for k in
                                    ("path", "pid", "reason", "records",
                                     "spans", "events", "dropped")}
                                   for s in summaries],
                      "failures": failures[:20],
                      "ok": not failures}, indent=2))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
