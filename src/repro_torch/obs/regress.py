"""Perf-regression sentry over the ``BENCH_*.json`` artifacts.

``python -m repro_torch.obs.regress`` compares freshly produced bench JSON
against the committed ``BENCH_BASELINE.json`` — schema-aware and
direction-aware: a latency that went *up* is bad, a throughput that
went *down* is bad, a boolean claim that flipped false is always bad.
Per-metric tolerance bands absorb machine noise (socket latencies get
wide bands, deterministic structure counts get none).

Each bench file has an **extractor** that flattens it to
``{metric: (value, direction, tol_pct)}``; the baseline stores only the
values (+ the schema version), so tolerances and directions live here
in code and can be tuned without re-seeding. A schema_version change
sidesteps comparison for that bench (metrics are reported as
new/retired, not regressions) — a schema bump is an intentional edit,
not a perf event.

Exit codes: 0 clean (or ``--warn-only``), 1 regression detected,
2 baseline/fresh artifacts unreadable. ``--seed`` (re)writes the
baseline from the fresh artifacts.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

# direction: "lower" = lower is better, "higher" = higher is better,
# "bool" = must stay truthy once true
Metric = Tuple[float, str, float]   # (value, direction, tol_pct)

# tolerance bands (pct): wall-clock micro timings are noisy on shared
# CI machines; structural counts are deterministic per seed
_T_LATENCY = 15.0      # model-step timings (the acceptance case: +20%)
_T_SOCKET = 60.0       # socket RPC / detection wall clocks
_T_RATE = 50.0         # chaos throughput (scheduler-sensitive)
_T_COUNT = 10.0        # protocol frame/hop counts (deterministic-ish)


def _x_collective(d: Dict) -> Dict[str, Metric]:
    out = {}
    for k, v in d.get("ms_per_step", {}).items():
        out[f"ms_per_step.{k}"] = (v, "lower", _T_LATENCY)
    if "eager_over_overlapped" in d:
        out["eager_over_overlapped"] = (d["eager_over_overlapped"],
                                        "higher", _T_LATENCY)
    if "overlapped_bitwise_equals_eager" in d:
        out["overlapped_bitwise_equals_eager"] = (
            1.0 if d["overlapped_bitwise_equals_eager"] else 0.0,
            "bool", 0.0)
    return out


def _x_pipeline(d: Dict) -> Dict[str, Metric]:
    out = {}
    for k, v in d.get("ms_per_step", {}).items():
        out[f"ms_per_step.{k}"] = (v, "lower", _T_LATENCY)
    for k, v in d.get("bubble_fraction", {}).items():
        out[f"bubble_fraction.{k}"] = (v, "lower", 5.0)
    if "loss_matches_single_axis" in d:
        out["loss_matches_single_axis"] = (
            1.0 if d["loss_matches_single_axis"] else 0.0, "bool", 0.0)
    return out


def _x_obs(d: Dict) -> Dict[str, Metric]:
    out = {}
    for row in d.get("rows", []):
        c = row["case"]
        out[f"{c}.untraced_med_ms"] = (row["untraced_med_ms"], "lower",
                                       _T_SOCKET)
        out[f"{c}.traced_med_ms"] = (row["traced_med_ms"], "lower",
                                     _T_SOCKET)
        if "streamed_med_ms" in row:
            out[f"{c}.streamed_med_ms"] = (row["streamed_med_ms"],
                                           "lower", _T_SOCKET)
    if "within_gate" in d:
        out["within_gate"] = (1.0 if d["within_gate"] else 0.0,
                              "bool", 0.0)
    return out


def _x_dist(d: Dict) -> Dict[str, Metric]:
    out = {}
    for row in d.get("rows", []):
        # schema v3 rows carry the socket fabric; v2 rows were AF_UNIX
        pre = f"{row.get('transport', 'unix')}.n{row['n']}"
        for k in ("advance_ms", "join_ms", "evict_ms"):
            out[f"{pre}.{k}"] = (row[k], "lower", _T_SOCKET)
        for k in ("sig_hops", "trace_sig_depth", "frames_per_advance"):
            out[f"{pre}.{k}"] = (row[k], "lower", _T_COUNT)
    for k in ("sublinear_hop_growth", "signal_hops_within_bound"):
        if k in d:
            out[k] = (1.0 if d[k] else 0.0, "bool", 0.0)
    if "log_fit_r2" in d:
        out["log_fit_r2"] = (d["log_fit_r2"], "higher", 10.0)
    return out


def _x_chaos(d: Dict) -> Dict[str, Metric]:
    out = {}
    for row in d.get("detection", []):
        key = f"hb{row['hb_interval_s']:g}"
        out[f"{key}.detect_s"] = (row["detect_s"], "lower", _T_SOCKET)
        out[f"{key}.evict_and_advance_s"] = (row["evict_and_advance_s"],
                                             "lower", _T_SOCKET)
    for row in d.get("degradation", []):
        key = f"drop{row['p_drop']:g}"
        out[f"{key}.phases_per_s"] = (row["phases_per_s"], "higher",
                                      _T_RATE)
    return out


def _x_tcp(d: Dict) -> Dict[str, Metric]:
    out = {}
    for row in d.get("reset_replay", []):
        key = f"storm{row['storm']}"
        out[f"{key}.storm_advance_ms"] = (row["storm_advance_ms"],
                                          "lower", _T_SOCKET)
    s = d.get("session", {})
    if "balance_ok" in s:
        out["session.balance_ok"] = (1.0 if s["balance_ok"] else 0.0,
                                     "bool", 0.0)
    heal = d.get("partition_heal", {})
    if heal:
        out["heal.heal_to_advance_ms"] = (heal["heal_to_advance_ms"],
                                          "lower", _T_SOCKET)
        out["heal.zero_evictions"] = (
            1.0 if heal.get("evictions", 1) == 0 else 0.0, "bool", 0.0)
    return out


EXTRACTORS = {
    "BENCH_collective.json": _x_collective,
    "BENCH_pipeline.json": _x_pipeline,
    "BENCH_obs.json": _x_obs,
    "BENCH_dist.json": _x_dist,
    "BENCH_chaos.json": _x_chaos,
    "BENCH_tcp.json": _x_tcp,
}

BASELINE_NAME = "BENCH_BASELINE.json"


def extract(name: str, d: Dict) -> Dict[str, Metric]:
    fn = EXTRACTORS.get(name)
    return fn(d) if fn is not None else {}


def _load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def seed_baseline(fresh_dir: str, out_path: str) -> Dict:
    """(Re)write the baseline from the bench artifacts in fresh_dir."""
    benches = {}
    for name in sorted(EXTRACTORS):
        path = os.path.join(fresh_dir, name)
        if not os.path.exists(path):
            continue
        d = _load(path)
        benches[name] = {
            "schema_version": d.get("schema_version"),
            "metrics": {k: v for k, (v, _, _) in
                        sorted(extract(name, d).items())}}
    base = {"v": 1, "benches": benches}
    with open(out_path, "w") as f:
        json.dump(base, f, indent=2, sort_keys=True)
        f.write("\n")
    return base


def compare(baseline: Dict, fresh_dir: str) -> Dict:
    """Fresh artifacts vs the baseline. Returns a report with
    ``regressions`` (tolerance band exceeded in the bad direction),
    ``improvements``, and ``warnings`` (new / retired / missing /
    schema-changed — never failures)."""
    regressions: List[Dict] = []
    improvements: List[Dict] = []
    warnings: List[str] = []
    compared = 0
    for name, entry in sorted(baseline.get("benches", {}).items()):
        path = os.path.join(fresh_dir, name)
        if not os.path.exists(path):
            warnings.append(f"{name}: fresh artifact missing")
            continue
        d = _load(path)
        if d.get("schema_version") != entry.get("schema_version"):
            warnings.append(
                f"{name}: schema_version "
                f"{entry.get('schema_version')} -> "
                f"{d.get('schema_version')} (comparison skipped; "
                "re-seed the baseline)")
            continue
        fresh = extract(name, d)
        base = entry.get("metrics", {})
        for m in sorted(set(base) - set(fresh)):
            warnings.append(f"{name}:{m}: retired (in baseline only)")
        for m in sorted(set(fresh) - set(base)):
            warnings.append(f"{name}:{m}: new (not in baseline)")
        for m in sorted(set(base) & set(fresh)):
            bval = base[m]
            fval, direction, tol = fresh[m]
            compared += 1
            rec = {"bench": name, "metric": m, "baseline": bval,
                   "fresh": fval, "direction": direction,
                   "tol_pct": tol}
            if direction == "bool":
                if bval and not fval:
                    regressions.append({**rec, "why": "flipped false"})
                continue
            if bval == 0:
                continue        # no band to scale from
            delta_pct = 100.0 * (fval - bval) / abs(bval)
            rec["delta_pct"] = round(delta_pct, 2)
            bad = delta_pct > tol if direction == "lower" \
                else delta_pct < -tol
            good = delta_pct < -tol if direction == "lower" \
                else delta_pct > tol
            if bad:
                regressions.append(
                    {**rec,
                     "why": f"{delta_pct:+.1f}% beyond the "
                            f"{tol:g}% band ({direction} is better)"})
            elif good:
                improvements.append(rec)
    return {"compared": compared, "regressions": regressions,
            "improvements": improvements, "warnings": warnings,
            "ok": not regressions}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="perf-regression sentry over BENCH_*.json")
    ap.add_argument("--fresh", default=".",
                    help="directory holding the fresh BENCH_*.json")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline path (default <fresh>/{BASELINE_NAME})")
    ap.add_argument("--seed", action="store_true",
                    help="(re)write the baseline from the fresh "
                         "artifacts instead of comparing")
    ap.add_argument("--warn-only", action="store_true",
                    help="report regressions but exit 0 (CI smoke on "
                         "shared machines)")
    ap.add_argument("--json", default=None,
                    help="also write the full report to this path")
    args = ap.parse_args(argv)

    base_path = args.baseline or os.path.join(args.fresh, BASELINE_NAME)
    if args.seed:
        try:
            base = seed_baseline(args.fresh, base_path)
        except (OSError, ValueError) as e:
            print(f"seed failed: {e}", file=sys.stderr)
            return 2
        print(f"seeded {base_path} from "
              f"{len(base['benches'])} bench artifacts")
        return 0

    try:
        baseline = _load(base_path)
    except (OSError, ValueError) as e:
        print(f"baseline unreadable: {e}", file=sys.stderr)
        return 2
    try:
        report = compare(baseline, args.fresh)
    except (OSError, ValueError) as e:
        print(f"fresh artifacts unreadable: {e}", file=sys.stderr)
        return 2

    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    for w in report["warnings"]:
        print(f"warn: {w}")
    for r in report["improvements"]:
        print(f"good: {r['bench']}:{r['metric']} "
              f"{r['baseline']:g} -> {r['fresh']:g} "
              f"({r['delta_pct']:+.1f}%)")
    for r in report["regressions"]:
        print(f"REGRESSION: {r['bench']}:{r['metric']} "
              f"{r['baseline']:g} -> {r['fresh']:g} — {r['why']}")
    print(f"{report['compared']} metrics compared, "
          f"{len(report['regressions'])} regressions, "
          f"{len(report['improvements'])} improvements, "
          f"{len(report['warnings'])} warnings")
    if report["regressions"] and not args.warn_only:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
