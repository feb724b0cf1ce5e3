"""CLI invariant checker over an exported span log (CI's dist-smoke).

  python -m repro_torch.obs.check RUN.spans.jsonl \\
      --hosts 2 --require-ops signal,evict

Loads the JSONL span records a traced run exported (``--trace``),
reconstructs the causal span trees, and asserts:

* completeness — every non-root span has a known parent and closed
  (delivered or blackholed);
* the O(log P) hop invariant — every signal release chain's critical
  path is within ``signal_bound(hosts)``;
* (optional) presence — at least one complete trace per required op.

``lost`` markers (a crashed shard's records are gone) and ``retention``
markers (a bounded store evicted old traces before export) may appear
anywhere in the file, interleaved with spans.

Exit codes: 0 all invariants hold; 1 an invariant is violated;
2 the log itself is unreadable (missing file / non-JSON lines) —
distinct so CI can tell a broken export from a broken protocol.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..core.complexity import signal_bound
from .trace import TraceStore


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("spans", help="span JSONL exported by a traced run")
    ap.add_argument("--hosts", type=int, required=True,
                    help="max live host count of the run (sets the "
                         "O(log P) bound)")
    ap.add_argument("--p", type=float, default=0.5)
    ap.add_argument("--require-ops", default=None,
                    help="comma list of root ops that must each have "
                         "at least one complete trace (e.g. "
                         "signal,join,evict)")
    ap.add_argument("--summary", action="store_true",
                    help="print a one-line human summary instead of "
                         "the full JSON report")
    args = ap.parse_args(argv)

    # the exported log already reflects any upstream retention cap:
    # check exactly what is in the file, evict nothing further
    store = TraceStore(max_spans=None)
    try:
        with open(args.spans) as f:
            records = [json.loads(line) for line in f if line.strip()]
    except (OSError, ValueError) as e:
        print(f"span log unreadable: {e}", file=sys.stderr)
        return 2
    store.add(records)

    failures = []
    per_op = {}
    for trace in store.trace_ids():
        op = trace.split(":", 1)[0]
        probs = store.problems(trace)
        if probs:
            failures.extend(probs)
        else:
            per_op[op] = per_op.get(op, 0) + 1

    bound = signal_bound(max(2, args.hosts), p=args.p)
    worst = 0
    for trace in store.trace_ids("signal"):
        d = store.critical_path(trace)
        worst = max(worst, d)
        if d > bound:
            failures.append(f"{trace}: critical path {d} > O(log P) "
                            f"bound {bound} at hosts={args.hosts}")

    if args.require_ops:
        for op in args.require_ops.split(","):
            op = op.strip()
            if op and not per_op.get(op):
                failures.append(f"no complete {op!r} trace in the log")

    if args.summary:
        ops = " ".join(f"{op}={n}" for op, n in sorted(per_op.items()))
        verdict = "OK" if not failures else f"FAIL({len(failures)})"
        print(f"{verdict} spans={len(store.spans)} "
              f"dropped={store.dropped_spans} lost={sorted(store.lost)} "
              f"sig_depth={worst}/{bound} {ops}")
        for msg in failures[:5]:
            print(f"  {msg}")
    else:
        print(json.dumps({
            "spans": len(store.spans),
            "dropped_spans": store.dropped_spans,
            "lost_pids": sorted(store.lost),
            "traces": len(store.trace_ids()),
            "complete_traces_per_op": per_op,
            "blackholed_spans": len(store.blackholed()),
            "signal_bound": bound,
            "max_signal_depth": worst,
            "failures": failures[:20],
            "ok": not failures,
        }, indent=2))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
