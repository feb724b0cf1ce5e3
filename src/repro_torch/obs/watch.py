"""Terminal dashboard over a ``--live-out`` heartbeat stream.

``python -m repro_torch.obs.watch RUN.live.jsonl`` tails the frame file the
coordinator appends to mid-run (``obs/live.py``) and renders the
cluster's live state: phase watermarks per host with the wait-time
decomposition, detector phi scores, RPC latency quantiles, counter
deltas, and the membership event log. ``--once`` renders the latest
frame and exits (CI smoke); without it the view refreshes in place
until interrupted.

Everything renders from the frames alone — the watcher never talks to
the run, so it can attach to a live file, a finished one, or a copy.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

from .live import read_frames

_CLEAR = "\x1b[2J\x1b[H"


def _fmt_wm(rank: str, h: Dict, phi: Optional[float],
            retired: bool = False) -> str:
    tag = "dead" if retired else (h.get("mode") or "?")
    line = (f"  {rank:>5}  {tag:<8} sig={h.get('signal', -1):>5} "
            f"wait={h.get('wait', -1):>5} "
            f"wait_s={h.get('wait_s', 0.0):>8.3f} "
            f"sig_s={h.get('signal_s', 0.0):>7.3f} "
            f"comp_s={h.get('compute_s', 0.0):>8.3f}")
    if phi is not None:
        line += f" phi={phi:>6.2f}"
    return line


def render(frames: List[Dict], *, tail_events: int = 8) -> str:
    """One screenful from the frame history (the last frame carries the
    state; earlier ones only contribute the event history)."""
    if not frames:
        return "(no frames yet)"
    f = frames[-1]
    lines = []
    age = time.time() - f.get("ts", 0)
    lines.append(f"live phaser run — step {f.get('step')} "
                 f"phase {f.get('phase')} epoch {f.get('epoch')} "
                 f"gen {f.get('gen')}  "
                 f"[{len(f.get('live', []))} hosts, frame {len(frames)}, "
                 f"{age:.1f}s ago]")
    phi = {int(k): v for k, v in (f.get("phi") or {}).items()}
    wm = f.get("wm") or {}
    if wm:
        lines.append("  host   mode     signal      wait   blocked(s) "
                     " signal(s)  compute(s)")
        for rank in sorted(wm, key=int):
            lines.append(_fmt_wm(rank, wm[rank], phi.get(int(rank))))
    for rank, h in sorted((f.get("retired") or {}).items(),
                          key=lambda kv: int(kv[0])):
        lines.append(_fmt_wm(rank, h, None, retired=True))
    rpc = f.get("rpc") or {}
    if rpc:
        lines.append("  rpc latency: " + "  ".join(
            f"{op} p50={q['p50'] * 1e3:.2f}ms p99={q['p99'] * 1e3:.2f}ms"
            for op, q in sorted(rpc.items())))
    deltas = f.get("deltas") or {}
    if deltas:
        top = sorted(deltas.items(), key=lambda kv: -abs(kv[1]))[:6]
        lines.append("  deltas: " + "  ".join(f"{k}+{v:g}"
                                              for k, v in top))
    events: List = []
    for fr in frames:
        events.extend(fr.get("events") or [])
    if events:
        lines.append("  events: " + "  ".join(
            f"[{e[0]}] {e[1]}:{e[2]}" for e in events[-tail_events:]))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="terminal dashboard over a --live-out frame stream")
    ap.add_argument("path", help="the run's --live-out JSONL file")
    ap.add_argument("--once", action="store_true",
                    help="render the latest state once and exit")
    ap.add_argument("--interval", type=float, default=0.5,
                    help="refresh period in follow mode (seconds)")
    ap.add_argument("--json", action="store_true",
                    help="with --once: dump the last frame as JSON "
                         "instead of the rendered view")
    args = ap.parse_args(argv)

    if args.once:
        try:
            frames = read_frames(args.path)
        except OSError as e:
            print(f"unreadable: {e}", file=sys.stderr)
            return 2
        if not frames:
            print("no frames", file=sys.stderr)
            return 1
        try:
            if args.json:
                print(json.dumps(frames[-1], indent=2))
            else:
                print(render(frames))
        except BrokenPipeError:
            # piped through head/grep: a closed reader is not an error
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0

    frames: List[Dict] = []
    try:
        while True:
            try:
                frames = read_frames(args.path)
            except OSError:
                frames = []
            sys.stdout.write(_CLEAR + render(frames) + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
