"""Host-process entry point: ``python -m repro_torch.runtime_dist.worker``.

One OS process of the multi-host runtime. Joins the socket fabric at the
well-known path for its pid, waits for the coordinator's ``init`` command
(which carries the full agent config), then serves the frame loop:

  env  — protocol envelope for a locally-owned actor: ingest + deliver
         (deliveries may send further envelopes out through the fabric)
  cmd  — coordinator command: dispatch to ``HostAgent.handle``, reply
         on the ``rep`` stream. Replies are cached per command id and
         replayed verbatim for a duplicated/retried cmd — every op is
         therefore exactly-once even under at-least-once delivery.
  red  — a peer's reduction round arriving outside a step (the peer is
         already inside its step): held for this process's next step
  ctl  — out-of-band step control (abort); outside a step it is stale
  hb   — heartbeats never reach this loop: the endpoint's reader
         thread echoes them (``hb_echo``), so liveness stays decoupled
         from command latency (a long model build is not a death)

Orphan exit (DESIGN.md §13): if no frame — heartbeats included —
arrives for ``PHASER_ORPHAN_TIMEOUT`` seconds the coordinator is
presumed dead; the worker flushes its span shard to
``<dir>/worker<pid>.spans.jsonl`` and exits with code 2 instead of
spinning forever.

Control-plane-only configs (``data: null``) never import torch — the
latency benchmark spawns these by the dozen.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import OrderedDict, deque

from .agent import HostAgent
from .transport import endpoint_cls

_DEDUPE_CAP = 512       # replay window of cached (cid -> reply) entries


def _flush_spans(agent, directory: str, pid: int) -> None:
    """Salvage this shard's span records to disk before an orphan exit
    (the coordinator that would normally collect them is gone)."""
    try:
        spans = agent.shard.drain_obs() if agent is not None else []
        path = os.path.join(directory, f"worker{pid}.spans.jsonl")
        with open(path, "w") as f:
            for r in spans:
                f.write(json.dumps(r) + "\n")
    except Exception:
        pass                    # best effort: never mask the exit path


def _flush_flight(agent, directory: str, pid: int, reason: str) -> None:
    """Flush the flight ring on a failure edge (crash / orphan exit):
    the bounded window of recent records survives even though the
    coordinator will never collect this shard again."""
    if agent is None:
        return
    try:
        from ..obs.recorder import flight_path
        d = agent.cfg.get("flight_dir") or directory
        agent.shard.flight.event("exit", reason=reason)
        agent.shard.flight.flush(flight_path(d, pid), reason)
    except Exception:
        pass                    # best effort: never mask the exit path


def _send_rep(ep, src: int, cid: int, reply: dict) -> None:
    """A lost reply must not kill the worker: the RPC layer is
    at-least-once, so the coordinator retransmits the command, the cid
    dedupe replays the cached reply, and a transient partition (link
    fault, coordinator restart in flight) heals instead of escalating
    a heal-able outage into a worker crash."""
    from .failure import PeerUnreachable
    try:
        ep.send(src, "rep", (cid, reply))
    except (PeerUnreachable, OSError, ValueError):
        pass


def serve(pid: int, directory: str,
          orphan_timeout: float | None = None,
          fabric: str = "unix") -> int:
    if orphan_timeout is None:
        orphan_timeout = float(os.environ.get("PHASER_ORPHAN_TIMEOUT",
                                              "30"))
    ep = endpoint_cls(fabric)(pid, directory, hb_echo=True)
    agent = None
    pending = []            # env frames that beat the init command
    pending_red = []        # red frames that beat the init command
    done: "OrderedDict[int, dict]" = OrderedDict()   # cid -> reply
    backlog: deque = deque()    # cmd frames deferred during a step
    try:
        while True:
            frame = backlog.popleft() if backlog else ep.recv(timeout=1.0)
            if frame is None:
                if time.monotonic() - ep.last_rx > orphan_timeout:
                    # coordinator silent past the heartbeat horizon:
                    # flush observability state and exit cleanly
                    _flush_spans(agent, directory, pid)
                    _flush_flight(agent, directory, pid, "orphan")
                    return 2
                continue
            src, tag, payload = frame
            if tag == "env":
                if agent is None:
                    pending.append(payload)
                    continue
                agent.shard.net.ingest(payload)
                agent.shard.net.deliver_all()
            elif tag == "red":
                if agent is None:
                    pending_red.append(frame)
                else:
                    agent.hold_red(frame)
            elif tag in ("ctl", "hb"):
                continue        # stale outside a step / unechoed hb
            elif tag == "cmd":
                cid, cmd = payload
                if cid in done:
                    # duplicated or retried command: replay the cached
                    # reply without re-executing (idempotency)
                    _send_rep(ep, src, cid, done[cid])
                    continue
                if cmd["op"] == "init":
                    agent = HostAgent(pid, ep, cmd["cfg"])
                    for env in pending:
                        agent.shard.net.ingest(env)
                    pending.clear()
                    for f in pending_red:
                        agent.hold_red(f)
                    pending_red.clear()
                    agent.shard.net.deliver_all()
                    reply = {"ok": True, "pid": pid}
                elif cmd["op"] == "shutdown":
                    ep.send(src, "rep", (cid, {"ok": True}))
                    return 0
                else:
                    reply = agent.handle(cmd)
                    for f in agent.drain_deferred():
                        if f[1] == "env":
                            agent.shard.net.ingest(f[2])
                        elif f[1] == "cmd":
                            backlog.append(f)
                    agent.shard.net.deliver_all()
                done[cid] = reply
                while len(done) > _DEDUPE_CAP:
                    done.popitem(last=False)
                _send_rep(ep, src, cid, reply)
            else:
                raise AssertionError(f"worker {pid}: bad tag {tag!r}")
    except Exception:
        # crash path: the ring is the only record of what this shard
        # was doing — flush it before the traceback propagates
        _flush_flight(agent, directory, pid, "crash")
        raise
    finally:
        ep.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--orphan-timeout", type=float, default=None)
    ap.add_argument("--fabric", default="unix", choices=["unix", "tcp"])
    args = ap.parse_args(argv)
    return serve(args.pid, args.dir, orphan_timeout=args.orphan_timeout,
                 fabric=args.fabric)


if __name__ == "__main__":
    sys.exit(main())
