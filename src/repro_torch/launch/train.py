"""Training launcher CLI of the port. Port of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt

``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain
kernel versions (tests, a quick look without a card). ``--reduced``
trains the family-reduced config.

Elastic mode attaches the phaser-epoch control plane and drives
membership churn from a schedule of events, e.g.:

  ... --workers 4 --elastic "join@30,join@35,fail@60,leave@80"

Each event is ``kind@step`` (kind: join | leave | fail; leave/fail may
pin a worker with ``kind:wid@step``). The loop swaps its step at every
epoch boundary and prints the epoch log. Gradients sync through the
engine's program (the epoch's ranks stacked on the device, the schedule
run by the ``bucket_combine`` kernel) whenever the batch divides the
team; ``--device-collective`` requires it, ``--overlap-sync`` runs the
pipelined round order.

``--pipeline-stages S`` (DESIGN.md §6) runs the 2-D program: the stacked
blocks split over S stage rows, microbatches (``--microbatches`` is the
1F1B depth; the batch must divide workers x microbatches) flow through
the wave-synchronous 1F1B schedule, and each stage row's grads sync over
the team by the epoch's schedule. ``--interleave v`` runs the
interleaved 1F1B order (v non-contiguous chunks per stage; the scan
length must divide S*v and ``--microbatches`` by S). Every epoch
boundary re-proves the wave order against the SIG/WAIT phaser actors:

  ... --reduced --workers 2 --pipeline-stages 2 --microbatches 2 \
      --batch 12 --seq 32 --elastic "join@3,leave@6"

``--processes N`` (DESIGN.md §11) runs the MULTI-HOST elastic runtime
instead: N host processes, each with ``--host-devices M`` ranks (default
1) stacked on its device, the phaser skip list partitioned over them
(the coordinator owns HEAD), and gradient sync running hierarchically:
each process's ranks reduce on its device through ``bucket_combine``,
then the process-level phaser schedule runs between the processes over
the transport. ``--fabric inproc`` (default) keeps the hosts in this
process (deterministic); ``socket`` and ``tcp`` spawn one OS process
each (AF_UNIX or TCP loopback; several may share one card) with the
heartbeat failure detector. Elastic events then churn whole hosts, and
``kill`` crashes one non-cooperatively:

  ... --processes 3 --host-devices 2 --fabric socket \\
      --elastic "join@4,kill@8"

A joining host adopts the lowest live host's parameters and optimizer
state. Checkpoints record the surviving process set in the manifest so
``--resume`` pre-compiles the surviving-host program.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math

from ..checkpoint import CheckpointManager
from ..data import SyntheticLM
from ..models.registry import get_api, get_config
from ..optim import AdamW
from ..runtime_elastic import ElasticPhaserRuntime
from ..train.loop import TrainLoop


def parse_elastic(spec: str):
    """'join@30,fail@60,leave:2@80' -> {30: [("join", None)], ...}.

    ``kill`` (``--processes`` mode only) is a hard crash: the host is
    SIGKILLed (socket fabric) or dropped without protocol (in-process),
    and the coordinator must *detect* and recover non-cooperatively —
    unlike ``fail``, which still runs the cooperative eviction."""
    events = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "@" not in item:
            raise ValueError(f"elastic event {item!r}: expected kind@step "
                             "(e.g. join@30, leave:2@80)")
        kind, step = item.split("@", 1)
        wid = None
        if ":" in kind:
            kind, w = kind.split(":", 1)
            wid = int(w)
        if kind not in ("join", "leave", "fail", "kill"):
            raise ValueError(f"elastic event kind {kind!r}: expected "
                             "join | leave | fail | kill")
        events.setdefault(int(step), []).append((kind, wid))
    return events


def run_processes(args, ap):
    """--processes N: the multi-host elastic runtime. Every host owns
    ``--host-devices`` ranks stacked on ``--device``; with the default
    in-process fabric the hosts live in this process, with ``--fabric
    socket|tcp`` each is a real OS process (and the coordinator runs the
    heartbeat failure detector). Churn happens at whole-host
    granularity; ``kill`` events crash hosts non-cooperatively."""
    from ..runtime_dist import (DistCoordinator, InprocCluster,
                                SocketCluster, StepInconsistent)
    n = args.processes
    chaos = None
    if args.chaos is not None:
        from ..runtime_dist import ChaosConfig
        chaos = ChaosConfig(seed=args.chaos, p_reset=args.chaos_reset)
    elif args.chaos_reset > 0:
        # reset storms without the RPC drop/dup/delay chaos: exercises
        # the session layer in isolation
        from ..runtime_dist import ChaosConfig
        chaos = ChaosConfig(seed=13, p_drop=0.0, p_dup=0.0, p_delay=0.0,
                            p_reset=args.chaos_reset)
    link_faults = {}
    if args.chaos_links is not None:
        if args.fabric not in ("socket", "tcp"):
            ap.error("--chaos-links needs --fabric socket|tcp")
        from ..runtime_dist import parse_link_spec
        try:
            for f in parse_link_spec(args.chaos_links):
                link_faults.setdefault(f["step"], []).append(f)
        except ValueError as e:
            ap.error(str(e))
    m = max(1, args.host_devices or 1)      # ranks per host process
    per_dev_batch = max(1, args.batch // (n * m))

    def data_for(pid):
        return {"arch": args.arch, "reduced": args.reduced,
                "layers": args.layers, "batch": per_dev_batch,
                "seq": args.seq, "lr": args.lr,
                "warmup": min(20, args.steps // 5),
                "steps": args.steps, "devices": m,
                "device": args.device, "ckpt_dir": args.ckpt_dir,
                "local_kind": "phaser_scsl"}

    if args.fabric in ("socket", "tcp"):
        cluster = SocketCluster(hb_interval=args.heartbeat_interval,
                                failure_timeout=args.failure_timeout,
                                chaos=chaos,
                                fabric=("tcp" if args.fabric == "tcp"
                                        else "unix"))
    else:
        cluster = InprocCluster(chaos=chaos)

    events = {}
    if args.elastic is not None:
        try:
            events = parse_elastic(args.elastic)
        except ValueError as e:
            ap.error(str(e))
    obs = bool(args.trace or args.metrics_out or args.live_out)
    rt = DistCoordinator(cluster, n, seed=args.seed,
                         proc_kind=args.sync_kind, data_for=data_for,
                         obs=obs, live_out=args.live_out,
                         flight_dir=args.flight_dir)
    start = 0
    if args.resume and args.ckpt_dir:
        mk = rt.cluster.call(min(rt.live),
                             {"op": "manifest_key"})["program_key"]
        if mk is not None:
            # the manifest records the process set live at save time;
            # a naive restart boots the original set — shed the rest
            # so resume pre-compiles the surviving-host program
            for pid in sorted(set(rt.live) - set(mk["process_set"])):
                rt.request_leave(pid, step=0)
            out = rt.resume()
            start = out["step"]
            print(f"# resumed at step {start}; manifest process_set="
                  f"{mk['process_set']} compiled={out['compiled']}")
    metrics = []
    for step in range(start, args.steps):
        for f in link_faults.get(step, []):
            # bounded wall-clock window with local auto-heal timers at
            # every endpoint: the heal fires even while the partition
            # stalls this very loop
            rt.cluster.inject_link_fault(
                f["a"], f["b"], duration=f["dur"], oneway=f["oneway"])
            print(f"# step {step}: link fault "
                  f"{f['a']}{'->' if f['oneway'] else '|'}"
                  f"{f['b'] if f['b'] is not None else '*'} "
                  f"for {f['dur']}s")
        for kind, wid in events.get(step, []):
            if kind == "join":
                rt.request_join(step=step)
            elif kind == "kill":
                # hard crash: no protocol, no goodbye — the coordinator
                # must detect the silence and evict non-cooperatively
                victim = wid if wid is not None else max(rt.live)
                if hasattr(rt.cluster, "kill_pid"):
                    rt.cluster.kill_pid(victim)
                else:
                    rt.cluster.kill_host(victim)
            else:
                victim = wid if wid is not None else max(rt.live)
                rt.request_leave(victim, fail=(kind == "fail"),
                                 step=step)
        t0 = rt.obs.timeline.now() if obs else 0.0
        try:
            out = rt.train_step(step)
        except StepInconsistent as e:
            # params diverged across survivors: only a checkpoint-
            # consistent resume restores the replicated invariant
            if not args.ckpt_dir:
                raise
            rep = rt.resume()
            print(f"# step {step}: {e}; resumed from checkpoint at "
                  f"step {rep['step']}")
            out = rt.train_step(step)
        rt.advance(step=step)
        if obs:
            rt.obs.timeline.complete("train.step", t0,
                                     args={"step": step,
                                           "hosts": len(rt.live)})
        loss = sum(r["loss"] for r in out.values()) / len(out)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            metrics.append({"step": step, "loss": loss,
                            "hosts": len(rt.live),
                            "epoch": rt.epoch.index})
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            rt.save_checkpoint(step + 1)
    if args.ckpt_dir:
        rt.save_checkpoint(args.steps)
    st = rt.control_stats()
    for mrow in metrics:
        print(json.dumps(mrow))
    print(json.dumps({"control_plane": {
        "live": st["live"], "epochs": rt.epoch.index + 1,
        "remote_frames": st["remote_frames"],
        "critical_path": st["critical_path"],
        "events": [[e.step, e.kind, e.pid] for e in rt.events]}}))
    rt.close()                       # final obs collection rides close()
    if obs:
        rt.export_obs(args.trace, args.metrics_out)
        print(json.dumps({"obs": rt.obs.summary()}))
    if not metrics:
        print("# no steps to run (checkpoint already at --steps)")
        return 0
    first, last = metrics[0]["loss"], metrics[-1]["loss"]
    print(f"# loss {first:.4f} -> {last:.4f} "
          f"({'DECREASED' if last < first else 'NOT DECREASED'})")
    # a short resume tail (a couple of steps after the checkpoint) is
    # loss noise on the reduced configs — gate those on finiteness only
    if len(metrics) < 4:
        return 0 if math.isfinite(last) else 1
    return 0 if last < first else 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="override the config's layer count (e.g. to "
                         "make the scan axis divide stages*interleave)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=4,
                    help="initial elastic worker-group size")
    ap.add_argument("--elastic", default=None,
                    help='churn schedule, e.g. "join@30,fail@60"')
    ap.add_argument("--sync-kind", default="phaser_scsl",
                    choices=["phaser_scsl", "recursive_doubling",
                             "halving_doubling", "xla_psum"],
                    help="per-epoch gradient-sync schedule")
    ap.add_argument("--device-collective", action="store_true",
                    help="require gradient sync through the engine's "
                         "program (default: whenever the batch divides "
                         "the team)")
    ap.add_argument("--overlap-sync", action="store_true",
                    help="pipelined round order over the readiness "
                         "groups (engine path)")
    ap.add_argument("--trace", default=None,
                    help="write a Chrome-trace/Perfetto JSON of the run; "
                         "with --processes the control plane's span log "
                         "lands in a sibling .spans.jsonl")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics-registry JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    ap.add_argument("--pipeline-stages", type=int, default=1,
                    help="pipeline parallelism: split the stacked blocks "
                         "over S stage rows and run the 1F1B wave "
                         "schedule with --microbatches as its depth "
                         "(engine path)")
    ap.add_argument("--interleave", type=int, default=1,
                    help="virtual stages per stage row: the interleaved "
                         "1F1B schedule (v non-contiguous chunks each; "
                         "needs --microbatches divisible by the stages)")
    ap.add_argument("--processes", type=int, default=1,
                    help="multi-host elastic runtime: N host processes, "
                         "each with --host-devices ranks stacked on its "
                         "device; the skip-list control plane partitions "
                         "over them and gradient sync runs "
                         "hierarchically (local bucket_combine reduce, "
                         "then the process-level schedule). Elastic "
                         "events churn whole hosts.")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="with --processes: ranks stacked on each host "
                         "process's device (default 1)")
    ap.add_argument("--fabric", default="inproc",
                    choices=["inproc", "socket", "tcp"],
                    help="--processes transport: in-process hosts "
                         "(deterministic), real OS processes over "
                         "AF_UNIX sockets, or over TCP loopback (same "
                         "session layer and failure detection)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="inject seeded transport faults (RPC drop/dup "
                         "+ bounded env delay/reorder; DESIGN.md §13)")
    ap.add_argument("--chaos-links", default=None, metavar="SPEC",
                    help="link-level chaos on the socket fabrics: "
                         "'A|B@STEP+DUR' (symmetric partition, healing "
                         "after DUR seconds) or 'A->B@STEP+DUR' (one-way "
                         "link kill); ';'-separated, '-1'/'coord' = "
                         "coordinator, '*' = everyone else")
    ap.add_argument("--chaos-reset", type=float, default=0.0,
                    metavar="P",
                    help="socket fabrics: per-frame probability of a "
                         "connection reset on cmd/env sends (the session "
                         "layer must reconnect + replay)")
    ap.add_argument("--heartbeat-interval", type=float, default=0.5,
                    help="socket fabric: coordinator heartbeat period "
                         "(seconds)")
    ap.add_argument("--failure-timeout", type=float, default=10.0,
                    help="socket fabric: hard silence floor before a "
                         "host is declared dead")
    ap.add_argument("--live-out", default=None,
                    help="with --processes: append live heartbeat "
                         "frames to this JSONL file; tail it with "
                         "`python -m repro_torch.obs.watch`")
    ap.add_argument("--flight-dir", default=None,
                    help="with --processes: directory where per-process "
                         "flight-recorder rings are flushed at failure "
                         "edges (*.flight.jsonl)")
    args = ap.parse_args(argv)

    if args.processes > 1:
        return run_processes(args, ap)
    if args.host_devices:
        ap.error("--host-devices sizes a host process of --processes > 1 "
                 "(a single process stacks its whole team on one device)")
    events = None
    if args.elastic is not None:
        try:
            events = parse_elastic(args.elastic)
        except ValueError as e:
            ap.error(str(e))
        if any(k == "kill" for evs in events.values() for k, _ in evs):
            ap.error("kill events need --processes > 1 (hard host "
                     "crashes only exist in the multi-host runtime)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(**({"n_layers": args.layers}
                             if args.layers else {}))
    elif args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    api = get_api(cfg)
    opt = AdamW(lr=args.lr, warmup=min(20, args.steps // 5),
                total_steps=args.steps)
    data = SyntheticLM(vocab=cfg.vocab_size, batch=args.batch,
                       seq=args.seq, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    runtime = None
    pipeline = args.pipeline_stages > 1 or args.interleave > 1
    if (args.elastic is not None or args.device_collective
            or args.overlap_sync or pipeline):
        # the engine's programs are keyed by the runtime's epochs (a
        # static team is just a single epoch)
        runtime = ElasticPhaserRuntime(args.workers, seed=args.seed,
                                       kind=args.sync_kind)
    timeline = metrics_reg = None
    if args.trace or args.metrics_out:
        from ..obs import MetricsRegistry, Timeline
        timeline = Timeline()
        metrics_reg = MetricsRegistry()
    loop = TrainLoop(api=api, opt=opt, data=data, ckpt=ckpt,
                     ckpt_every=args.ckpt_every,
                     microbatches=args.microbatches,
                     timeline=timeline, metrics=metrics_reg,
                     runtime=runtime, elastic_events=events or {},
                     device_collective=(True if args.device_collective
                                        or args.overlap_sync or pipeline
                                        else None),
                     overlap_sync=args.overlap_sync,
                     pipeline_stages=args.pipeline_stages,
                     interleave=args.interleave, device=args.device)
    try:
        loop.run(args.steps, resume=args.resume)
    except ValueError as e:
        print(f"# elastic schedule error: {e}")
        return 2
    if args.trace:
        timeline.save(args.trace)
    if args.metrics_out:
        from ..obs import MetricsRegistry
        with open(args.metrics_out, "w") as f:
            json.dump({"metrics": MetricsRegistry.merge(
                [metrics_reg.snapshot()])}, f, indent=2)
    for m in loop.metrics_log:
        print(json.dumps(m))
    for e in loop.epoch_log:
        print(json.dumps({"epoch_boundary": e}))
    if not loop.metrics_log:
        print("# no steps to run (checkpoint already at --steps)")
        return 0
    first = loop.metrics_log[0]["loss"]
    last = loop.metrics_log[-1]["loss"]
    print(f"# loss {first:.4f} -> {last:.4f} "
          f"({'DECREASED' if last < first else 'NOT DECREASED'})")
    return 0 if last < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
