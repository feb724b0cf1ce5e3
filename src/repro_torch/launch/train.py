"""Training launcher CLI of the port. Port of ``repro/launch/train.py``
(the single-process path).

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

Not ported yet, and refused with the ROADMAP item that ports them:
``--processes``/``--fabric``/``--chaos*`` (the multi-host runtime,
A.10) and ``--host-devices`` (a simulated host mesh; the port stacks the
team on one device instead).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from ..checkpoint import CheckpointManager
from ..data import SyntheticLM
from ..models.registry import get_api, get_config
from ..optim import AdamW
from ..runtime_elastic import ElasticPhaserRuntime
from ..train.loop import TrainLoop

# options of the reference's CLI the port refuses, with what ports them
NOT_PORTED = {
    "processes": "ROADMAP A.10 (multi-host data plane)",
    "fabric": "ROADMAP A.10 (multi-host data plane)",
    "chaos": "ROADMAP A.10 (multi-host data plane)",
    "chaos_links": "ROADMAP A.10 (multi-host data plane)",
    "chaos_reset": "ROADMAP A.10 (multi-host data plane)",
    "host_devices": "ROADMAP A.10 (the port stacks the team on one "
                    "device; multi-card runs need torch.distributed)",
}


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
                    help="write a Chrome-trace/Perfetto JSON of the run")
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
    # the reference's multi-host options: refused below
    ap.add_argument("--processes", type=int, default=1)
    ap.add_argument("--fabric", default=None)
    ap.add_argument("--chaos", type=int, default=None)
    ap.add_argument("--chaos-links", default=None)
    ap.add_argument("--chaos-reset", type=float, default=0.0)
    ap.add_argument("--host-devices", type=int, default=None)
    args = ap.parse_args(argv)

    for opt_name, item in NOT_PORTED.items():
        if getattr(args, opt_name) != ap.get_default(opt_name):
            ap.error(f"--{opt_name.replace('_', '-')} is not ported yet: "
                     f"{item}")
    events = None
    if args.elastic is not None:
        try:
            events = parse_elastic(args.elastic)
        except ValueError as e:
            ap.error(str(e))
        if any(k == "kill" for evs in events.values() for k, _ in evs):
            ap.error("kill events need --processes > 1, which is not "
                     f"ported yet: {NOT_PORTED['processes']}")

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
