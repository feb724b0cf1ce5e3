"""The readings the limits are set from (``limits/<cell>.json``), on the
card at the cell's own size: the program's numbers on many seeds, and
on a few seeds the control's (the reference in float8) and each fault's
that the cell can have, each against the float32 reference, and each
reading's verdict by the run's own comparison against
``limits/<cell>.json`` (``run.judge``). Training needs no measured
window, so each seed runs set-up and the checked steps only.

    python -m portbench.calibrate --workload <cell> --seeds 1 2 3 ... \\
        --controls 3
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import time

from . import common
from .run import Run, judge


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3,
                    help="how many of the seeds also read the control "
                         "and the faults")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--rate", type=float, default=None,
                    help="a serving mix's arrival rate instead of its own "
                         "(the sweep for the knee)")
    args = ap.parse_args(argv)
    import os
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    cell = common.workload(args.workload)
    cfg_file = common.config(cell["config"])
    common.import_program()
    common.need_cards(cell["chips"])
    mix = common.mix(cell["traffic"])
    if args.rate is not None:
        mix["rate_per_s"] = args.rate
    drv = importlib.import_module(f"portbench.drivers.{mix['kind']}")
    for i, seed in enumerate(args.seeds):
        r = Run(cell=cell, cfg_file=cfg_file,
                cfg=common.model_config(cfg_file), mix=mix,
                limits=common.limits(cell["name"]), seed=seed,
                seconds=args.seconds, trace=False,
                t_start_perf=time.perf_counter())
        t = time.perf_counter()
        rows = drv.calibrate(r, controls=i < args.controls)
        for kind, nums in rows.items():
            line = {"cell": cell["name"], "seed": seed, "reading": kind,
                    **nums, "s": round(time.perf_counter() - t, 3)}
            checks, ok = judge(nums, r.limits)
            if checks:
                line["verdict"] = {"correct": ok, "checks": checks}
            print(json.dumps(line), flush=True)
        gc.collect()
        # one process reads every seed: the shapes are warm after the
        # first (the readings need no timing)
        mix = dict(mix, warm_lengths=[])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
