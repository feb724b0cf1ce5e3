"""Run one cell of the benchmark once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``),
whose ``kind`` picks the general driver (``drivers/<kind>.py``); its
limits are ``limits/<cell>.json``. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics
(``metrics/<name>.py``) from a profile of the window. Every run checks
what its timed path produced against the plain reference
(``reference/``), and prints each number compared beside its limit as
its last lines on standard error and under ``checks`` in the result.

A run needs the CUDA card(s) its cell asks for, and fails without them.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import time
from typing import Any, Callable, Dict, Optional

from . import common


@dataclasses.dataclass
class Run:
    cell: Dict
    cfg_file: Dict
    cfg: Any
    mix: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start_perf: float = 0.0
    # a test's planted fault: called with the driver's program object
    fault: Optional[Callable] = None


def _metrics(bench: Dict, cell: str, res: Dict, trace: bool) -> Dict:
    out = {}
    if not trace:
        for m in bench["end_to_end"]:
            if cell in m.get("workloads", [cell]):
                out[m["name"]] = {"value": res["e2e"][m["name"]],
                                  "unit": m["unit"]}
        return out
    from .metrics import reader
    for m in bench["per_layer"]:
        if cell not in m.get("workloads", [cell]):
            continue
        v = reader(m["name"])(res.get("ctx", {}))
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def judge(nums: Dict, limits: Dict):
    """Each compared number beside its limit, and whether every one is
    within it (a NaN is not)."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()
              if k in limits}
    return checks, all(c["value"] == c["value"] and c["value"] <= c["limit"]
                       for c in checks.values())


def execute(r: Run) -> Dict:
    """The driver's run of ``r`` and the verdict on its numbers."""
    drv = importlib.import_module(f"portbench.drivers.{r.mix['kind']}")
    res = drv.run(r)
    t = time.perf_counter()
    res["checks"], res["correct"] = judge(drv.check(r, res.pop("kept")),
                                          r.limits)
    res["check_s"] = time.perf_counter() - t
    return res


def main(argv=None) -> int:
    t_proc = common.process_start()
    t_start_perf = time.perf_counter() - (time.time() - t_proc)
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the allocator's expandable segments: alternating team sizes leave
    # fixed segments fragmented (see PERF.md); set before CUDA starts
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    bench = common.benchmark()
    cell = common.workload(args.workload)
    cfg_file = common.config(cell["config"])
    common.import_program()
    common.need_cards(cell["chips"])
    r = Run(cell=cell, cfg_file=cfg_file, cfg=common.model_config(cfg_file),
            mix=common.mix(cell["traffic"]),
            limits=common.limits(cell["name"]), seed=args.seed,
            seconds=args.seconds, trace=bool(args.trace),
            t_start_perf=t_start_perf)
    res = execute(r)
    bad = common.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    device = {**common.card_info(),
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if r.trace:
        device["busy_s"] = res["busy_s"]
        device["window_s"] = res["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"],
            "metrics": _metrics(bench, cell["name"], res, r.trace),
            "device": device}
    if r.trace and "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    print(f"portbench: the check took {res['check_s']:.1f} s",
          file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
