"""Per-layer metric readers, one file each, found by the metric's name
(``<name>.py``): ``read(ctx)`` returns the number, or None where the run
holds nothing for it to read. ``ctx`` is the traced run's: the profile
(``trace.reduce``), the window, the spans and the calls' shapes. The
helpers below are shared."""
from __future__ import annotations

import importlib.util
from pathlib import Path

from portbench import flops

HERE = Path(__file__).resolve().parent


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_')}", HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def range_ms(ctx, name: str):
    """Device ms per host instance of a profiler range."""
    r = ctx.get("trace", {}).get("ranges", {}).get(name)
    if not r or not r["count"]:
        return None
    return r["device_ms"] / r["count"]


def roofline(ctx, name: str):
    """100 x the least seconds of a range's recorded calls over the
    device seconds inside it."""
    r = ctx.get("trace", {}).get("ranges", {}).get(name)
    calls = ctx.get("calls", {}).get(name)
    if not r or not calls or r["device_ms"] <= 0:
        return None
    least = sum(flops.least_seconds(f, b) for f, b in calls)
    return 100.0 * least / (r["device_ms"] / 1e3)


def idle_share(ctx):
    if "trace" not in ctx:
        return None
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / ctx["window_s"])
