"""What every cell's run shares: the checkout's layout, the benchmark's
data files found by name, the program's import, the look for a card and
for JAX, and the result line."""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (from
    /proc/self/stat and /proc/uptime), so set-up counts from it."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> Dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def config(name: str) -> Dict:
    return load_json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> Dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> Dict:
    return load_json(HERE / "limits" / f"{cell}.json")


def import_program():
    """Put the checkout's ``src`` on the path and import the port; a
    checkout without it cannot run a cell."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        raise SystemExit("portbench: the program (src/repro_torch) is not "
                         "in this checkout")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch  # noqa: F401


def need_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        raise SystemExit(f"portbench: the cell needs {n} CUDA device(s); "
                         f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def model_config(cfg_file: Dict):
    """The port's ModelConfig for a configuration file: its arch with
    every dimension the file lists, each checked after the replace."""
    import dataclasses
    from repro_torch.models.registry import get_config
    port = cfg_file["port"]
    cfg = dataclasses.replace(get_config(port["arch"]), **port["dims"])
    for k, v in port["dims"].items():
        assert getattr(cfg, k) == v, (k, getattr(cfg, k), v)
    return cfg


def card_info() -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}
