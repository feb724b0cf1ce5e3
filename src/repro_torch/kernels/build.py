"""Build the CUDA sources under ``repro_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` compiles on its own, with ``nvcc`` for Hopper
(``sm_90a``), into a shared library with a plain C interface under
``build/repro_torch/`` at the repository root, named after the hash of
its source so an edited source rebuilds. The library is loaded with
``ctypes``; no PyTorch header is compiled, which keeps a build to
seconds. The build runs at first use; ``build_all`` starts one ``nvcc``
per source at once, so a cold process pays the slowest compile, not
their sum.

There is no fallback: a missing ``nvcc`` or a failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp, final) or
    None when the library for this source hash already exists."""
    out = library_path(name)
    if out.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = ()) -> Dict[str, str]:
    """Compile every listed source (all by default) in parallel; returns
    ``{name: nvcc output}`` for the sources actually compiled (the
    ``-Xptxas -v`` register and shared-memory report)."""
    names = list(names) or sources()
    with _lock:
        started = {n: _start(n) for n in names}
        logs: Dict[str, str] = {}
        failed: List[str] = []
        for n, job in started.items():
            if job is None:
                continue
            proc, tmp, out = job
            log, _ = proc.communicate()
            logs[n] = log
            if proc.returncode != 0:
                failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
