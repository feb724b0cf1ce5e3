"""Atomic, async-capable checkpointing for fault-tolerant restart. Port
of ``repro/checkpoint/manager.py``, with the same layout.

Layout: <dir>/step_000123/ holds one .npy per leaf plus a manifest.json
(leaf names, data-pipeline state, the epoch's program key). A checkpoint
directory is committed by the atomic rename of its temp dir, so a crash
mid-write never leaves a readable but corrupt checkpoint. Writes can run
on a background thread (the device-to-host snapshot is taken at
``save``; only the file I/O is deferred).

Leaf names join the tree path with ``_`` in ``jax.tree_util`` order
(dict keys sorted), as the reference's do. numpy has no bfloat16: a
bf16 leaf is stored as its raw 16-bit pattern (uint16) and the manifest
records its dtype under ``dtypes``, so a restore is bit for bit.
Reading the reference's checkpoints is not a goal.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import tree_flatten, tree_unflatten


def _flatten_with_names(tree) -> List[Tuple[str, Any]]:
    paths, leaves = tree_flatten(tree)
    return [("_".join(str(k) for k in p), leaf)
            for p, leaf in zip(paths, leaves)]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _from_numpy(a: np.ndarray, dtype: Optional[str],
                like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
        if dtype == "bfloat16" else torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------------- save
    def save(self, step: int, params, opt_state=None,
             extra: Optional[Dict] = None,
             program_key: Optional[Dict] = None) -> None:
        """Snapshot to host memory now; write (possibly async) after.
        ``program_key`` is the epoch's program-cache identity, stored in
        the manifest so a resume can build that program first."""
        self.wait()           # at most one outstanding async write
        snap_tree = {"params": params}
        if opt_state is not None:
            snap_tree["opt"] = opt_state._asdict() \
                if hasattr(opt_state, "_asdict") else opt_state
        snap, dtypes = {}, {}
        for name, leaf in _flatten_with_names(snap_tree):
            snap[name] = _to_numpy(leaf)      # device -> host copy (sync)
            if leaf.dtype == torch.bfloat16:
                dtypes[name] = "bfloat16"
        manifest = {
            "step": step,
            "leaves": sorted(snap),
            "dtypes": dtypes,
            "extra": extra or {},
            "program": program_key,
            "time": time.time(),
        }

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step:09d}")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            for name, arr in snap.items():
                np.save(os.path.join(tmp, name + ".npy"), arr)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)             # atomic commit
            self._gc()

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def program_key(self, step: Optional[int] = None) -> Optional[Dict]:
        """The program-cache key recorded at ``step`` (default latest),
        or None. Reads only the manifest."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.dir, f"step_{step:09d}", "manifest.json")
        with open(path) as f:
            return json.load(f).get("program")

    def restore(self, template, step: Optional[int] = None
                ) -> Tuple[int, Any, Dict]:
        """Restore into the structure of ``template`` ({"params":..,
        "opt":..} tree), each leaf on its template leaf's device. Returns
        (step, tree, extra)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        named = _flatten_with_names(template)
        if sorted(n for n, _ in named) != manifest["leaves"]:
            raise ValueError("checkpoint/template structure mismatch")
        dtypes = manifest.get("dtypes", {})
        leaves = [_from_numpy(np.load(os.path.join(d, name + ".npy")),
                              dtypes.get(name), like)
                  for name, like in named]
        return step, tree_unflatten(tree_flatten(template)[0], leaves), \
            manifest["extra"]
