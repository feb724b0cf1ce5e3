"""Multi-pod dry-run: trace every (architecture x input-shape) cell on the
production meshes and emit the roofline terms. Port of
``repro/launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k --mesh single          # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results/dryrun                    # the full table

The reference compiles each cell's SPMD program for 256 or 512 host
devices and reads XLA's memory and cost analyses. The port has no
compiler to ask, so it runs rank 0's program instead, on data that does
not exist:

* the mesh is a ``DeviceMesh`` over a ``"fake"`` process group of 256 or
  512 ranks (``launch/mesh.py``), whose collectives move nothing;
* parameters, optimizer state, batch and decode state are DTensors with
  ``meta`` local shards, placed by the sharding rules
  (``sharding/policies.py``); the step (``train/step.py``: forward,
  backward and AdamW; or prefill; or one decode step) runs under
  ``use_rules``, so the models' ``constrain`` hints redistribute as the
  reference's constrain its shardings;
* the kernels take their meta rules (``kernels/meta.py``).

What it reports for rank 0 (x chips for the reference's global totals):

* **argument bytes**: the local shards of parameters, optimizer state,
  batch and decode state, exactly;
* **peak bytes**: argument bytes plus the peak of the live local bytes
  the step allocates (every storage an op returns, freed when the last
  tensor on it dies; the kernels' outputs and workspaces included);
* **FLOPs**: ``FlopCounterMode`` over the local ops, plus the kernels'
  closed forms;
* **HBM bytes**: every local op's input plus output bytes, plus the
  kernels' closed forms. An UNFUSED upper bound: each op is taken to
  read and write device memory, as the reference's count over its CPU
  module's fusions is one (``roofline/analytical.py`` has the lower
  bound of the kernelized path);
* **collective bytes by kind**: the output bytes of every functional
  collective DTensor issues, and ``CommDebugMode``'s op counts. DTensor
  redistributes where GSPMD would have chosen another layout (a head
  split of a sharded projection, a gathered KV window); these are
  reported as they are, not hidden.

A cell whose step raises (an op with no DTensor rule, a kernel that has
no backward) or whose trace runs past ``CELL_SECONDS`` is recorded as
``error`` with the exception, as the reference records its compile
failures.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import signal
import sys
import threading
import time
import traceback
import weakref
from collections import Counter
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ALL_ARCHS, SHAPES_BY_NAME, cell_applicable
from ..kernels import meta as kmeta
from ..models.registry import get_api, get_config
from ..optim import AdamW, OptState
from ..roofline.analysis import Roofline, model_flops
from ..roofline.analytical import analytic_terms
from ..sharding.policies import make_rules
from ..utils import tree_flatten, tree_map, tree_unflatten
from .mesh import HW, fake_world, make_production_mesh

_COLL_KINDS = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_reduce": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
# ops that allocate without moving a byte
_FACTORIES = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided"}


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


class Ledger(TorchDispatchMode):
    """One rank's LOCAL ops inside it: live bytes and their peak, FLOPs
    (counted by a ``FlopCounterMode``'s formulas), the unfused
    device-memory traffic and the collectives' bytes.

    A DTensor op is deferred (``NotImplemented``) to DTensor, which then
    runs its local ops and collectives on the shards with this mode
    still active; the fake tensors of DTensor's sharding propagation are
    not counted. ``args`` are the step's inputs: their storages are
    argument bytes, not the step's allocations."""

    def __init__(self, args=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.hbm = 0
        self.coll: Dict[str, int] = {}
        self.flops = FlopCounterMode(display=False)
        self._args = {t.untyped_storage()._cdata for t in _locals(args)}
        self._seen = set()

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen or key in self._args:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out
        keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            self._track(t)
        self.flops._count_flops(func.overloadpacket, out, args, kwargs)
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            kind = _COLL_KINDS.get(name)
            if kind is not None:
                self.coll[kind] = (self.coll.get(kind, 0)
                                   + kmeta.nbytes(*outs))
        elif name not in _FACTORIES and not all(
                t.untyped_storage()._cdata in keys for t in outs):
            # an op whose outputs all alias its inputs moves nothing
            self.hbm += kmeta.nbytes(*ins) + kmeta.nbytes(*outs)
        return out


def _locals(tree):
    """The local tensors of ``tree``'s tensors (a DTensor's shard)."""
    return [t.to_local() if _is_dtensor(t) else t for t in _tensors(tree)]




def _distribute(spec_tree, pl_tree, mesh, dtype=None):
    """DTensors with ``meta`` local shards: each leaf of ``spec_tree``
    (a global-shape meta tensor) laid out by the matching placements."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    paths, specs = tree_flatten(spec_tree)
    _, pls = tree_flatten(pl_tree) if isinstance(pl_tree, dict) \
        else (None, [pl_tree] * len(specs))

    def one(s, pl):
        local, _ = compute_local_shape_and_global_offset(s.shape, mesh, pl)
        t = torch.empty(local, dtype=dtype or s.dtype, device="meta")
        return DTensor.from_local(t, mesh, pl, run_check=False,
                                  shape=s.shape,
                                  stride=torch.empty(s.shape,
                                                     device="meta").stride())
    return tree_unflatten(paths, [one(s, pl) for s, pl in zip(specs, pls)])


@dataclasses.dataclass
class CellTrace:
    """What one traced step of rank 0 used."""

    argument_bytes: int
    temp_bytes: int              # peak of the live bytes the step allocated
    flops: float                 # local ops + kernels
    hbm_bytes: float             # unfused: local ops + kernels
    coll: Dict[str, int]         # output bytes by collective kind
    coll_counts: Dict[str, int]  # CommDebugMode's op counts
    kernels: Dict[str, Dict]     # the meta rules' closed-form work

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self.temp_bytes


def trace_step(fn, args) -> CellTrace:
    """Run ``fn(*args)`` once under the counters."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    ledger = Ledger(args)
    comm = CommDebugMode()
    with kmeta.count_work() as work, implicit_replication(), comm, ledger:
        out = fn(*args)
        del out
    kflops = sum(w["flops"] for w in work.values())
    kbytes = sum(w["bytes"] for w in work.values())
    counts = {str(k).split(".")[-1]: v
              for k, v in comm.get_comm_counts().items()}
    return CellTrace(argument_bytes=kmeta.nbytes(*_locals(args)),
                     temp_bytes=ledger.peak,
                     flops=float(ledger.flops.get_total_flops() + kflops),
                     hbm_bytes=float(ledger.hbm + kbytes),
                     coll=dict(ledger.coll), coll_counts=counts,
                     kernels=work)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               fsdp=None, moe_mode=None, remat: bool = True,
               microbatches: int = 1, seq_shard: bool = False,
               dp_over_model: bool = False, decode_split_k: bool = False,
               moe_nogroup: bool = False, device_type="cuda"):
    """Trace one (arch x shape x mesh) cell inside ``fake_world``;
    returns (CellTrace or None, meta)."""
    cfg = get_config(arch)
    if moe_nogroup:
        cfg = dataclasses.replace(cfg, moe_group_size=0)
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return None, {"skipped": why}
    api = get_api(cfg)
    mesh = make_production_mesh(multi_pod=multi_pod,
                                device_type=device_type)
    rules = make_rules(mesh, cfg, fsdp=fsdp, moe_mode=moe_mode,
                       seq_shard=seq_shard, dp_over_model=dp_over_model)

    from ..train.step import (build_decode_step, build_prefill_step,
                              build_train_step)
    pspec = api.param_spec()
    if shape.kind == "train":
        opt = AdamW()
        ts = build_train_step(api, opt, rules=rules, remat=remat,
                              microbatches=microbatches)
        params = _distribute(pspec, ts.param_sh, mesh)
        opt_state = OptState(
            step=_distribute(torch.empty((), dtype=torch.int32,
                                         device="meta"),
                             ts.opt_sh.step, mesh),
            mu=_distribute(pspec, ts.opt_sh.mu, mesh, torch.float32),
            nu=_distribute(pspec, ts.opt_sh.nu, mesh, torch.float32))
        args = (params, opt_state,
                _distribute(api.input_specs(shape), ts.batch_sh, mesh))
        fn = ts.fn
    elif shape.kind == "prefill":
        fn, param_sh = build_prefill_step(api, rules=rules)
        from ..sharding.policies import batch_specs
        from ..sharding.rules import spec_to_placements
        bspec = api.input_specs(shape)
        bpl = tree_map(lambda s: spec_to_placements(s, mesh),
                       batch_specs(rules, bspec))
        args = (_distribute(pspec, param_sh, mesh),
                _distribute(bspec, bpl, mesh))
    else:  # decode
        fn, (param_sh, st_sh, b_sh) = build_decode_step(
            api, rules=rules, batch=shape.global_batch,
            window=shape.seq_len, split_k=decode_split_k)
        args = (_distribute(pspec, param_sh, mesh),
                _distribute(api.decode_state_spec(shape.global_batch,
                                                  shape.seq_len),
                            st_sh, mesh),
                _distribute(api.input_specs(shape), b_sh, mesh))
    tr = trace_step(fn, args)
    return tr, {"cfg": cfg, "shape": shape, "mesh": mesh, "rules": rules}


# A cell's trace that runs longer than this is recorded as an error:
# DTensor's search for a redistribution plan of a dim sharded over two
# mesh axes (the multi-pod batch) can run for hours in a backward.
CELL_SECONDS = 300


@contextlib.contextmanager
def _time_limit(seconds: float):
    """Raise ``TimeoutError`` in the body after ``seconds`` (main thread
    only: elsewhere no limit)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(signum, frame):
        raise TimeoutError(f"the cell's trace ran past {seconds} s")
    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             **kw):
    t0 = time.time()
    chips = 512 if multi_pod else 256
    res = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    try:
        with fake_world(chips), _time_limit(CELL_SECONDS):
            tr, meta = lower_cell(arch, shape_name, multi_pod=multi_pod,
                                  **kw)
        if tr is None:
            res["status"] = "skipped"
            res["why"] = meta["skipped"]
            return res
        cfg, shape = meta["cfg"], meta["shape"]
        rl = Roofline(
            flops=tr.flops * chips, hbm_bytes=tr.hbm_bytes * chips,
            coll_bytes=sum(tr.coll.values()) * chips, chips=chips,
            peak_flops=HW["peak_flops_bf16"], hbm_bw=HW["hbm_bw"],
            ici_bw=HW["ici_bw"],
            coll_detail={k: v * chips for k, v in tr.coll.items()})
        mf = model_flops(cfg, shape)
        tp = 1 if kw.get("dp_over_model") else 16
        res.update({
            "status": "ok",
            "t_trace_s": round(time.time() - t0, 1),
            "bytes_per_device": tr.temp_bytes,
            "argument_bytes": tr.argument_bytes,
            "peak_bytes": tr.peak_bytes,
            "fits": tr.peak_bytes <= HW["hbm_bytes"],
            "roofline": rl.to_dict(),
            "collective_counts": tr.coll_counts,
            "kernels": tr.kernels,
            "analytic": analytic_terms(cfg, shape, HW, chips, tp=tp),
            "model_flops": mf,
            "model_flops_ratio": mf / rl.flops if rl.flops else None,
            "roofline_fraction": rl.fraction_of_roofline(mf),
        })
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        res["status"] = "error"
        res["error"] = f"{type(e).__name__}: {e}"
        res["trace"] = traceback.format_exc()[-2000:]
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="write JSONL here")
    ap.add_argument("--fsdp", default=None,
                    choices=[None, "on", "off"], nargs="?")
    ap.add_argument("--moe-mode", default=None, choices=[None, "ep", "tp"],
                    nargs="?")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--dp-over-model", action="store_true",
                    help="fold the model axis into pure DP")
    ap.add_argument("--decode-split-k", action="store_true",
                    help="shard the KV window over the model axis")
    ap.add_argument("--moe-nogroup", action="store_true",
                    help="ungrouped MoE dispatch")
    ap.add_argument("--device-type", default="cuda",
                    help="the DeviceMesh's device type (the traced "
                         "shards are meta either way)")
    args = ap.parse_args(argv)

    cells = []
    archs = ALL_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = (list(SHAPES_BY_NAME) if (args.all or args.shape is None)
              else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for mp in meshes:
        for a in archs:
            for s in shapes:
                cells.append((a, s, mp))

    kw = dict(fsdp={"on": True, "off": False}.get(args.fsdp),
              moe_mode=args.moe_mode, remat=not args.no_remat,
              microbatches=args.microbatches, seq_shard=args.seq_shard,
              dp_over_model=args.dp_over_model,
              decode_split_k=args.decode_split_k,
              moe_nogroup=args.moe_nogroup, device_type=args.device_type)
    out_f = open(args.out, "a") if args.out else None
    n = Counter()
    try:
        for a, s, mp in cells:
            res = run_cell(a, s, multi_pod=mp, **kw)
            n[res["status"]] += 1
            line = json.dumps(res)
            print(line if res["status"] != "error"
                  else json.dumps({k: v for k, v in res.items()
                                   if k != "trace"}), flush=True)
            if out_f:
                out_f.write(line + "\n")
                out_f.flush()
    finally:
        if out_f:
            out_f.close()
    print(f"# dry-run: {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['error']} errors", file=sys.stderr)
    return 1 if n["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
