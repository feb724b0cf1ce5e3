"""HostAgent: one process's slice of the multi-host elastic runtime.

Owns the process's ``ShardPhaser`` (control plane) and, when a data
plane is configured, the process's hierarchical sync programs: an
epoch-aware ``ProgramCache`` keyed by the *process-level* collective,
re-committed at every churn epoch boundary so each surviving host
re-lowers its slice of the composed program.

The agent is driven entirely through ``handle(cmd) -> reply`` — the
same dict-command surface whether the coordinator calls it directly
(in-process cluster) or ships frames over sockets (``worker.py``).
torch and the model stack import lazily inside the data-plane handlers,
so a control-plane-only agent (the latency benchmark's workers) never
pays the torch import.

The process's M local ranks are stacked on its one device
(``RankStack``); several host processes may share one card. The flat
bucket buffer crosses the process boundary as a host numpy f32 array,
as in the reference: copied off the device after the local reduce and
onto it again before the apply. Step replies carry the host seconds of
each part (``grads_s``, ``d2h_s``, ``exchange_s`` on the socket fabric,
``h2d_s``, ``apply_s``), synchronized with the device.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from ..core.phaser import SCSL, SNSL
from ..core.skiplist import HEAD
from ..obs.metrics import MetricsRegistry
from .plane import COORD, ShardPhaser, default_owner
from .transport import Endpoint


class HostAgent:
    """``cfg`` (JSON-serializable, identical on every process except
    ``device_slice``):

      seed, p, max_height   — topology identity
      live, demoted         — initial membership view
      proc_kind             — process-level schedule kind
      data                  — None (control-plane only) or the model
                              config: {arch, reduced, layers, batch,
                              seq, lr, steps, local_kind, devices,
                              device_slice, ckpt_dir, device,
                              keep_exchange}

    ``devices`` is the number of ranks stacked on the process's device
    (``device_slice`` ``[start, M]``, the reference's slice of a shared
    device list, gives M too), ``device`` the torch device (default
    ``"cuda"``), ``keep_exchange`` keeps the last socket step's buffer
    before the level-1 exchange and the digest of the one after it for
    ``last_exchange``.
    """

    def __init__(self, pid: int, endpoint: Endpoint, cfg: Dict):
        self.pid = pid
        self.endpoint = endpoint
        self.cfg = cfg
        self.proc_kind = cfg.get("proc_kind", "phaser_scsl")
        self.axis_name = cfg.get("axis", "data")
        self.shard = ShardPhaser(
            pid, endpoint,
            live=cfg.get("live", ()),
            p=cfg.get("p", 0.5), seed=cfg.get("seed", 0),
            max_height=cfg.get("max_height", 32),
            demoted=cfg.get("demoted", ()),
            obs=cfg.get("obs", False))
        # this process's metrics shard (one per agent, so in-process
        # logical hosts stay isolated); merged at the coordinator
        self.metrics = MetricsRegistry()
        if getattr(endpoint, "metrics", None) is None:
            # worker endpoints are built before the agent exists:
            # adopt them here so transport.session.* counters land in
            # this shard and merge cluster-wide through _op_obs
            endpoint.metrics = self.metrics
        self.data_cfg = cfg.get("data")
        self._dp = None            # lazily-built data plane dict
        self._deferred: List = []  # env frames deferred during a step
        self._red_held: List = []  # red frames that beat our step cmd
        self.gen = cfg.get("gen", 0)   # membership incarnation (recovery)
        self.shard.gen = self.gen
        self.shard.net.gen = self.gen
        self._applied: Dict = {"step": -1}   # last applied train step

    # ------------------------------------------------------------ data plane
    def _data_plane(self) -> Dict[str, Any]:
        if self._dp is not None:
            return self._dp
        assert self.data_cfg is not None, "no data plane configured"
        import torch
        from ..collective_exec import (ProgramCache,
                                       build_hier_gradsync_program)
        from ..models.registry import get_api, get_config
        from ..optim import AdamW
        from ..utils import tree_map
        d = self.data_cfg
        cfg = get_config(d.get("arch", "smollm-135m"))
        if d.get("reduced", True):
            cfg = cfg.reduced(**({"n_layers": d["layers"]}
                                 if d.get("layers") else {}))
        api = get_api(cfg)
        opt = AdamW(lr=d.get("lr", 3e-3),
                    warmup=d.get("warmup", 10),
                    total_steps=d.get("steps", 100))
        device = torch.device(d.get("device", "cuda"))
        sl = d.get("device_slice")
        m = sl[1] if sl is not None else d.get("devices", 1)
        local_kind = d.get("local_kind", "phaser_scsl")
        cache = ProgramCache(
            lambda pc: build_hier_gradsync_program(
                api, opt, pc, local_ranks=m, device=device,
                local_kind=local_kind),
            extra_key=("hier", m, local_kind),
            metrics=self.metrics)
        # drawn on the CPU, so a host's parameters do not depend on its
        # device: a card run and a CPU run start from the same values
        params = tree_map(lambda x: x.to(device), api.init_params(
            torch.Generator().manual_seed(d.get("init_seed", 0)), "cpu"))
        opt_state = opt.init(params)
        ckpt = None
        if d.get("ckpt_dir"):
            from ..checkpoint import CheckpointManager
            ckpt = CheckpointManager(d["ckpt_dir"], async_write=False)
        self._dp = {"api": api, "opt": opt, "cfg": cfg, "device": device,
                    "m": m, "cache": cache, "params": params,
                    "opt_state": opt_state, "ckpt": ckpt,
                    "local_kind": local_kind, "pending": None}
        return self._dp

    def _sync(self) -> float:
        """Wait for the device's queued work; returns the host clock."""
        dev = self._dp["device"]
        if dev.type == "cuda":
            import torch
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def _proc_collective(self):
        from ..core.collective import PhaserCollective
        keys = tuple(sorted(self.shard.live))
        return PhaserCollective(len(keys), self.axis_name,
                                kind=self.proc_kind,
                                seed=self.shard.seed, p=self.shard.p,
                                keys=keys,
                                leaf_keys=tuple(sorted(
                                    self.shard.demoted
                                    & self.shard.live)))

    def program_key(self) -> Dict:
        """JSON identity of the current epoch's hierarchical program:
        the elastic ``epoch_key`` (member set = the *local* device
        ranks) extended with the process set — what checkpoint
        manifests must record so resume can pre-compile the
        surviving-host program (not the pre-churn one)."""
        dp = self._data_plane()
        return {"process_set": sorted(self.shard.live),
                "member_set": list(range(dp["m"])),
                "kind": self.proc_kind,
                "local_kind": dp["local_kind"],
                "seed": self.shard.seed, "p": self.shard.p,
                "axis": self.axis_name,
                "leaf_keys": sorted(self.shard.demoted
                                    & self.shard.live)}

    def _local_batch(self, step: int):
        import numpy as np
        from ..data.synthetic import make_batch
        from ..utils import to_device_copy
        dp = self._data_plane()
        d = self.data_cfg
        m = dp["m"]
        # global worker id of (process key, local device) — a process's
        # data stream follows its phaser key, like worker streams in the
        # single-host elastic runtime
        bs = [make_batch(dp["cfg"].vocab_size, d.get("batch", 4),
                         d.get("seq", 64),
                         seed=1000 + self.pid * m + i, step=step)
              for i in range(m)]
        return {k: to_device_copy(np.stack([b[k] for b in bs]),
                                  dp["device"])
                for k in bs[0]}

    # ------------------------------------------------------------- commands
    def handle(self, cmd: Dict) -> Dict:
        op = cmd["op"]
        fn = getattr(self, f"_op_{op}", None)
        assert fn is not None, f"agent {self.pid}: unknown op {op!r}"
        try:
            out = fn(cmd) or {}
        except Exception as e:  # surfaced by the coordinator
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        return {"ok": True, **out}

    def _op_ping(self, c):
        return {"pid": self.pid}

    def _op_create_member(self, c):
        self.shard.create_member(c["new"], c["parent"],
                                 c.get("mode", "SIG_WAIT"))

    def _op_start_insert(self, c):
        self.shard.start_insert(c["new"], c["parent"])

    def _op_drop(self, c):
        self.shard.drop(c["key"])

    def _op_demote(self, c):
        self.shard.demote(c["key"])

    def _op_repromote(self, c):
        self.shard.repromote(c["key"])

    def _op_signal(self, c):
        self.shard.signal(c.get("key", self.pid))

    def _op_note_membership(self, c):
        self.shard.note_membership(c["live"], c["demoted"])

    def _op_force_evict(self, c):
        """Non-cooperative eviction, survivor side: re-seed this shard
        from the surviving membership's oracle at the coordinator's
        released phase, adopt the new generation (fencing the old
        incarnation's in-flight frames), and drop any held step rounds
        from the dead generation."""
        gone = set(self.shard.live) - set(c["live"]) - {self.pid}
        self.shard.rebuild(c["live"], c["demoted"], c["phase"], c["gen"])
        self.gen = c["gen"]
        self._red_held = [f for f in self._red_held
                          if f[2][0] == self.gen]
        self._deferred.clear()   # old-gen envs would be fenced anyway
        # tear down sessions to the evicted peers: unacked ring frames
        # are reaped (their spans close as blackholed) instead of being
        # replayed at a corpse forever
        fp = getattr(self.endpoint, "forget_peer", None)
        if fp is not None:
            for pid in gone:
                fp(pid)
        self.metrics.inc("failure.force_evict")
        return {"gen": self.gen, "phase": c["phase"],
                "live": sorted(self.shard.live)}

    def _op_step_status(self, c):
        """Post-crash consistency probe: which train step this host
        last applied (and its metrics) — the coordinator uses this to
        decide between retrying the step and falling back to a
        checkpoint-consistent resume."""
        return dict(self._applied)

    def hold_red(self, frame) -> None:
        """A peer's reduction round arriving outside our step (worker
        main loop or a status pump): held for the next step's recv."""
        self._red_held.append(frame)

    def _op_status(self, c):
        self.shard.pump()
        for f in self.shard.drain_stray():
            if f[1] == "cmd":
                # raced-in (possibly retransmitted) command: defer to the
                # worker main loop, which dedupes by command id.
                self._deferred.append(f)
            else:
                self.hold_red(f)
        sent, received = self.shard.flight_counters()
        return {"idle": self.shard.net.idle(), "sent": sent,
                "received": received,
                "released": self.shard.released(),
                "max_depth": self.shard.net.max_depth,
                "messages": dict(self.shard.net.sent)}

    def _op_obs(self, c):
        """Drain this shard's span records + metrics snapshot (the
        coordinator collects after every quiescent advance)."""
        return {"spans": self.shard.drain_obs(),
                "metrics": self.metrics.snapshot(),
                "watermarks": self.shard.watermarks.snapshot(),
                "frames": {"sent": self.endpoint.frames_sent,
                           "received": self.endpoint.frames_received}}

    def _op_link_fault(self, c):
        """Install a link-fault window (chaos): each endpoint computes
        its own local wall-clock window from ``dur`` at receipt — no
        shared clock — and auto-heals when it expires, so a heal never
        depends on reaching anyone through the partition."""
        alf = getattr(self.endpoint, "add_link_fault", None)
        if alf is None:
            return {"installed": False}
        # activation grace: the window must not swallow this very
        # command's reply (or the installing RPC degenerates into a
        # wait-for-heal), so it starts a beat after the rep escapes
        now = time.monotonic() + 0.15
        alf(c["a"], c["b"], now, now + float(c["dur"]),
            oneway=bool(c.get("oneway", False)))
        return {"installed": True}

    def _op_link_clear(self, c):
        clf = getattr(self.endpoint, "clear_link_faults", None)
        if clf is not None:
            clf()

    def _op_inject_reset(self, c):
        """Hard-close cached outbound streams (chaos reset storm)."""
        ir = getattr(self.endpoint, "inject_reset", None)
        hit = 0
        if ir is not None:
            for dst in c.get("dsts", []):
                hit += bool(ir(dst))
        return {"reset": hit}

    def _op_flight_flush(self, c):
        """Flush this shard's flight ring to disk (coordinator asks at
        failure edges: cooperative leave, and on every survivor after a
        non-cooperative eviction)."""
        from ..obs.recorder import flight_path
        path = c.get("path") or flight_path(c["dir"], self.pid)
        n = self.shard.flight.flush(path, c.get("reason", "request"))
        return {"path": path, "records": n}

    def _op_derive_epoch(self, c):
        """Boundary: install the membership view, verify this shard's
        partition against the global oracle, fingerprint, and re-commit
        the process-level program cache."""
        self.shard.note_membership(c["live"], c["demoted"])
        sl = self.shard.oracle()
        views = sl.partition(self.shard.owner_of)
        view = views.get(self.pid)
        if view is not None:
            for lid in (SCSL, SNSL):
                d = view.diff(self.shard.local_states(lid))
                assert not d, f"pid {self.pid} lid {lid}: {d}"
        out = {"fingerprint": sl.fingerprint(), "epoch": c.get("index")}
        if self.data_cfg is not None and self.pid in self.shard.live:
            dp = self._data_plane()
            pc = self._proc_collective()
            dp["cache"].get(pc)            # re-lower this host's slice
            out["cache"] = dp["cache"].stats()
            out["program_key"] = self.program_key()
        return out

    # ------------------------------------------------------------ stepping
    def _op_step_local(self, c):
        """Local half: per-rank grads + local reduce -> flat host buffer."""
        import torch
        dp = self._data_plane()
        t0 = time.perf_counter()
        prog = dp["cache"].get(self._proc_collective())
        batch = self._local_batch(c["step"])
        alive = torch.ones((dp["m"],), dtype=torch.float32,
                           device=dp["device"])
        flat, pm = prog.local_grads(dp["params"], dp["opt_state"], batch,
                                    alive)
        t1 = self._sync()
        # a fresh host array: the device buffer is refilled next step
        buf = flat.to("cpu", copy=True).numpy()
        t2 = time.perf_counter()
        dp["pending"] = {"prog": prog, "t0": t0,
                         "loss": float(pm["loss"].sum() / dp["m"]),
                         "times": {"grads_s": t1 - t0, "d2h_s": t2 - t1}}
        return {"buf": buf}

    def _op_step_apply(self, c):
        """Global half: apply the fully-reduced buffer."""
        from ..utils import to_device_copy
        dp = self._data_plane()
        pend = dp["pending"]
        assert pend is not None, "step_apply without step_local"
        dp["pending"] = None
        prog = pend["prog"]
        t0 = time.perf_counter()
        flat = to_device_copy(c["buf"], dp["device"])
        t1 = self._sync()
        new_p, new_o, om = prog.apply(dp["params"], dp["opt_state"], flat)
        dp["params"], dp["opt_state"] = new_p, new_o
        t2 = self._sync()
        if c.get("delay"):
            time.sleep(c["delay"])   # test hook: straggling process
        dt = time.perf_counter() - pend["t0"]
        self.metrics.observe("agent.step_seconds", dt)
        self.shard.watermarks.add_compute_time(self.pid, dt)
        self.shard.flight.event("step", step=int(c.get("step", -1)),
                                dt=round(dt, 6))
        # the reference reads "gnorm", which its AdamW never reports (it
        # reports "grad_norm"): the port reports the norm it clipped by
        out = {"loss": pend["loss"], "dt": dt,
               "gnorm": float(om.get("gnorm", om["grad_norm"])),
               **pend["times"], "h2d_s": t1 - t0, "apply_s": t2 - t1}
        self._applied = {"step": int(c.get("step", -1)), **out}
        return out

    def _op_step(self, c):
        """Whole step with peer-to-peer exchange over the transport
        (socket mode): local grads, the process-level schedule's rounds
        as real frames between the live processes, then apply. Round
        frames carry the membership generation so a step retried after
        crash recovery can never consume a dead incarnation's rounds;
        a coordinator ``ctl`` abort (or the recv deadline) unwinds the
        exchange into an ``aborted`` reply instead of a 300 s hang."""
        import numpy as np
        from .exchange import exchange_schedule
        local = self._op_step_local(c)
        dp = self._data_plane()
        prog = dp["pending"]["prog"]
        pids = list(prog.pc_proc.keys)
        rank = pids.index(self.pid)
        step = c["step"]
        gen = self.gen

        class _StepAbort(Exception):
            pass

        def send(dst, rnd, arr):
            try:
                self.endpoint.send(dst, "red", (gen, step, rnd, arr))
            except (OSError, ConnectionError):
                # peer died mid-step: unwind; the coordinator resolves
                self.metrics.inc("step.send_failed")
                raise _StepAbort("peer send failed")

        def match(payload, src, rnd):
            return (payload[0] == gen and payload[1] == step
                    and payload[2] == rnd)

        def recv(src, rnd):
            for i, f in enumerate(self._red_held):
                if f[0] == src and match(f[2], src, rnd):
                    return self._red_held.pop(i)[2][3]
            deadline = time.monotonic() + c.get("timeout", 300.0)
            while True:
                frame = self.endpoint.recv(timeout=0.2)
                if frame is None:
                    if time.monotonic() >= deadline:
                        raise _StepAbort(f"no round {rnd} from {src}")
                    continue
                fsrc, tag, payload = frame
                if tag == "red":
                    if payload[0] != gen or payload[1] < step:
                        self.metrics.inc("step.stale_red")   # fenced
                    elif fsrc == src and match(payload, src, rnd):
                        return payload[3]
                    else:
                        self._red_held.append(frame)
                elif tag == "ctl":
                    kind = payload[0]
                    if kind == "abort_step" and payload[1] >= step:
                        raise _StepAbort("coordinator abort")
                    # stale abort for an older step: ignore
                elif tag == "env":
                    # stray protocol frame waits until the step ends
                    self._deferred.append(frame)
                elif tag == "cmd":
                    # a retried command while we're mid-step: the reply
                    # the main loop already sent was dropped; park the
                    # frame so the main loop's dedupe cache replays it
                    self._deferred.append(frame)

        t0 = time.perf_counter()
        try:
            buf = exchange_schedule(prog.proc_schedule, rank, pids,
                                    local["buf"], send=send, recv=recv,
                                    metrics=self.metrics)
        except _StepAbort as e:
            dp["pending"] = None
            self.metrics.inc("step.aborted")
            return {"aborted": True, "step": step, "reason": str(e)}
        dp["pending"]["times"]["exchange_s"] = time.perf_counter() - t0
        if self.data_cfg.get("keep_exchange"):
            import hashlib
            dp["last_exchange"] = {
                "step": step, "pids": pids, "local": local["buf"],
                "reduced_sha256": hashlib.sha256(
                    np.ascontiguousarray(buf).view(np.uint8)).hexdigest()}
        return self._op_step_apply({**c, "buf": buf})

    def _op_last_exchange(self, c):
        """The last socket step's host buffer before the level-1 exchange
        and the SHA-256 of the one after it (with ``keep_exchange``): what
        a check runs the central executor over, to hold the two executors
        equal. A digest, not the buffer: a reply's frame holds up this
        host's heartbeat echoes while it crosses the wire."""
        return dict(self._data_plane()["last_exchange"])

    def drain_deferred(self) -> List:
        out, self._deferred = self._deferred, []
        return out

    # --------------------------------------------------------- checkpointing
    def _op_save(self, c):
        dp = self._data_plane()
        assert dp["ckpt"] is not None, "no ckpt_dir configured"
        dp["ckpt"].save(c["step"], dp["params"], dp["opt_state"],
                        extra={"process_set": sorted(self.shard.live)},
                        program_key=self.program_key())
        return {"step": c["step"]}

    def _op_precompile(self, c):
        """Resume pre-compile from a manifest program key: build the
        program for the key's *process set* — the surviving hosts —
        before the first step touches the cache."""
        from ..core.collective import PhaserCollective
        dp = self._data_plane()
        pk = c["program_key"]
        pc = PhaserCollective(len(pk["process_set"]), pk["axis"],
                              kind=pk["kind"], seed=pk["seed"],
                              p=pk["p"],
                              keys=tuple(pk["process_set"]),
                              leaf_keys=tuple(pk.get("leaf_keys", ())))
        before = dp["cache"].stats()["misses"]
        prog = dp["cache"].get(pc)
        return {"compiled": dp["cache"].stats()["misses"] > before,
                "keys": list(prog.pc_proc.keys)}

    def _op_manifest_key(self, c):
        """Read the program key recorded in the checkpoint manifest —
        the process set that was live at save time, i.e. the program a
        resume must pre-compile (manifest-only, no array reads)."""
        dp = self._data_plane()
        assert dp["ckpt"] is not None, "no ckpt_dir configured"
        return {"program_key": dp["ckpt"].program_key(c.get("step")),
                "step": c.get("step", dp["ckpt"].latest_step())}

    def _op_export_state(self, c):
        """Parameters and optimizer state as host numpy trees (bf16
        leaves widened to f32, exactly): the join hand-off's source."""
        dp = self._data_plane()
        return {"params": _host_tree(dp["params"]),
                "opt": _host_tree(dp["opt_state"]._asdict())}

    def _op_import_state(self, c):
        """Adopt another host's ``export_state`` (a joiner, before its
        first step): each leaf cast back to this host's leaf dtype."""
        from ..optim import OptState
        dp = self._data_plane()
        dp["params"] = _device_tree(c["params"], dp["params"])
        dp["opt_state"] = OptState(**_device_tree(
            c["opt"], dp["opt_state"]._asdict()))

    def _op_device_stats(self, c):
        """This process's peak device memory (CUDA only) and the launch
        counts of the kernel wrappers its steps run."""
        import torch
        from ..kernels import bucket_combine as BC
        from ..kernels import flash_attention as FA
        dev = self._data_plane()["device"]
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        return {"peak_bytes": int(peak), "launches": {
            "flash_attention": FA.flash_attention.launches,
            "flash_attention_bwd": FA.flash_attention_bwd.launches,
            "bucket_combine": BC.bucket_combine.launches}}

    def _op_restore(self, c):
        dp = self._data_plane()
        assert dp["ckpt"] is not None, "no ckpt_dir configured"
        from ..optim import OptState
        tpl = {"params": dp["params"], "opt": dp["opt_state"]._asdict()}
        step, tree, extra = dp["ckpt"].restore(tpl, c.get("step"))
        dp["params"] = tree["params"]
        dp["opt_state"] = OptState(**tree["opt"])
        return {"step": step, "extra": extra}

    def _op_loss_probe(self, c):
        """Deterministic probe: loss of the current params on a fixed
        batch — equal across processes iff params stayed replicated."""
        import torch
        from ..data.synthetic import make_batch
        from ..utils import to_device_copy
        dp = self._data_plane()
        b = make_batch(dp["cfg"].vocab_size,
                       self.data_cfg.get("batch", 4),
                       self.data_cfg.get("seq", 64),
                       seed=c.get("seed", 7), step=c.get("step", 0))
        with torch.no_grad():
            loss, _ = dp["api"].loss_fn(
                dp["params"], {k: to_device_copy(v, dp["device"])
                               for k, v in b.items()})
        return {"loss": float(loss)}

    def _op_shutdown(self, c):
        return {"bye": True}


def _host_tree(tree) -> Dict[str, Any]:
    """``{"a/b": numpy leaf}`` of a tensor tree; bf16 widened to f32."""
    import torch
    from ..utils import tree_flatten
    paths, leaves = tree_flatten(tree)
    return {"/".join(p): (x.float() if x.dtype == torch.bfloat16 else x)
            .to("cpu", copy=True).numpy() for p, x in zip(paths, leaves)}


def _device_tree(named: Dict[str, Any], like):
    """Inverse of ``_host_tree``, each leaf on ``like``'s leaf's device
    and in its dtype."""
    from ..utils import to_device_copy, tree_flatten, tree_unflatten
    paths, leaves = tree_flatten(like)
    assert sorted(named) == sorted("/".join(p) for p in paths), \
        "state tree mismatch"
    return tree_unflatten(paths, [
        to_device_copy(named["/".join(p)], x.device).to(x.dtype)
        for p, x in zip(paths, leaves)])
