"""The port's multi-host elastic runtime (``repro_torch.runtime_dist``)
against the JAX package's (``repro.runtime_dist``).

Control plane (``data: None``): the same seeds, churn, crashes and
chaos run through both packages' ``DistCoordinator`` over
``InprocCluster`` / ``FaultyInprocFabric`` (deterministic) and must
agree exactly: every epoch (index, phase, members, fingerprint), the
event list, ``control_stats()``, fault counters, black-hole
bookkeeping and, with obs on, every span record of the causal trees,
each window's ``check_signal_hops`` verdict and the watermark counters.
Wall-clock fields (wait seconds, RPC latencies) are left out.

Data plane: 3 hosts x 2 ranks of reduced smollm (2 layers, f32, CPU)
against the reference's ``DistCoordinator`` in a subprocess over 8
host devices, from the same parameters, through ``join`` then
``fail``: per-host losses of every step and the final loss probes
within 2e-5 (sums in another order), with the reference's behaviour on
a join (the joiner keeps its initial state: the port's hand-off is
faked away). With the hand-off the replicas stay bitwise equal on every
host. The in-process and socket fabrics give
bitwise equal losses and probes through a join and a failure. The
hierarchical program's local buffer and update against the reference's
``build_hier_gradsync_program`` within 1e-5 of the largest value, and
against the flat program within 1e-5.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.runtime_dist as ref_rd
import repro_torch.runtime_dist as port_rd
from repro.obs import check_signal_hops as ref_check_signal_hops
from repro_torch.obs import check_signal_hops

ROOT = Path(__file__).resolve().parents[1]
PKGS = {"reference": ref_rd, "port": port_rd}


def _coord(pkg, n, *, chaos=None, **kw):
    cl = pkg.InprocCluster(chaos=pkg.ChaosConfig(**chaos)
                           if chaos is not None else None)
    return pkg.DistCoordinator(cl, n, seed=kw.pop("seed", 0), **kw)


# ------------------------------------------------------ control scenarios
def _boot_advance(pkg, tmp):
    rt = _coord(pkg, 4)
    before = rt.control_stats()
    rt.advance(step=0)
    return rt, {"boot_stats": before}


def _churn_lifecycle(pkg, tmp):
    rt = _coord(pkg, 3)
    pid = rt.request_join(step=0)
    rt.advance(step=0)
    rt.request_demote(pid, step=1)
    rt.advance(step=1)
    rt.request_repromote(pid, step=2)
    rt.advance(step=2)
    rt.request_leave(1, fail=True, step=3)
    rt.advance(step=3)
    rt.advance(step=4)
    return rt, {}


def _evict_blackhole(pkg, tmp):
    rt = _coord(pkg, 4)
    rt.request_leave(1, step=0)
    rt.advance(step=0)
    rt.request_join(step=1)
    rt.advance(step=1)
    return rt, {}


def _strike_escalation(pkg, tmp):
    rt = _coord(pkg, 3)
    evicted = []
    for step in range(4):
        evicted += rt.record_step_times(step, {0: 1.0, 1: 1.0, 2: 10.0},
                                        slack=3.0, demote_after=2,
                                        evict_after=3)
        rt.advance(step=step)
        if evicted:
            break
    return rt, {"evicted": evicted}


def _kill_host(pkg, tmp):
    rt = _coord(pkg, 4)
    rt.advance(step=0)
    rt.cluster.kill_host(2)
    for s in range(1, 4):
        rt.advance(step=s)
    return rt, {}


def _kill_pending_join(pkg, tmp):
    rt = _coord(pkg, 3)
    rt.request_join(step=0)
    rt.cluster.kill_host(1)
    for s in range(4):
        rt.advance(step=s)
    return rt, {}


def _chaos_sweep(seed):
    def run(pkg, tmp):
        import random
        rng = random.Random(seed)
        chaos = dict(seed=seed, p_drop=0.0, p_dup=0.0,
                     p_delay=0.2 + 0.6 * rng.random(),
                     delay_ticks=1 + rng.randrange(5))
        rt = _coord(pkg, 4, chaos=chaos)
        victim = rng.choice([1, 2, 3])
        kill_at = rng.randrange(1, 4)
        releases = []
        for s in range(6):
            if s == kill_at:
                rt.cluster.kill_host(victim)
            if s == 2 and victim != 3:
                rt.request_join(step=s)
            releases.append(rt.advance(step=s))
        assert all(b > a for a, b in zip(releases, releases[1:]))
        assert victim not in rt.live
        return rt, {"releases": releases}
    return run


def _chaos_obs_churn(pkg, tmp):
    rt = _coord(pkg, 4, chaos=dict(seed=5, p_drop=0.0, p_dup=0.0,
                                   p_delay=0.4, delay_ticks=3), obs=True)
    rt.advance(step=0)
    rt.request_join(step=1)
    rt.advance(step=1)
    rt.cluster.kill_host(1)
    for s in range(2, 6):
        rt.advance(step=s)
    return rt, {}


def _traced_churn(pkg, tmp):
    rt = _coord(pkg, 4, obs=True)
    rt.advance(step=0)
    pid = rt.request_join(step=1)
    rt.advance(step=1)
    rt.request_demote(pid, step=2)
    rt.advance(step=2)
    rt.request_repromote(pid, step=3)
    rt.advance(step=3)
    rt.request_leave(1, fail=True, step=4)
    rt.advance(step=4)
    return rt, {}


def _blackholed_spans(pkg, tmp):
    rt = _coord(pkg, 4, obs=True)
    rt.advance(step=0)
    rt.request_leave(1, fail=True, step=1)
    rt.advance(step=1)
    rt.request_join(step=2)
    rt.advance(step=2)
    return rt, {}


def _capped_store(pkg, tmp):
    rt = _coord(pkg, 3, obs=True)
    rt.obs.store.max_spans = 20
    for s in range(5):
        rt.advance(step=s)
    return rt, {}


def _flight_kill(pkg, tmp):
    fdir = str(tmp / "flight")
    rt = _coord(pkg, 4, obs=True, flight_dir=fdir)
    rt.advance(step=0)
    rt.cluster.kill_host(2)
    rt.advance(step=1)
    rt.request_leave(1, step=2)
    rt.advance(step=2)
    files = {}
    for name in sorted(os.listdir(fdir)):
        recs = [json.loads(line) for line in open(os.path.join(fdir, name))]
        # wall-clock stamps differ between runs; the records do not
        files[name] = [{k: v for k, v in r.items() if k not in ("t", "dt")}
                       for r in recs]
    return rt, {"flight": files}


def _live_frames(pkg, tmp):
    out = str(tmp / "run.live.jsonl")
    rt = _coord(pkg, 3, live_out=out)
    for s in range(3):
        rt.advance(step=s)
    rt.cluster.kill_host(1)
    rt.advance(step=3)
    return rt, {"live_out": out}


SCENARIOS = {
    "boot_advance": _boot_advance,
    "churn_lifecycle": _churn_lifecycle,
    "evict_blackhole": _evict_blackhole,
    "strike_escalation": _strike_escalation,
    "kill_host": _kill_host,
    "kill_pending_join": _kill_pending_join,
    **{f"chaos_seed_{s}": _chaos_sweep(s) for s in range(1, 7)},
    "chaos_obs_churn": _chaos_obs_churn,
    "traced_churn": _traced_churn,
    "blackholed_spans": _blackholed_spans,
    "capped_store": _capped_store,
    "flight_kill": _flight_kill,
    "live_frames": _live_frames,
}

# runs whose causal trees the reference's tests hold complete
COMPLETE_TREES = ("traced_churn", "blackholed_spans", "capped_store")
# per-host watermark fields that are counters (the rest are seconds)
WM_COUNTS = ("signal", "wait", "mode", "outstanding")


def _wm(view):
    return {int(r): {k: h.get(k) for k in WM_COUNTS}
            for r, h in view.items()}


def _digest(pkg, rt, extra) -> dict:
    """Everything deterministic a control-plane run leaves behind."""
    d = {"epochs": [(e.index, e.phase_start, e.live, e.demoted,
                     e.fingerprint) for e in rt.epochs],
         "events": [(e.step, e.kind, e.pid) for e in rt.events],
         "released": rt.shard.released(), "gen": rt.gen,
         "live": sorted(rt.live),
         "faults": rt.cluster.fault_counters()}
    st = rt.control_stats()
    st.pop("obs", None)
    d["stats"] = st
    nets = [rt.shard.net] + [rt.cluster.agents[p].shard.net
                             for p in sorted(rt.cluster.agents)]
    d["dropped"] = [(sorted(n.dropped), n.black_holed) for n in nets]
    rt.close()
    if rt.obs is not None:
        hub = rt.obs
        recs = hub.span_records()
        d["spans"] = recs
        d["hop_checks"] = hub.hop_check_log
        d["verdict"] = (check_signal_hops if pkg is port_rd
                        else ref_check_signal_hops)(
            [r for r in recs if r["ev"] != "retention"], 5)
        d["critical_paths"] = {t: hub.store.critical_path(t)
                               for t in hub.store.trace_ids()}
        d["problems"] = [p for t in hub.store.traces()
                         for p in hub.store.problems(t)]
        s = dict(hub.summary())
        s.pop("watermarks")
        d["summary"] = s
        d["watermarks"] = (_wm(hub.watermarks.view),
                           _wm(hub.watermarks.retired))
        counters = hub.merged_metrics()["counters"]
        d["counters"] = {k: v for k, v in counters.items()
                         if not k.startswith("rpc.")}
    if "live_out" in extra:
        # frames are rate-limited by the wall clock: compare the last
        # one (forced at close) and the order of all of them
        from repro_torch.obs import read_frames
        frames = read_frames(extra.pop("live_out"))
        phases = [f["phase"] for f in frames]
        assert phases == sorted(phases)
        f = frames[-1]
        d["last_frame"] = [f["step"], f["phase"], f["epoch"], f["gen"],
                           f["live"], sorted(f.get("retired", {})),
                           {k: {c: h.get(c) for c in ("signal", "wait")}
                            for k, h in f["wm"].items()}]
    d.update(extra)
    return d


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_control_plane_matches_reference(name, tmp_path):
    """Fingerprints, events, control stats, fault counters, span trees,
    hop verdicts and watermark counters equal the reference's."""
    got = {}
    for label, pkg in PKGS.items():
        (tmp_path / label).mkdir()
        rt, extra = SCENARIOS[name](pkg, tmp_path / label)
        got[label] = json.loads(json.dumps(_digest(pkg, rt, extra),
                                           default=str))
    ref, port = got["reference"], got["port"]
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k] == ref[k], k
    if name in COMPLETE_TREES:
        assert port["problems"] == []


# ------------------------------------------------------------ data plane
LAYERS, B, S, STEPS = 2, 2, 16, 6
DATA = {"arch": "smollm-135m", "reduced": True, "layers": LAYERS,
        "batch": B, "seq": S, "lr": 3e-3, "warmup": 2, "steps": STEPS,
        "local_kind": "phaser_scsl"}
CHURN = {"2": [["join", None]], "4": [["fail", 1]]}     # 3 -> 4 -> 3

REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.collective_exec import build_hier_gradsync_program
from repro.core.collective import PhaserCollective
from repro.data.synthetic import make_batch
from repro.models.registry import get_api, get_config
from repro.optim import AdamW
from repro.runtime_dist import DistCoordinator, InprocCluster

out, spec = sys.argv[1], json.loads(sys.argv[2])
slot = {}

def data_for(pid):
    if pid not in slot:
        slot[pid] = min(set(range(4)) - set(slot.values()))
    return dict(spec["data"], devices=8, device_slice=[slot[pid] * 2, 2])

rt = DistCoordinator(InprocCluster(), 3, seed=0, data_for=data_for)
losses = []
for s in range(spec["steps"]):
    for kind, pid in spec["churn"].get(str(s), []):
        if kind == "join":
            rt.request_join(step=s)
        else:
            rt.request_leave(pid, fail=kind == "fail", step=s)
    r = rt.train_step(s)
    losses.append({str(p): v["loss"] for p, v in r.items()})
    rt.advance(step=s)
res = {"losses": losses,
       "probes": {str(p): rt.cluster.call(p, {"op": "loss_probe"})["loss"]
                  for p in sorted(rt.live)},
       "cache": {str(p): rt.cluster.agents[p]._dp["cache"].stats()
                 for p in sorted(rt.live)},
       "events": [[e.step, e.kind, e.pid] for e in rt.events],
       "epochs": [[e.index, list(e.live), e.fingerprint,
                   e.program_key] for e in rt.epochs]}
rt.close()

# the program alone: host 1's local buffer over its 2 devices, and one
# update from it
d = spec["data"]
cfg = get_config("smollm-135m").reduced(n_layers=d["layers"])
api = get_api(cfg)
# a first lr of 1e-4, as the train tests' one-step comparisons: Adam's
# first step divides each gradient by its own magnitude
opt = AdamW(lr=1e-3, warmup=10, total_steps=20)
params = api.init_params(jax.random.key(0))
prog = build_hier_gradsync_program(
    api, opt, PhaserCollective(3, "data", kind="phaser_scsl", seed=0,
                               keys=(0, 1, 2)),
    local_devices=jax.devices()[2:4])
bs = [make_batch(cfg.vocab_size, d["batch"], d["seq"], seed=1000 + 2 + i,
                 step=0) for i in range(2)]
batch = {k: jnp.asarray(np.stack([b[k] for b in bs])) for k in bs[0]}
flat, pm = prog.local_grads(params, opt.init(params), batch,
                            jnp.ones((2,), jnp.float32))
new_p, _, om = prog.apply(params, opt.init(params), flat)
arrs = {"flat": np.asarray(flat), "loss": np.asarray(pm["loss"]),
        "grad_norm": np.asarray(om["grad_norm"])}
for path, leaf in jax.tree_util.tree_flatten_with_path(new_p)[0]:
    arrs["params/" + "/".join(p.key for p in path)] = np.asarray(leaf)
np.savez(out + ".npz", **arrs)
res["meta"] = {k: int(v) for k, v in prog.meta.items()}
with open(out + ".json", "w") as f:
    json.dump(res, f)
"""


SOCKET_SCRIPT = r"""
import json, sys
from repro_torch.runtime_dist import (DistCoordinator, InprocCluster,
                                      SocketCluster)
spec = json.loads(sys.argv[1])

def data_for(pid):
    return dict(spec["data"], devices=2, device="cpu")

def run(cluster):
    rt = DistCoordinator(cluster, 3, seed=0, data_for=data_for)
    losses, probes = [], []
    for s in range(spec["steps"]):
        for kind, pid in spec["churn"].get(str(s), []):
            if kind == "join":
                rt.request_join(step=s)
            else:
                rt.request_leave(pid, fail=True, step=s)
        r = rt.train_step(s)
        losses.append({str(p): v["loss"] for p, v in r.items()})
        rt.advance(step=s)
        probes.append({str(p): rt.cluster.call(
            p, {"op": "loss_probe"})["loss"] for p in sorted(rt.live)})
    out = {"losses": losses, "probes": probes,
           "events": [[e.step, e.kind, e.pid] for e in rt.events],
           "epochs": [[e.index, list(e.live), e.fingerprint]
                      for e in rt.epochs]}
    rt.close()
    return out

# heartbeats at the default period, and a silence floor no loaded test
# host reaches: a host is declared dead only if it really died
print(json.dumps({
    "inproc": run(InprocCluster()),
    "socket": run(SocketCluster(failure_timeout=300.0))}))
"""


SOCKET_CHURN = {"2": [["join", None]], "4": [["fail", 3]]}


def _yield_cpu():
    """Run a subprocess (and its workers) at a lower priority: the suite's
    timing-bound socket tests run beside it."""
    os.nice(10)


@pytest.fixture(scope="module")
def subprocess_runs(tmp_path_factory):
    """Started side by side: the reference's multi-host data plane (3
    hosts x 2 devices, join then fail) and its hierarchical program
    alone in an 8-host-device subprocess, and the port's in-process and
    socket runs in another."""
    d = tmp_path_factory.mktemp("dist_runs")
    src = str(ROOT / "src")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(d / "ref"),
         json.dumps({"data": DATA, "steps": STEPS, "churn": CHURN})],
        env=dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=_yield_cpu)
    sock = subprocess.Popen(
        [sys.executable, "-c", SOCKET_SCRIPT,
         json.dumps({"data": DATA, "steps": STEPS,
                     "churn": SOCKET_CHURN})],
        env=dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=_yield_cpu)
    out = {}
    s_out, s_err = sock.communicate(timeout=300)
    out["fabrics"] = ((sock.returncode, s_err[-4000:]) if sock.returncode
                      else json.loads(s_out.strip().splitlines()[-1]))
    _, r_err = ref.communicate(timeout=600)
    assert ref.returncode == 0, r_err[-4000:]
    with open(d / "ref.json") as f:
        out["reference"] = json.load(f)
    out["reference"]["arrays"] = dict(np.load(d / "ref.npz"))
    return out


@pytest.fixture(scope="module")
def reference_dist(subprocess_runs):
    return subprocess_runs["reference"]


@pytest.fixture(scope="module")
def jax_params():
    import jax
    from repro.models.registry import get_api as ref_get_api
    from repro.models.registry import get_config as ref_get_config
    cfg = ref_get_config("smollm-135m").reduced(n_layers=LAYERS)
    return jax.tree_util.tree_map(
        np.asarray, ref_get_api(cfg).init_params(jax.random.key(0)))


def _port_cluster(jax_params):
    """An ``InprocCluster`` whose hosts start from the reference's
    initial parameters (``jax.random`` cannot be reproduced in torch),
    and whose joiners keep them, as the reference's do: the join
    hand-off's two commands are answered without running."""
    from repro_torch.interop import params_from_jax

    class Cluster(port_rd.InprocCluster):
        def add_host(self, pid, cfg):
            super().add_host(pid, cfg)
            dp = self.agents[pid]._data_plane()
            dp["params"] = params_from_jax(jax_params, dp["cfg"],
                                           device="cpu")
            dp["opt_state"] = dp["opt"].init(dp["params"])

        def call(self, pid, cmd, **kw):
            if cmd["op"] in ("export_state", "import_state"):
                return {"ok": True, "params": None, "opt": None}
            return super().call(pid, cmd, **kw)
    return Cluster()


def _drive(rt, churn=CHURN, steps=STEPS, kill=None, probe_every=False):
    """Run ``steps`` steps through ``churn`` (``kill`` crashes a host
    non-cooperatively): per-step per-host losses, and the loss probes
    after every step (or only the last)."""
    losses, probes = [], []
    for s in range(steps):
        for kind, pid in churn.get(str(s), []):
            if kind == "join":
                rt.request_join(step=s)
            elif kind == "kill":
                kill(rt, pid)
            else:
                rt.request_leave(pid, fail=kind == "fail", step=s)
        r = rt.train_step(s)
        losses.append({str(p): v["loss"] for p, v in r.items()})
        rt.advance(step=s)
        if probe_every or s == steps - 1:
            probes.append({str(p): rt.cluster.call(
                p, {"op": "loss_probe"})["loss"] for p in sorted(rt.live)})
    return losses, probes


def test_data_plane_matches_reference(reference_dist, jax_params):
    """3 hosts x 2 ranks, join then fail, the reference's join
    behaviour: per-host losses of every step and the final probes within
    2e-5; the same events, epochs, program keys and cache counts."""
    rt = port_rd.DistCoordinator(
        _port_cluster(jax_params), 3, seed=0,
        data_for=lambda pid: dict(DATA, devices=2, device="cpu"))
    losses, probes = _drive(rt)
    cache = {str(p): rt.cluster.agents[p]._dp["cache"].stats()
             for p in sorted(rt.live)}
    events = [[e.step, e.kind, e.pid] for e in rt.events]
    epochs = [[e.index, list(e.live), e.fingerprint, e.program_key]
              for e in rt.epochs]
    rt.close()
    ref = reference_dist
    assert events == ref["events"] == [[2, "join", 3], [4, "fail", 1]]
    assert epochs == ref["epochs"]
    assert cache == ref["cache"]
    assert [sorted(x) for x in losses] == [sorted(x) for x in ref["losses"]]
    for got, want in zip(losses, ref["losses"]):
        for p in want:
            assert abs(got[p] - want[p]) <= 2e-5, (p, got, want)
    for p, want in ref["probes"].items():
        assert abs(probes[-1][p] - want) <= 2e-5, (p, probes, want)
    # the reference's joiner trains from the initial parameters beside
    # hosts that have moved on: its replica never agrees again
    assert ref["probes"]["3"] != ref["probes"]["0"]


def test_hier_program_matches_reference(reference_dist, jax_params):
    """``build_hier_gradsync_program`` alone: host 1's locally reduced
    buffer over 2 ranks and one update from it against the reference's
    shard_map program, within 1e-5 of each array's largest value."""
    from repro_torch.collective_exec import build_hier_gradsync_program
    from repro_torch.core.collective import PhaserCollective
    from repro_torch.data import make_batch
    from repro_torch.interop import params_from_jax
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.optim import AdamW
    from repro_torch.utils import tree_flatten
    cfg = get_config("smollm-135m").reduced(n_layers=LAYERS)
    api = get_api(cfg)
    opt = AdamW(lr=1e-3, warmup=10, total_steps=20)
    params = params_from_jax(jax_params, cfg, device="cpu")
    prog = build_hier_gradsync_program(
        api, opt, PhaserCollective(3, "data", kind="phaser_scsl", seed=0,
                                   keys=(0, 1, 2)),
        local_ranks=2, device="cpu")
    bs = [make_batch(cfg.vocab_size, B, S, seed=1000 + 2 + i, step=0)
          for i in range(2)]
    batch = {k: torch.tensor(np.stack([b[k] for b in bs])) for k in bs[0]}
    flat, pm = prog.local_grads(params, opt.init(params), batch,
                                torch.ones(2))
    new_p, _, om = prog.apply(params, opt.init(params), flat)
    want = reference_dist["arrays"]
    assert prog.meta == reference_dist["meta"]
    for got, w in ((flat.numpy(), want["flat"]),
                   (pm["loss"].numpy(), want["loss"]),
                   (om["grad_norm"].numpy(), want["grad_norm"])):
        assert np.abs(got - w).max() <= 1e-5 * max(1.0, np.abs(w).max())
    # every rank's row holds the local sum
    stacked, red = prog.last["stacked"], prog.last["reduced"]
    assert torch.equal(red[0], red[1])
    torch.testing.assert_close(red[0], stacked.sum(0), rtol=1e-6,
                               atol=1e-6)
    for path, leaf in zip(*tree_flatten(new_p)):
        w = want["params/" + "/".join(path)]
        assert np.abs(leaf.numpy() - w).max() <= 1e-5 * max(
            1.0, np.abs(w).max()), path


def test_hier_program_matches_flat_program():
    """The two-level sync of 3 hosts x 2 ranks (the level-1 rounds run
    centrally on the host buffers) against the flat program over the
    same 6 ranks and batches: parameters after one step within 1e-5."""
    from repro_torch.collective_exec import (build_gradsync_program,
                                             build_hier_gradsync_program)
    from repro_torch.core.collective import PhaserCollective
    from repro_torch.data import make_batch
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.optim import AdamW
    from repro_torch.utils import tree_flatten
    cfg = get_config("smollm-135m").reduced(n_layers=LAYERS)
    api = get_api(cfg)
    opt = AdamW(lr=1e-3, warmup=10, total_steps=20)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    st = opt.init(params)
    bs = [make_batch(cfg.vocab_size, B, S, seed=1000 + r, step=0)
          for r in range(6)]
    pc = PhaserCollective(3, "data", kind="phaser_scsl", seed=0,
                          keys=(0, 1, 2))
    hier = build_hier_gradsync_program(api, opt, pc, local_ranks=2,
                                       device="cpu")
    bufs = {}
    for h in range(3):
        batch = {k: torch.tensor(np.stack([bs[2 * h + i][k]
                                           for i in range(2)]))
                 for k in bs[0]}
        flat, _ = hier.local_grads(params, st, batch, torch.ones(2))
        bufs[h] = flat.clone().numpy()
    red = port_rd.run_schedule_rounds(hier.proc_schedule, bufs)
    assert all(np.array_equal(red[0], red[h]) for h in (1, 2))
    hp, _, hom = hier.apply(params, st, torch.tensor(red[0]))
    flat_prog = build_gradsync_program(
        api, opt, PhaserCollective(6, "data", kind="phaser_scsl", seed=0),
        device="cpu", stacked=True)
    batch = {k: torch.tensor(np.stack([b[k] for b in bs])) for k in bs[0]}
    fp, _, fpm = flat_prog.step(params, st, batch)
    assert abs(float(hom["grad_norm"]) - float(fpm["grad_norm"][0])) \
        <= 1e-5 * float(fpm["grad_norm"][0])
    for (path, a), b in zip(zip(*tree_flatten(hp)), tree_flatten(fp)[1]):
        assert (a - b).abs().max() <= 1e-5 * max(1.0, b.abs().max()), path


def test_join_handoff_keeps_replicas_bitwise_equal():
    """With the hand-off a joiner adopts the lowest live host's state:
    after every step each live host's loss probe is bitwise the
    others', and each host's program cache missed once per process set
    it was live in."""
    rt = port_rd.DistCoordinator(
        port_rd.InprocCluster(), 3, seed=0,
        data_for=lambda pid: dict(DATA, devices=2, device="cpu"))
    _, probes = _drive(rt, probe_every=True)
    for row in probes:
        assert len(set(row.values())) == 1, row
    sets = {0: 3, 2: 3, 3: 2}        # {0,1,2}, {0,1,2,3}, {0,2,3}
    for p, n in sets.items():
        assert rt.cluster.agents[p]._dp["cache"].stats()["misses"] == n
    rt.close()


def test_inproc_and_socket_fabrics_bitwise_equal(subprocess_runs):
    """One run per fabric in one subprocess (the socket hosts are real
    worker processes over AF_UNIX): a join with its state hand-off over
    the wire, then the joiner's failure. Every step's per-host losses
    and loss probes are bitwise equal across the two fabrics (the
    level-1 exchange is exact, the local halves are the same CPU code),
    and the probes are bitwise equal across hosts. The run asserts
    nothing on the wall clock: no host dies, and the detector's silence
    floor is far beyond any stall of a loaded test host (the SIGKILL
    path is the in-process ``kill`` cases' and ``chip_smoke.py``'s)."""
    out = subprocess_runs["fabrics"]
    assert isinstance(out, dict), out
    a, b = out["inproc"], out["socket"]
    assert a["events"] == b["events"] == [[2, "join", 3], [4, "fail", 3]]
    assert a["epochs"] == b["epochs"]
    assert a["losses"] == b["losses"]
    assert a["probes"] == b["probes"]
    for row in a["probes"]:
        assert len(set(row.values())) == 1, row


def test_resume_after_eviction_precompiles_surviving_host_program(tmp_path):
    """The checkpoint manifest's program key records the process set
    live at save time. A naive restart boots the original host set;
    resume reads the manifest, sheds the evicted host and pre-compiles
    the surviving-host program, so the first boundary after restore is a
    pure cache hit."""
    ckpt = str(tmp_path / "ckpt")

    def data_for(pid):
        return dict(DATA, devices=2, device="cpu", ckpt_dir=ckpt)

    rt = port_rd.DistCoordinator(port_rd.InprocCluster(), 3, seed=0,
                                 data_for=data_for)
    for s in range(2):
        rt.train_step(s)
        rt.advance(step=s)
    rt.request_leave(2, fail=True, step=2)
    rt.advance(step=2)
    assert rt.epoch.live == (0, 1)
    rt.train_step(3)
    rt.save_checkpoint(4)
    pk = rt.cluster.call(0, {"op": "manifest_key"})["program_key"]
    assert pk["process_set"] == [0, 1], pk
    probe = {p: rt.cluster.call(p, {"op": "loss_probe"})["loss"]
             for p in sorted(rt.live)}
    rt.close()

    rt2 = port_rd.DistCoordinator(port_rd.InprocCluster(), 3, seed=0,
                                  data_for=data_for)
    mk = rt2.cluster.call(0, {"op": "manifest_key"})["program_key"]
    for pid in sorted(set(rt2.live) - set(mk["process_set"])):
        rt2.request_leave(pid, step=0)
    out = rt2.resume()
    assert out["step"] == 4 and out["program_key"]["process_set"] == [0, 1]
    assert out["compiled"] == {0: True, 1: True}, out
    probe2 = {p: rt2.cluster.call(p, {"op": "loss_probe"})["loss"]
              for p in sorted(rt2.live)}
    assert probe2 == probe
    stats = {p: rt2.cluster.agents[p]._dp["cache"].stats() for p in (0, 1)}
    rt2.advance(step=4)
    for p in (0, 1):
        after = rt2.cluster.agents[p]._dp["cache"].stats()
        assert after["misses"] == stats[p]["misses"], (p, after)
        assert after["hits"] > stats[p]["hits"], (p, after)
    rt2.train_step(4)
    rt2.close()


def test_train_cli_processes_inproc_kill_and_span_check(tmp_path, capsys):
    """``--processes 3 --host-devices 2`` in-process on the CPU with a
    join and a crash: the control plane's events, and the exported span
    log passes ``obs.check`` with the failure op."""
    from repro_torch.launch import train as launch_train
    from repro_torch.obs import check
    trace = str(tmp_path / "run.trace.json")
    rc = launch_train.main([
        "--reduced", "--layers", "2", "--device", "cpu", "--steps", "6",
        "--batch", "12", "--seq", "16", "--processes", "3",
        "--host-devices", "2", "--elastic", "join@2,kill@4",
        "--trace", trace])
    out = capsys.readouterr().out
    assert rc in (0, 1), out
    cp = next(json.loads(l)["control_plane"] for l in out.splitlines()
              if l.startswith('{"control_plane"'))
    assert cp["events"] == [[2, "join", 3], [4, "dead", 3]]
    assert cp["live"] == [0, 1, 2] and cp["epochs"] == 3
    assert check.main([str(tmp_path / "run.trace.spans.jsonl"), "--hosts",
                       "3", "--require-ops", "signal,failure"]) == 0


# ------------------------------------------------------------- transport
def _endpoints(rd, cls_name, **kw):
    from repro_torch.obs import MetricsRegistry
    d = rd.fabric_dir()
    cls = getattr(rd, cls_name)
    ma, mb = MetricsRegistry(), MetricsRegistry()
    return (cls(1, d, metrics=ma, **kw), cls(2, d, metrics=mb, **kw),
            ma.snapshot, mb.snapshot)


def _wait_acked(ep, dst, deadline=5.0):
    import time
    t0 = time.time()
    while time.time() - t0 < deadline:
        if not ep.session_stats().get(dst):
            return True
        time.sleep(0.05)
    return False


def _reset_fifo(rd, cls_name):
    a, b, ca, cb = _endpoints(rd, cls_name, ack_every=4)
    try:
        n = 0
        for _ in range(3):
            for _ in range(10):
                a.send(2, "env", {"i": n})
                n += 1
            assert a.inject_reset(2)
        got = [b.recv(timeout=5.0) for _ in range(n)]
        assert [g[2]["i"] for g in got] == list(range(n))
        assert b.recv(timeout=0.3) is None
        assert _wait_acked(a, 2)
        c = ca()["counters"]
        assert c["transport.session.seq_assigned"] == n
        assert cb()["counters"]["transport.session.delivered"] == n
        return [g[2]["i"] for g in got]
    finally:
        a.close()
        b.close()


def _crc_corrupt(rd, cls_name):
    a, b, ca, cb = _endpoints(rd, cls_name, ack_every=2)
    try:
        a.send(2, "env", {"i": 0})
        first = b.recv(timeout=5.0)[2]["i"]
        a._send_corrupt(2)
        a.send(2, "env", {"i": 1})
        second = b.recv(timeout=5.0)[2]["i"]
        return [first, second,
                cb()["counters"]["transport.session.crc_drops"]]
    finally:
        a.close()
        b.close()


def _paced_resets(rd, cls_name):
    a, b, ca, cb = _endpoints(rd, cls_name, ack_every=1)
    try:
        order, n = [], 0
        for burst in (4, 3, 5):
            for _ in range(burst):
                a.send(2, "env", n)
                n += 1
            order += [b.recv(timeout=5.0)[2] for _ in range(burst)]
            assert _wait_acked(a, 2)
            a.inject_reset(2)
        keys = ("transport.session.seq_assigned",
                "transport.session.resets", "transport.session.replays",
                "chaos.reset_inject")
        c, d = ca()["counters"], cb()["counters"]
        return [{k: c.get(k, 0) for k in keys},
                d.get("transport.session.delivered", 0),
                d.get("transport.session.dupes_dropped", 0), order]
    finally:
        a.close()
        b.close()


def _big_frame(rd, cls_name):
    """A gradient-buffer-sized frame (8 MB here) read back bitwise."""
    a, b, _, _ = _endpoints(rd, cls_name)
    try:
        x = np.random.default_rng(0).standard_normal(1 << 21).astype(
            np.float32)
        a.send(2, "red", (0, 3, 1, x))
        got = b.recv(timeout=30.0)[2]
        assert got[:3] == (0, 3, 1) and np.array_equal(got[3], x)
        return [int(got[3].nbytes)]
    finally:
        a.close()
        b.close()


SESSION_CASES = {"reset_fifo": _reset_fifo, "crc_corrupt": _crc_corrupt,
                 "paced_resets": _paced_resets, "big_frame": _big_frame}


@pytest.mark.parametrize("fabric", ["SocketEndpoint", "TcpEndpoint"],
                         ids=["unix", "tcp"])
@pytest.mark.parametrize("case", sorted(SESSION_CASES))
def test_session_layer_matches_reference(case, fabric):
    """The session layer over real sockets (two endpoints in this
    process): exactly-once in-order delivery across injected resets, a
    corrupt frame dropped by its CRC, the paced reset schedule's
    counters, and a large frame read back bitwise; the port's endpoints
    give the reference's results."""
    assert SESSION_CASES[case](port_rd, fabric) == \
        SESSION_CASES[case](ref_rd, fabric)


def test_recv_msg_reads_what_send_bytes_writes(tmp_path):
    """``_recv_msg`` against ``Connection.send_bytes`` over AF_UNIX: the
    same bytes for empty, small, 16 KiB-boundary and multi-chunk
    messages, the 8-byte length header, and the stdlib's EOF errors."""
    import struct
    import threading
    from multiprocessing.connection import Client, Listener
    from repro_torch.runtime_dist import transport as T
    path = str(tmp_path / "s")
    lst = Listener(path, "AF_UNIX")
    conns = []
    th = threading.Thread(target=lambda: conns.append(lst.accept()))
    th.start()
    tx = Client(path, "AF_UNIX")
    th.join()
    rx = conns[0]
    rng = np.random.default_rng(1)
    sizes = [0, 1, 16384, 16385, 2 * T._READ_CHUNK + 3]
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]
    sender = threading.Thread(target=lambda: [tx.send_bytes(m)
                                              for m in msgs])
    sender.start()
    for m in msgs:
        assert bytes(T._recv_msg(rx)) == m
    sender.join()
    # a length past 2 GiB travels as -1 and an 8-byte length
    os.write(tx.fileno(), struct.pack("!iQ", -1, 5) + b"hello")
    assert bytes(T._recv_msg(rx)) == b"hello"
    os.write(tx.fileno(), struct.pack("!i", 10) + b"short")
    tx.close()
    with pytest.raises(OSError, match="end of file during message"):
        T._recv_msg(rx)
    with pytest.raises(EOFError):
        T._recv_msg(rx)
    rx.close()
    lst.close()


def _failure_units(rd):
    """The phi detector's suspect -> confirm -> declare machine on a
    deterministic clock, the jittered bounded backoff, the link-fault
    grammar and windows, and the orphan horizon."""
    import random
    det = rd.PhiDetector(interval=0.5, timeout=4.0, phi_suspect=4.0,
                         phi_dead=8.0, window=8)
    det.touch(1, t=0.0)
    t, states = 0.0, []
    while t < 3.0:
        t += 0.5
        det.on_ack(1, t=t)
    for dt in (0.0, 2.5, 3.9, 4.1, 10.0):
        states.append((det.poll(now=t + dt), det.state[1]))
    det.on_ack(1, t=t + 10.0)
    states.append(det.state[1])
    back = [rd.backoff(a, 0.25, 2.0) for a in range(1, 10)] + \
        [rd.backoff(a, 0.25, 2.0, random.Random(7)) for a in (3, 3, 3)]
    f = rd.LinkFault(frozenset({1}), frozenset({0, 2}), 10.0, 12.0)
    windows = [f.blocks(1, 0, 11.0), f.blocks(2, 1, 11.0),
               f.blocks(0, 2, 11.0), f.blocks(1, 0, 12.1)]
    return [states, det.declared[1]["silence"], back, windows,
            rd.parse_link_spec("1|0,2@3+1.5; coord->2@5+0.5"),
            [rd.orphan_horizon(x) for x in (0.5, 3.0, 10.0, 60.0)]]


def test_failure_units_match_reference():
    """``runtime_dist.failure`` and the link grammar: the same detector
    states, declared silence, backoff sequence, fault windows and
    horizons as the reference's."""
    got = json.loads(json.dumps(_failure_units(port_rd)))
    assert got == json.loads(json.dumps(_failure_units(ref_rd)))
    assert got[0][3][0] == [1] and got[0][3][1] == got[0][5] == "dead"
