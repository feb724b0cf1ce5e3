"""The port's 2-D pipeline slice against the JAX package.

* the stage split (``embed_fn`` / ``stage_fn`` / ``head_fn``): chaining
  the slices of a stage partition is ``forward`` (f32, 2e-5), and each
  slice equals the JAX ``forward_stage`` on the same parameters, for the
  dense, hybrid, plain-ssm and xLSTM families; ``stage_partition`` and
  the local bucket layout equal the reference's;
* the 2-D step against the JAX ``build_pipeline_program`` (run in
  8-host-device subprocesses, one per case, side by side): grow 2 -> 3
  over 5 steps, one step with a departed worker; per-step loss rtol
  1e-5 / atol 1e-6, final params rtol 2e-4 / atol 2e-5, equal meta and
  key, for (S=2, M=2, v=1) and (S=2, M=2, v=2, pipelined,
  ``block_groups=2``, 4 layers);
* the port against itself: the 2-D step equals its own single-axis
  ``xla_psum`` program at the reference's tolerances, in every family;
* plumbing: the cache key carries the stage map, ``TrainLoop`` and the
  CLI run churn scripts with ``pipeline_stages=2``, the profiler ranges
  and timeline events.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.collective_exec.buckets import make_layout as ref_make_layout
from repro.data.synthetic import make_batch
from repro.models.registry import get_api as ref_get_api
from repro.models.registry import get_config as ref_get_config
from repro.pipeline_exec import stage_partition as ref_stage_partition
from repro_torch.collective_exec import (ProgramCache,
                                         build_gradsync_program)
from repro_torch.core.collective import PhaserCollective
from repro_torch.data import SyntheticLM
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.models.registry import get_api, get_config
from repro_torch.obs import Timeline
from repro_torch.obs import timeline as obs_timeline
from repro_torch.optim import AdamW
from repro_torch.pipeline_exec import (build_pipeline_program,
                                       stage_partition)
from repro_torch.runtime_elastic import ElasticPhaserRuntime
from repro_torch.train import TrainLoop
from repro_torch.utils import tree_flatten, tree_map

ROOT = Path(__file__).resolve().parents[1]

# family -> (arch, reduced() overrides); reduced hybrid / xLSTM have two
# groups of two, the dense and plain ssm configs four layers
FAMILIES = {"dense": ("smollm-135m", {"n_layers": 4}),
            "hybrid": ("zamba2-7b", {}),
            "ssm": ("zamba2-7b", {"family": "ssm", "hybrid_attn_every": 0}),
            "xlstm": ("xlstm-125m", {})}


def _pair(family):
    arch, kw = FAMILIES[family]
    ref_api = ref_get_api(ref_get_config(arch).reduced(**kw))
    api = get_api(get_config(arch).reduced(**kw))
    ref_params = jax.tree_util.tree_map(
        np.asarray, ref_api.init_params(jax.random.key(0)))
    return ref_api, ref_params, api, params_from_jax(ref_params, api.cfg,
                                                     "cpu")


def _io(params):
    return {k: v for k, v in params.items() if k != "blocks"}


# ------------------------------------------------------------ stage split
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stage_split_matches_forward_and_reference(family):
    ref_api, ref_params, api, params = _pair(family)
    stage_map = stage_partition(api, 2)
    assert stage_map == ref_stage_partition(ref_api, 2)
    tokens = make_batch(api.cfg.vocab_size, 2, 12, seed=0, step=0)["tokens"]
    tok = torch.tensor(tokens)
    want_logits = transformer.forward(api.cfg, params, tok)[0]
    h = api.embed_fn(params, tok)
    np.testing.assert_allclose(
        h.numpy(), np.asarray(ref_api.embed_fn(ref_params, tokens)),
        rtol=0, atol=0)
    for lo, hi in stage_map:
        x = h.numpy()
        h, aux = api.stage_fn(_io(params), tree_map(lambda t: t[lo:hi],
                                                    params["blocks"]), h)
        ref_blocks = jax.tree_util.tree_map(lambda t: t[lo:hi],
                                            ref_params["blocks"])
        ref_h, ref_aux = ref_api.stage_fn(_io(ref_params), ref_blocks,
                                          jnp.asarray(x))
        np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=2e-5,
                                   atol=2e-5, err_msg=f"{family} {lo}:{hi}")
        assert float(aux) == float(ref_aux) == 0.0
    logits = api.head_fn(params, h)
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(ref_api.head_fn(ref_params, h.numpy())),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S,v", [(1, 1), (2, 1), (4, 1), (2, 2), (3, 1),
                                 (1, 3)])
def test_stage_partition_matches_reference(S, v):
    """The same chunk map, and an assertion where the reference asserts
    (a scan length the chunk count does not divide)."""
    ref_api, _, api, _ = _pair("dense")
    try:
        want = ref_stage_partition(ref_api, S, v)
    except AssertionError:
        with pytest.raises(AssertionError, match="not divisible"):
            stage_partition(api, S, v)
        return
    assert stage_partition(api, S, v) == want


@pytest.mark.parametrize("block_groups", [1, 2])
@pytest.mark.parametrize("S,v", [(2, 1), (2, 2)])
def test_local_bucket_layout_matches_reference(S, v, block_groups):
    """The layout of one stage row (v·per block rows plus the io
    params) field for field against the reference's."""
    ref_api, _, api, _ = _pair("dense")
    per = stage_partition(api, S, v)[0][1]
    spec = dict(ref_api.param_spec())
    spec["blocks"] = jax.tree_util.tree_map(
        lambda l: jax.ShapeDtypeStruct((v * per, *l.shape[1:]), l.dtype),
        spec["blocks"])
    want = ref_make_layout(spec, block_groups=block_groups)
    prog = build_pipeline_program(
        api, AdamW(), PhaserCollective(2, "data", kind="xla_psum"),
        n_stages=S, interleave=v, device="cpu", microbatches=2,
        block_groups=block_groups)
    got = prog.layout
    for f in ("n_buckets", "bucket_elems", "payload", "sizes", "shapes",
              "group_buckets", "group_leaves", "group_rows", "flag_index",
              "perm"):
        assert getattr(got, f) == getattr(want, f), f


# ------------------------------------------------ 2-D step vs the JAX one
# name -> (stages, microbatches, interleave, overlap, block_groups,
# n_layers, sync kind)
CASES = {"S2M2v1": (2, 2, 1, "eager", None, 2, "phaser_scsl"),
         "S2M2v2": (2, 2, 2, "pipelined", 2, 4, "recursive_doubling")}
STEPS, GROW_AT, DEAD_STEP = 5, 2, 3     # teams 2, 2, 3, 3, 3
BATCH, SEQ = 4, 16                      # per worker


def _teams():
    """Per step: (member keys, alive mask). Grow 2 -> 3 at GROW_AT; one
    worker departed (flag 0) in step DEAD_STEP."""
    out = []
    for step in range(STEPS):
        keys = (0, 1) if step < GROW_AT else (0, 1, 2)
        alive = [1.0] * len(keys)
        if step == DEAD_STEP:
            alive[1] = 0.0
        out.append((keys, alive))
    return out


def _worker_batch(vocab, keys, step):
    bs = [make_batch(vocab, BATCH, SEQ, seed=100 + w, step=step)
          for w in keys]
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.core.collective import PhaserCollective
from repro.data.synthetic import make_batch
from repro.models.registry import get_api, get_config
from repro.optim import AdamW
from repro.pipeline_exec import build_pipeline_program

out = sys.argv[1]
S, M, v, overlap, bg, L, kind = json.loads(sys.argv[2])
teams = json.loads(sys.argv[3])
B, SEQ = json.loads(sys.argv[4])
cfg = get_config("smollm-135m").reduced(n_layers=L)
api = get_api(cfg)
opt = AdamW(lr=1e-3, warmup=10, total_steps=20)
params = api.init_params(jax.random.key(0))
opt_state = opt.init(params)
res, progs, bound = {}, {}, None
for step, (keys, alive) in enumerate(teams):
    keys = tuple(keys)
    if keys not in progs:        # one program per epoch
        pc = PhaserCollective(len(keys), "data", kind=kind, seed=0,
                              keys=keys)
        progs[keys] = build_pipeline_program(
            api, opt, pc, n_stages=S, interleave=v, microbatches=M,
            stacked=True, overlap=overlap, block_groups=bg)
        res["meta/%d" % len(keys)] = np.array(json.dumps(
            progs[keys].meta))
        res["key/%d" % len(keys)] = np.array(repr(progs[keys].key))
    prog = progs[keys]
    if bound is None:
        params, opt_state = prog.bind_state(params, opt_state)
        bound = True
    bs = [make_batch(cfg.vocab_size, B, SEQ, seed=100 + w, step=step)
          for w in keys]
    batch = {k: np.stack([b[k] for b in bs]) for k in bs[0]}
    params, opt_state, pm = prog.step(params, opt_state, batch,
                                      jnp.asarray(alive, jnp.float32))
    for k, val in prog.reduce_metrics(pm).items():
        res["step%d/%s" % (step, k)] = np.asarray(val)
params, _ = prog.readout_state(params, opt_state)
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    res["params/" + "/".join(p.key for p in path)] = np.asarray(leaf)
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """Each case's JAX pipeline run in its own 8-host-device
    subprocess, all started together."""
    d = tmp_path_factory.mktemp("jax_pipeline")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    teams = json.dumps([[list(k), a] for k, a in _teams()])
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(d / f"{name}.npz"),
         json.dumps(case), teams, json.dumps([BATCH, SEQ])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, case in CASES.items()}
    out = {}
    for name, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
        out[name] = dict(np.load(d / f"{name}.npz"))
    return out


def _case_api(case):
    S, M, v, overlap, bg, L, kind = case
    cfg = ref_get_config("smollm-135m").reduced(n_layers=L)
    ref_params = jax.tree_util.tree_map(
        np.asarray, ref_get_api(cfg).init_params(jax.random.key(0)))
    api = get_api(get_config("smollm-135m").reduced(n_layers=L))
    return api, params_from_jax(ref_params, api.cfg, "cpu")


def _run_port(case, api, params, programs=None):
    """The case's 5 steps through the port, one program per epoch:
    per-step reduced metrics, final params, the programs."""
    S, M, v, overlap, bg, L, kind = case
    opt = AdamW(lr=1e-3, warmup=10, total_steps=20)
    opt_state = opt.init(params)
    progs, metrics = {}, []
    for step, (keys, alive) in enumerate(_teams()):
        if keys not in progs:
            pc = PhaserCollective(len(keys), "data", kind=kind, seed=0,
                                  keys=keys)
            progs[keys] = build_pipeline_program(
                api, opt, pc, n_stages=S, interleave=v, device="cpu",
                microbatches=M, stacked=True, overlap=overlap,
                block_groups=bg)
        prog = progs[keys]
        batch = {k: torch.tensor(x) for k, x in
                 _worker_batch(api.cfg.vocab_size, keys, step).items()}
        params, opt_state = prog.bind_state(params, opt_state)
        params, opt_state, pm = prog.step(params, opt_state, batch,
                                          torch.tensor(alive))
        params, opt_state = prog.readout_state(params, opt_state)
        metrics.append(prog.reduce_metrics(pm))
    return metrics, params, progs


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_step_matches_reference(reference_runs, name):
    saved = reference_runs[name]
    case = CASES[name]
    api, params = _case_api(case)
    metrics, final, progs = _run_port(case, api, params)
    for step, m in enumerate(metrics):
        for k, val in m.items():
            want = float(saved[f"step{step}/{k}"])
            if k in ("loss", "aux"):
                np.testing.assert_allclose(float(val), want, rtol=1e-5,
                                           atol=1e-6, err_msg=f"{step} {k}")
            else:
                assert abs(float(val) - want) <= 1e-5 * max(1.0, abs(want)), \
                    (step, k, float(val), want)
    for path, leaf in zip(*tree_flatten(final)):
        np.testing.assert_allclose(leaf.numpy(),
                                   saved["params/" + "/".join(path)],
                                   rtol=2e-4, atol=2e-5, err_msg=str(path))
    for keys, prog in progs.items():
        assert prog.meta == json.loads(str(saved[f"meta/{len(keys)}"]))
        assert repr(prog.key) == str(saved[f"key/{len(keys)}"])
    assert metrics[DEAD_STEP]["alive"] == 2.0


# ------------------------------------------------------ the port vs itself
SELF_CASES = {"dense-S2M2v1": ("dense", 2, 2, 1, "eager", None),
              "dense-S2M2v2-piped": ("dense", 2, 2, 2, "pipelined", 2),
              "dense-S4M4v1": ("dense", 4, 4, 1, "eager", None),
              "hybrid-S2M2v1": ("hybrid", 2, 2, 1, "eager", None),
              "ssm-S2M2v2": ("ssm", 2, 2, 2, "pipelined", 2),
              "xlstm-S2M2v1": ("xlstm", 2, 2, 1, "eager", None)}


@pytest.mark.parametrize("name", sorted(SELF_CASES))
def test_pipeline_step_matches_single_axis(name):
    """Grow 2 -> 3 with a departed worker in one step: per-step loss
    (rtol 1e-5) and params (rtol 2e-4, atol 2e-5) equal the port's
    single-axis ``xla_psum`` program from the same params. The two sum
    the gradient in different orders, and Adam moves a parameter whose
    gradient is within rounding of zero by up to 2 lr (the sLSTM bias),
    so the warmup keeps the lr at 1e-4 .. 5e-4, as the reference-parity
    steps do."""
    family, S, M, v, overlap, bg = SELF_CASES[name]
    _, _, api, params = _pair(family)
    opt = AdamW(lr=1e-3, warmup=10, total_steps=20)
    st = opt.init(params)
    p2, o2 = params, st
    for step, (keys, alive) in enumerate(_teams()):
        pc = PhaserCollective(len(keys), "data", kind="phaser_scsl",
                              seed=0, keys=keys)
        prog = build_pipeline_program(api, opt, pc, n_stages=S,
                                      interleave=v, device="cpu",
                                      microbatches=M, stacked=True,
                                      overlap=overlap, block_groups=bg)
        ref = build_gradsync_program(
            api, opt, PhaserCollective(len(keys), "data", kind="xla_psum",
                                       keys=keys), device="cpu",
            stacked=True)
        batch = {k: torch.tensor(x) for k, x in _worker_batch(
            api.cfg.vocab_size, keys, step).items()}
        a = torch.tensor(alive)
        params, st, pm = prog.step(params, st, batch, a)
        p2, o2, pm2 = ref.step(p2, o2, batch, a)
        r, r2 = prog.reduce_metrics(pm), ref.reduce_metrics(pm2)
        np.testing.assert_allclose(float(r["loss"]), float(r2["loss"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(r["grad_norm"]),
                                   float(r2["grad_norm"]), rtol=1e-5)
    for (path, a), b in zip(zip(*tree_flatten(params)),
                            tree_flatten(p2)[1]):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=str(path))


def test_bind_and_readout_are_bitwise():
    _, _, api, params = _pair("dense")
    opt = AdamW()
    prog = build_pipeline_program(
        api, opt, PhaserCollective(2, "data", kind="xla_psum"),
        n_stages=2, interleave=2, device="cpu", microbatches=2)
    st = opt.init(params)
    p, o = prog.readout_state(*prog.bind_state(params, st))
    for a, b in zip(tree_flatten({"p": p, "mu": o.mu})[1],
                    tree_flatten({"p": params, "mu": st.mu})[1]):
        assert torch.equal(a, b)


def test_sync_folds_stage_rows_into_one_launch_a_round(monkeypatch):
    """The stage rows share one layout: each schedule round is one
    ``bucket_combine`` call over (n, S * n_buckets, bucket_elems), per
    readiness group when pipelined, each rank's block contiguous as the
    card's kernel requires."""
    from repro_torch.core import collective as C
    from repro_torch.collective_exec import executor as E
    calls = []
    real = C.bucket_combine

    def spy(acc, y, gate, *, op="add"):
        calls.append(tuple(acc.shape))
        # the card kernel's operand layout: each rank's block contiguous
        for t in (acc, y):
            assert t.stride(-1) == 1 and t.stride(-2) == t.shape[-1]
        return real(acc, y, gate, op=op)
    monkeypatch.setattr(C, "bucket_combine", spy)
    monkeypatch.setattr(E, "bucket_combine", spy)
    _, _, api, params = _pair("dense")
    opt = AdamW()
    b = {k: torch.tensor(x) for k, x in make_batch(
        api.cfg.vocab_size, 12, 8, seed=0, step=0).items()}
    pc = PhaserCollective(3, "data", kind="phaser_scsl", seed=0)
    rounds = len(pc.unified_schedule().rounds)
    for overlap, bg in (("eager", None), ("pipelined", 2)):
        calls.clear()
        prog = build_pipeline_program(api, opt, pc, n_stages=2,
                                      device="cpu", microbatches=2,
                                      overlap=overlap, block_groups=bg)
        prog.step(params, opt.init(params), b)
        lay = prog.layout
        groups = lay.n_groups if overlap == "pipelined" else 1
        assert len(calls) == rounds * groups
        want = ({(3, 2 * (hi - lo), lay.bucket_elems)
                 for lo, hi in lay.groups} if overlap == "pipelined"
                else {(3, 2 * lay.n_buckets, lay.bucket_elems)})
        assert set(calls) == want


# ---------------------------------------------------------------- plumbing
def test_pipeline_program_key_carries_stage_map():
    """The program's own key separates the same member set at different
    stage counts and interleave factors, after the cache's key."""
    _, _, api, _ = _pair("dense")
    pc = PhaserCollective(2, "data", kind="xla_psum", keys=(0, 1))
    base = ProgramCache.key_of(pc)
    keys = {}
    for S, v in ((1, 1), (2, 1), (2, 2), (4, 1)):
        prog = build_pipeline_program(api, AdamW(), pc, n_stages=S,
                                      interleave=v, device="cpu",
                                      microbatches=2)
        assert prog.key[:4] == base[:4]
        assert prog.key[4:] == ("pipeline", stage_partition(api, S, v),
                                "eager", 2, v)
        keys[(S, v)] = prog.key
    assert len(set(keys.values())) == 4


def _pipe_loop(api, **kw):
    return TrainLoop(api=api, opt=AdamW(lr=3e-3, warmup=2, total_steps=8),
                     data=SyntheticLM(vocab=api.cfg.vocab_size, batch=12,
                                      seq=16, seed=0),
                     log_every=1,
                     runtime=ElasticPhaserRuntime(2, seed=0,
                                                  kind="phaser_scsl"),
                     elastic_events=launch_train.parse_elastic(
                         "join@2,leave:0@5"), device="cpu", **kw)


def test_train_loop_runs_pipeline_churn(monkeypatch):
    """``pipeline_stages=2`` under churn 2 -> 3 -> 2: a program per
    member set (the cache key carries the stage config), the 1F1B wave
    order re-proved at each boundary, the same losses as the loop on the
    single-axis programs to the step's tolerance, a finite run."""
    import repro_torch.pipeline_exec as PE
    proved = []
    real = PE.verify_phase_order
    monkeypatch.setattr(PE, "verify_phase_order",
                        lambda s: proved.append(s.fingerprint()) or real(s))
    _, _, api, params = _pair("dense")
    loop = _pipe_loop(api, pipeline_stages=2, microbatches=2)
    p, _ = loop.run(8, params=params)
    base = _pipe_loop(api, microbatches=2)
    p2, _ = base.run(8, params=params)
    assert [len(e["live"]) for e in loop.epoch_log] == [3, 2]
    assert loop._progs.stats()["misses"] == 3
    assert len(proved) == 2 and proved[0][:3] == (2, 2, 1)
    assert all(m["stages"] == 2 and m["pipeline_waves"] == 6
               for m in loop.metrics_log)
    np.testing.assert_allclose([m["loss"] for m in loop.metrics_log],
                               [m["loss"] for m in base.metrics_log],
                               rtol=1e-4, atol=1e-5)
    for a, b in zip(tree_flatten(p)[1], tree_flatten(p2)[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4)
    full = list(loop._progs._programs)
    assert all(k[-2:] == ("eager", 2) or k[-4:] == ("eager", 2, 2, 1)
               for k in full)
    pk = loop._program_key()
    assert pk["pipeline_stages"] == 2 and pk["interleave"] == 1


def test_pipeline_needs_the_program_path():
    from repro_torch.train import build_train_step
    _, _, api, _ = _pair("dense")
    loop = _pipe_loop(api, pipeline_stages=2, microbatches=2,
                      device_collective=False)
    with pytest.raises(ValueError, match="device-collective"):
        loop.run(1)
    with pytest.raises(ValueError, match="collective program"):
        build_train_step(api, AdamW(), interleave=2, device="cpu")


def test_train_cli_pipeline_on_cpu(capsys):
    rc = launch_train.main(["--arch", "smollm-135m", "--reduced",
                            "--layers", "4", "--device", "cpu",
                            "--workers", "2", "--pipeline-stages", "2",
                            "--interleave", "2", "--microbatches", "2",
                            "--batch", "12", "--seq", "16", "--steps", "6",
                            "--elastic", "join@2"])
    out = capsys.readouterr().out
    assert rc in (0, 1), out
    rows = [json.loads(l) for l in out.splitlines() if l.startswith('{"loss"')]
    assert rows and all(r["stages"] == 2 and r["interleave"] == 2
                        for r in rows)
    bounds = [json.loads(l)["epoch_boundary"] for l in out.splitlines()
              if l.startswith('{"epoch_boundary"')]
    assert [len(b["live"]) for b in bounds] == [3]


def test_profiler_ranges_and_timeline():
    """A step's four ranges reach the profiler; the build puts the wave
    grid (one event per filled (wave, stage) slot) and the round grid on
    the active timeline."""
    from torch.profiler import ProfilerActivity, profile
    _, _, api, params = _pair("dense")
    pc = PhaserCollective(3, "data", kind="phaser_scsl", seed=0)
    tl = Timeline()
    obs_timeline.activate(tl)
    try:
        prog = build_pipeline_program(api, AdamW(), pc, n_stages=2,
                                      device="cpu", microbatches=2)
    finally:
        obs_timeline.deactivate()
    cats = [e.get("cat", "") for e in tl.chrome()["traceEvents"]]
    # every stage runs one F and one B item per microbatch
    assert sum(c.startswith("pipeline") for c in cats) == 2 * 2 * 2
    assert sum(c == "gradsync" for c in cats) == \
        len(pc.unified_schedule().rounds)
    b = {k: torch.tensor(x) for k, x in make_batch(
        api.cfg.vocab_size, 12, 8, seed=0, step=0).items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prog.step(params, AdamW().init(params), b)
    names = {e.name for e in prof.events()}
    assert {"pipeline.fwd", "pipeline.bwd", "gradsync.sync",
            "gradsync.update"} <= names
