"""The port's training slice against the JAX package, on reduced smollm
in f32 (plus a 6-head / 2-KV-head variant), from the same parameters
(initialised by JAX, carried across by ``params_from_jax``) and the same
numpy inputs.

Tolerances: loss 1e-5 and each gradient leaf 1e-4 of its largest value
(sums in another order); plain attention gradients 2e-5; AdamW 1e-6 of
each leaf's largest value (the f32 scalars round as the reference's);
bucket combine, layout and flatten exactly; executors 1e-5 against the
f64 host simulation; the ``GradSyncProgram`` step 1e-5; the elastic
loop's losses and final parameters 1e-4 (nine steps of drift). The
reference's shard_map programs run in a subprocess over 8 host devices,
as its own device tests do.
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
from repro.core.collective import ALLREDUCE_KINDS
from repro.core.collective import PhaserCollective as RefCollective
from repro.core.collective import (recursive_doubling_schedule,
                                   simulate_schedule)
from repro.data.synthetic import make_batch
from repro.kernels.ops import bucket_combine_op
from repro.kernels.ref import attention_ref as ref_attention
from repro.models.registry import get_api as ref_get_api
from repro.models.registry import get_config as ref_get_config
from repro.optim import AdamW as RefAdamW
from repro.optim import cosine_schedule as ref_cosine
from repro_torch.checkpoint import CheckpointManager
from repro_torch.collective_exec import (build_allreduce_program,
                                         build_gradsync_program,
                                         execute_flat,
                                         execute_flat_pipelined,
                                         make_layout)
from repro_torch.core.collective import PhaserCollective, RankStack
from repro_torch.data import SyntheticLM
from repro_torch.interop import (opt_state_from_jax, opt_state_to_numpy,
                                 params_from_jax, params_to_numpy)
from repro_torch.kernels.bucket_combine import bucket_combine, combine_ref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.flash_attention import attention_bwd_ref
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import get_api, get_config
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime_elastic import ElasticPhaserRuntime
from repro_torch.train import TrainLoop
from repro_torch.utils import tree_flatten

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"smollm-reduced": {},
            "smollm-reduced-g3": {"n_heads": 6, "n_kv_heads": 2}}
CHURN = "join@2,join@2,fail@5,leave@5,leave@5"      # 4 -> 6 -> 3


def _pair(overrides=None):
    overrides = overrides or {}
    ref_cfg = ref_get_config("smollm-135m").reduced(**overrides)
    cfg = get_config("smollm-135m").reduced(**overrides)
    ref_api = ref_get_api(ref_cfg)
    ref_params = jax.tree_util.tree_map(
        np.asarray, ref_api.init_params(jax.random.key(0)))
    return ref_api, ref_params, get_api(cfg), params_from_jax(
        ref_params, cfg, device="cpu")


def _ref_leaves(tree):
    """(path, numpy leaf) of a JAX tree, in its flatten order."""
    return [(tuple(p.key for p in path), np.asarray(leaf)) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_tree_close(got, want, rel, what=""):
    """Each leaf within ``rel`` of the reference leaf's largest value;
    ``got`` a port tree, ``want`` a JAX tree: same leaf order."""
    gp, gl = tree_flatten(got)
    wl = _ref_leaves(want)
    assert gp == [p for p, _ in wl]
    for path, g, (_, w) in zip(gp, gl, wl):
        g = g.detach().float().numpy() if torch.is_tensor(g) else g
        err = np.abs(g - w).max()
        assert err <= rel * max(np.abs(w).max(), 1e-30), (what, path, err)


def _batch(vocab, B, S, step=0):
    return make_batch(vocab, B, S, seed=0, step=step)


def _torch_batch(b):
    return {k: torch.tensor(v) for k, v in b.items()}


# ------------------------------------------------------ loss and grads
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match(variant, remat):
    ref_api, ref_params, api, params = _pair(VARIANTS[variant])
    b = _batch(api.cfg.vocab_size, 3, 13)
    (want_total, want_m), want_g = jax.value_and_grad(
        ref_api.loss_fn, has_aux=True)(
        ref_params, {k: jnp.asarray(v) for k, v in b.items()}, remat=remat)
    (total, m), grads = api.value_and_grad(params, _torch_batch(b),
                                           remat=remat)
    assert abs(float(total) - float(want_total)) <= 1e-5
    assert abs(float(m["loss"]) - float(want_m["loss"])) <= 1e-5
    assert float(m["aux"]) == float(want_m["aux"]) == 0.0
    _assert_tree_close(grads, want_g, 1e-4, "grad")


@pytest.mark.parametrize("window", [None, 5], ids=["causal", "window5"])
@pytest.mark.parametrize("S", [1, 7, 100])
def test_attention_gradient_matches(S, window):
    """The plain attention's autograd dq/dk/dv against ``jax.grad`` of
    the reference oracle, at smollm's GQA shape (9 heads over 3)."""
    rng = np.random.default_rng(S)
    q, do = (rng.normal(size=(2, 9, S, 64)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(2, 3, S, 64)).astype(np.float32)
            for _ in range(2))

    def f(q_, k_, v_):
        o = ref_attention(q_, k_, v_, causal=True, sliding_window=window)
        return jnp.sum(o * do)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    got = attention_bwd_ref(*(torch.tensor(x) for x in (q, k, v)),
                            torch.tensor(do), causal=True,
                            sliding_window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


# --------------------------------------------------------------- AdamW
def _rand_tree(ref_params, rng, scale):
    return {k: (_rand_tree(v, rng, scale) if isinstance(v, dict) else
                (rng.normal(size=v.shape) * scale).astype(np.float32))
            for k, v in ref_params.items()}


@pytest.mark.parametrize("scale", [1e-1, 1e-4], ids=["clipped", "unclipped"])
def test_adamw_update_matches(scale):
    _, ref_params, api, params = _pair()
    rng = np.random.default_rng(0)
    g = _rand_tree(ref_params, rng, scale)
    ref_opt = RefAdamW(lr=1e-3, warmup=3, total_steps=10)
    opt = AdamW(lr=1e-3, warmup=3, total_steps=10)
    jst = ref_opt.init(ref_params)
    want_p, want_st, want_m = ref_opt.update(g, jst, ref_params)
    got_p, got_st, got_m = opt.update(params_from_jax(g, api.cfg, "cpu"),
                                      opt.init(params), params)
    clipped = float(want_m["grad_norm"]) > 1.0
    assert clipped == (scale == 1e-1)
    for k in ("lr", "grad_norm"):
        assert abs(float(got_m[k]) - float(want_m[k])) <= \
            1e-6 * abs(float(want_m[k]))
    _assert_tree_close(got_p, want_p, 1e-6, "params")
    _assert_tree_close(got_st.mu, want_st.mu, 1e-6, "mu")
    _assert_tree_close(got_st.nu, want_st.nu, 1e-6, "nu")
    assert int(got_st.step) == int(want_st.step) == 1


def test_cosine_schedule_matches():
    want = ref_cosine(3e-3, 6, 30)
    got = cosine_schedule(3e-3, 6, 30)
    for s in range(0, 31):
        assert float(got(s)) == pytest.approx(float(want(s)), rel=1e-6,
                                              abs=1e-12)


def test_adamw_trajectory_matches():
    """Ten updates with fresh gradients each step, clipping on at the
    first steps and off later: params and moments track the reference
    (the weight decay also reaches the stacked (L, D) norms)."""
    _, ref_params, api, params = _pair()
    rng = np.random.default_rng(1)
    ref_opt = RefAdamW(lr=3e-3, warmup=3, total_steps=10)
    opt = AdamW(lr=3e-3, warmup=3, total_steps=10)
    jp, jst = ref_params, ref_opt.init(ref_params)
    tp, tst = params, opt_state_from_jax(jst, api.cfg, "cpu")
    for s in range(10):
        g = _rand_tree(ref_params, rng, 0.05 if s < 4 else 1e-4)
        jp, jst, _ = ref_opt.update(g, jst, jp)
        tp, tst, _ = opt.update(params_from_jax(g, api.cfg, "cpu"), tst, tp)
    _assert_tree_close(tp, jp, 1e-6, "params")
    back = opt_state_to_numpy(tst)
    _assert_tree_close(back["mu"], jst.mu, 1e-6, "mu")
    _assert_tree_close(back["nu"], jst.nu, 1e-6, "nu")
    assert int(back["step"]) == int(jst.step) == 10
    # the stacked norms are decayed: ln1 moved although its grads are tiny
    assert not np.array_equal(params_to_numpy(tp, api.cfg)["blocks"]["ln1"],
                              ref_params["blocks"]["ln1"])


def test_training_kernels_never_take_the_plain_version_off_cpu():
    """No fallback: a tensor that is not on the CPU goes to the kernel or
    raises, through autograd too."""
    q = torch.empty((1, 9, 4, 64), device="meta")
    kv = torch.empty((1, 3, 4, 64), device="meta")
    lse = torch.empty((1, 9, 4), device="meta")
    with pytest.raises(ValueError, match="meta"):
        FA.flash_attention_bwd(q, kv, kv, q, q, lse)
    with pytest.raises(ValueError, match="meta"):
        FA.flash_attention(q.requires_grad_(), kv, kv)
    acc = torch.empty((2, 1, 128), device="meta")
    with pytest.raises(ValueError, match="meta"):
        bucket_combine(acc, acc, torch.empty((2,), dtype=torch.int32,
                                             device="meta"))


# ------------------------------------------------------ bucket combine
@pytest.mark.parametrize("op", ["add", "copy"])
@pytest.mark.parametrize("gate", [0, 1])
def test_bucket_combine_plain_matches_pallas(op, gate):
    rng = np.random.default_rng(7)
    acc, y = (rng.normal(size=(3, 256)).astype(np.float32)
              for _ in range(2))
    want = bucket_combine_op(jnp.asarray(acc), jnp.asarray(y),
                             jnp.asarray(bool(gate)), op=op, interpret=True)
    got = bucket_combine(torch.tensor(acc), torch.tensor(y),
                         torch.tensor(gate, dtype=torch.int32), op=op)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert bucket_combine.launches == 0          # CPU: the plain version


@pytest.mark.parametrize("op", ["add", "copy"])
def test_bucket_combine_stacked_equals_per_rank(op):
    """One stacked call with a mixed gate vector equals the reference's
    kernel run rank by rank; a zero-row buffer comes back as it is."""
    rng = np.random.default_rng(3)
    acc, y = (rng.normal(size=(6, 2, 128)).astype(np.float32)
              for _ in range(2))
    y[1, 0, :4] = -0.0
    gate = np.array([1, 0, 0, 1, 1, 0], np.int32)
    got = bucket_combine(torch.tensor(acc), torch.tensor(y),
                         torch.tensor(gate), op=op).numpy()
    for r in range(6):
        want = bucket_combine_op(jnp.asarray(acc[r]), jnp.asarray(y[r]),
                                 jnp.asarray(bool(gate[r])), op=op,
                                 interpret=True)
        assert np.array_equal(got[r], np.asarray(want))
    empty = torch.zeros((6, 0, 128))
    assert bucket_combine(empty, empty, torch.tensor(gate), op=op) is empty


def test_bucket_combine_executes_schedule_like_simulate():
    """Chained stacked combines reproduce ``simulate_schedule`` on a
    3-rank elimination schedule (the kernel as the round primitive)."""
    sched = recursive_doubling_schedule(3)
    rng = np.random.default_rng(1)
    vals = [rng.normal(size=(2, 128)).astype(np.float32) for _ in range(3)]
    stack = RankStack(3, "cpu")
    acc = torch.tensor(np.stack(vals))
    for r, pairs in enumerate(sched.rounds):
        acc = bucket_combine(acc, stack.ppermute(acc, pairs),
                             stack.gate(pairs), op=sched.op(r))
    for got, want in zip(acc.numpy(), simulate_schedule(sched, vals)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        combine_ref(acc, acc, torch.tensor([0, 0, 0]), op="add").numpy(),
        acc.numpy())


# -------------------------------------------------------- bucket layout
@pytest.mark.parametrize("bucket_elems", [None, 128], ids=["default", "128"])
@pytest.mark.parametrize("block_groups", [1, 2])
def test_bucket_layout_matches_reference(block_groups, bucket_elems):
    ref_api, ref_params, api, params = _pair()
    want = ref_make_layout(ref_api.param_spec(), bucket_elems=bucket_elems,
                           block_groups=block_groups)
    got = make_layout(api.param_spec(), bucket_elems=bucket_elems,
                      block_groups=block_groups)
    for f in ("n_buckets", "bucket_elems", "payload", "sizes", "shapes",
              "group_buckets", "group_leaves", "group_rows", "flag_index"):
        assert getattr(got, f) == getattr(want, f), f
    ref_paths = [p for p, _ in _ref_leaves(ref_api.param_spec())]
    assert [got.paths[i] for i in got.perm] == \
        [ref_paths[i] for i in want.perm]
    # flatten: bitwise the reference's buffer; unflatten: round trip
    g = _rand_tree(ref_params, np.random.default_rng(2), 1.0)
    tg = params_from_jax(g, api.cfg, "cpu")
    flat = got.flatten(tg, 0.0)
    assert np.array_equal(flat.numpy(), np.asarray(want.flatten(g, 0.0)))
    groups = got.flatten_groups(tg, 1.0)
    for a, b in zip(groups, want.flatten_groups(g, 1.0)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    tree, count = got.unflatten_groups(groups)
    assert float(count) == 1.0
    for (pa, a), (pb, b) in zip(zip(*tree_flatten(tree)),
                                zip(*tree_flatten(tg))):
        assert pa == pb and torch.equal(a, b)


# ------------------------------------------------------------ executors
@pytest.mark.parametrize("kind", ALLREDUCE_KINDS)
@pytest.mark.parametrize("n", range(1, 9))
def test_execute_flat_matches_simulation(n, kind):
    rng = np.random.default_rng(n)
    xs = rng.normal(size=(n, 5, 128)).astype(np.float32)
    pc = PhaserCollective(n, "data", kind=kind, seed=1)
    stack = RankStack(n, "cpu")
    got = execute_flat(torch.tensor(xs), pc, stack)
    sim = RefCollective(n, "data", kind=kind, seed=1).simulate_allreduce(
        list(xs))
    total = xs.astype(np.float64).sum(0)
    for r in range(n):
        np.testing.assert_allclose(got[r].numpy(), sim[r], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[r].numpy(), total, rtol=1e-5,
                                   atol=1e-5)
    # the pipelined round order over three groups: bitwise the same
    x = torch.tensor(xs)
    piped = execute_flat_pipelined([x[:, 0:2], x[:, 2:3], x[:, 3:5]], pc,
                                   stack)
    assert torch.equal(torch.cat(piped, dim=1), got)
    assert torch.equal(pc.all_reduce(x, stack), got)
    np.testing.assert_allclose(pc.pmean(x, stack)[0].numpy(), total / n,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(), (7,), (3, 33), (2, 3, 4, 5)],
                         ids=str)
@pytest.mark.parametrize("kind", ["phaser_scsl", "recursive_doubling"])
def test_all_reduce_takes_any_stacked_shape(kind, shape):
    """``PhaserCollective.all_reduce`` over values that are no bucket
    buffer: each round's combine sees one row per rank."""
    n = 5
    xs = np.random.default_rng(4).normal(size=(n,) + shape).astype(
        np.float32)
    pc = PhaserCollective(n, "data", kind=kind, seed=1)
    got = pc.all_reduce(torch.tensor(xs), RankStack(n, "cpu"))
    assert got.shape == xs.shape
    for r in range(n):
        np.testing.assert_allclose(got[r].numpy(), xs.sum(0), rtol=1e-5,
                                   atol=1e-5)


def test_allreduce_program_sums_every_rank():
    xs = np.random.default_rng(0).normal(size=(5, 4, 33)).astype(np.float32)
    for kind in ALLREDUCE_KINDS:
        f = build_allreduce_program(PhaserCollective(5, "data", kind=kind,
                                                     seed=1),
                                    torch.empty((4, 33), device="meta"),
                                    device="cpu")
        got = f(torch.tensor(xs)).numpy()
        for r in range(5):
            np.testing.assert_allclose(got[r], xs.sum(0), rtol=1e-5,
                                       atol=1e-5)


# ----------------------------------- reference programs (8 host devices)
STEP_CASES = []
for _ni, _n in enumerate((3, 4, 6)):
    for _ki, _kind in enumerate(ALLREDUCE_KINDS):
        _c = (_ni + _ki) % 4          # every kind sees both mb and overlap
        STEP_CASES.append((f"n{_n}-{_kind}", _n, _kind, 1 + _c % 2,
                           ("eager", "pipelined")[_c // 2], _ki % _n))

REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.data.synthetic import SyntheticLM, make_batch
from repro.models.registry import get_api, get_config
from repro.optim import AdamW

out, mode = sys.argv[1], sys.argv[2]
cfg = get_config("smollm-135m").reduced()
api = get_api(cfg)
params = api.init_params(jax.random.key(0))
res = {}

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/" + "/".join(p.key for p in path)] = np.asarray(leaf)

if mode == "steps":
    from repro.collective_exec import build_gradsync_program
    from repro.core.collective import PhaserCollective
    opt = AdamW(lr=1e-3, warmup=10, total_steps=20)
    st = opt.init(params)
    b = {k: jnp.asarray(v) for k, v in
         make_batch(cfg.vocab_size, 24, 16, seed=0, step=0).items()}
    for name, n, kind, mb, ov, dead in json.loads(sys.argv[3]):
        pc = PhaserCollective(n, "data", kind=kind, seed=0)
        prog = build_gradsync_program(api, opt, pc, overlap=ov,
                                      microbatches=mb)
        alive = np.ones(n, np.float32)
        alive[dead] = 0.0
        p, o, pm = prog.step(params, st, b, jnp.asarray(alive))
        put(name + "/params", p)
        for k, v in prog.reduce_metrics(pm).items():
            res[name + "/metric/" + k] = np.asarray(v)
else:
    from repro.launch.train import parse_elastic
    from repro.runtime_elastic import ElasticPhaserRuntime
    from repro.train.loop import TrainLoop
    loop = TrainLoop(api=api, opt=AdamW(lr=3e-3, warmup=2, total_steps=9),
                     data=SyntheticLM(vocab=cfg.vocab_size, batch=12,
                                      seq=16, seed=0),
                     log_every=1, device_collective=True,
                     runtime=ElasticPhaserRuntime(4, seed=0,
                                                  kind="phaser_scsl"),
                     elastic_events=parse_elastic(sys.argv[3]))
    p, _ = loop.run(9, params=params)
    put("params", p)
    res["loss"] = np.array([m["loss"] for m in loop.metrics_log])
    res["epoch_log"] = np.array(json.dumps(loop.epoch_log))
    res["cache"] = np.array(json.dumps(loop._progs.stats()))
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's gradsync steps (in two halves) and elastic loop,
    each in its own 8-host-device subprocess, run side by side."""
    d = tmp_path_factory.mktemp("jax_reference")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    runs = {"steps0": ("steps", json.dumps(STEP_CASES[0::2])),
            "steps1": ("steps", json.dumps(STEP_CASES[1::2])),
            "loop": ("loop", CHURN)}
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(d / f"{name}.npz"), m, a],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (m, a) in runs.items()}
    out = {}
    for name, p in procs.items():
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-4000:]
        out[name] = dict(np.load(d / f"{name}.npz"))
    out["steps"] = {**out.pop("steps0"), **out.pop("steps1")}
    return out


def _assert_saved_close(got_tree, saved, prefix, tol):
    paths, leaves = tree_flatten(got_tree)
    for p, leaf in zip(paths, leaves):
        want = saved[prefix + "/" + "/".join(p)]
        np.testing.assert_allclose(leaf.numpy(), want, rtol=tol, atol=tol,
                                   err_msg=f"{prefix} {p}")


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_gradsync_step_matches_reference(reference_runs, case):
    """One ``GradSyncProgram`` step, one worker's alive flag 0: updated
    params and reduced metrics against the reference's shard_map
    program; the port's pipelined step is bitwise its eager one."""
    name, n, kind, mb, _, dead = case
    saved = reference_runs["steps"]
    _, _, api, params = _pair()
    # a first lr of 1e-4 (see test_plain_step_matches_reference)
    opt = AdamW(lr=1e-3, warmup=10, total_steps=20)
    b = _torch_batch(_batch(api.cfg.vocab_size, 24, 16))
    alive = torch.ones(n)
    alive[dead] = 0.0
    out = {}
    for ov in ("eager", "pipelined"):
        prog = build_gradsync_program(
            api, opt, PhaserCollective(n, "data", kind=kind, seed=0),
            device="cpu", overlap=ov, microbatches=mb)
        p, _, pm = prog.step(params, opt.init(params), b, alive)
        out[ov] = p
        _assert_saved_close(p, saved, name + "/params", 1e-5)
        for k, v in prog.reduce_metrics(pm).items():
            want = (ov == "pipelined") if k == "overlap" \
                else float(saved[name + "/metric/" + k])
            assert abs(float(v) - want) <= 1e-5 * max(1.0, abs(want)), \
                (k, ov)
    for a, c in zip(tree_flatten(out["eager"])[1],
                    tree_flatten(out["pipelined"])[1]):
        assert torch.equal(a, c)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_plain_step_matches_reference(microbatches):
    """The plain step (no program: one backward on the global batch, or
    f32 accumulation over microbatches) against the reference's. Adam's
    first step is g / (|g| + 1e-8): a gradient within rounding of zero
    may move its parameter by up to 2 lr, so the warmup keeps the first
    lr at 1e-4 and the 1e-5 tolerance checks the step, not that."""
    from repro.train.step import build_train_step as ref_build
    from repro_torch.train import build_train_step
    ref_api, ref_params, api, params = _pair()
    b = _batch(api.cfg.vocab_size, 4, 16)
    ref_opt = RefAdamW(lr=1e-3, warmup=10, total_steps=20)
    opt = AdamW(lr=1e-3, warmup=10, total_steps=20)
    want_p, _, want_m = ref_build(ref_api, ref_opt, remat=False,
                                  microbatches=microbatches,
                                  donate=False).jitted(
        ref_params, ref_opt.init(ref_params),
        {k: jnp.asarray(v) for k, v in b.items()})
    got_p, _, got_m = build_train_step(api, opt, remat=False,
                                       microbatches=microbatches,
                                       device="cpu").fn(
        params, opt.init(params), _torch_batch(b))
    assert sorted(got_m) == sorted(want_m)
    for k in got_m:
        assert abs(float(got_m[k]) - float(want_m[k])) <= \
            1e-5 * max(1.0, abs(float(want_m[k]))), k
    for (path, g), (_, w) in zip(zip(*tree_flatten(got_p)),
                                 _ref_leaves(want_p)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=str(path))


def test_program_options_keep_the_step():
    """A stacked per-worker batch equals the global batch split in
    contiguous shards, and scan-row bucket groups with microbatches and
    the pipelined round order equal the eager single-group step."""
    _, _, api, params = _pair()
    opt = AdamW(lr=1e-3, warmup=2, total_steps=10)
    b = _torch_batch(_batch(api.cfg.vocab_size, 12, 16))
    alive = torch.tensor([1.0, 0.0, 1.0])
    pc = PhaserCollective(3, "data", kind="phaser_scsl", seed=0)

    def run(batch, **kw):
        prog = build_gradsync_program(api, opt, pc, device="cpu", **kw)
        p, _, pm = prog.step(params, opt.init(params), batch, alive)
        return tree_flatten(p)[1], prog.reduce_metrics(pm)
    base, _ = run(b)
    stacked, _ = run({k: v.reshape(3, 4, -1) for k, v in b.items()},
                     stacked=True)
    assert all(torch.equal(x, y) for x, y in zip(base, stacked))
    eager, m = run(b, microbatches=2)
    piped, mp = run(b, microbatches=2, overlap="pipelined", block_groups=2)
    assert mp["bucket_groups"] == 4 and m["bucket_groups"] == 3
    assert all(torch.equal(x, y) for x, y in zip(eager, piped))


@pytest.mark.parametrize("overlap", ["eager", "pipelined"])
def test_program_keeps_its_last_sync(overlap):
    """After a step the program holds the stacked buffer it synced and
    rank 0's reduced row, which is the stack's sum."""
    _, _, api, params = _pair()
    opt = AdamW(lr=1e-3, warmup=2, total_steps=10)
    pc = PhaserCollective(3, "data", kind="phaser_scsl", seed=0)
    prog = build_gradsync_program(api, opt, pc, device="cpu",
                                  overlap=overlap, block_groups=2)
    prog.step(params, opt.init(params),
              _torch_batch(_batch(api.cfg.vocab_size, 12, 16)),
              torch.tensor([1.0, 0.0, 1.0]))
    stacked, row0 = prog.last_sync()
    assert stacked.shape == (3, prog.layout.n_buckets,
                             prog.layout.bucket_elems)
    assert row0.shape == stacked.shape[1:]
    assert float(row0.reshape(-1)[prog.layout.flag_index]) == 2.0
    np.testing.assert_allclose(row0.numpy(), stacked.sum(0).numpy(),
                               rtol=1e-5, atol=1e-6)


def _port_loop(api, ckpt=None, **kw):
    return TrainLoop(api=api, opt=AdamW(lr=3e-3, warmup=2, total_steps=9),
                     data=SyntheticLM(vocab=api.cfg.vocab_size, batch=12,
                                      seq=16, seed=0),
                     log_every=1, device_collective=True, ckpt=ckpt,
                     ckpt_every=1000,
                     runtime=ElasticPhaserRuntime(4, seed=0,
                                                  kind="phaser_scsl"),
                     elastic_events=launch_train.parse_elastic(CHURN),
                     device="cpu", **kw)


def test_elastic_loop_matches_reference(reference_runs):
    """Workers 4 -> 6 -> 3 (a failure and two leaves in one phase): the
    same epoch log and program-cache counts, per-step losses and final
    params within 1e-4."""
    saved = reference_runs["loop"]
    _, _, api, params = _pair()
    loop = _port_loop(api)
    p, _ = loop.run(9, params=params)
    assert loop.epoch_log == json.loads(str(saved["epoch_log"]))
    assert [len(e["live"]) for e in loop.epoch_log] == [6, 3]
    assert loop._progs.stats() == json.loads(str(saved["cache"]))
    np.testing.assert_allclose([m["loss"] for m in loop.metrics_log],
                               saved["loss"], rtol=1e-4, atol=1e-4)
    _assert_saved_close(p, saved, "params", 1e-4)


# --------------------------------------------------------------- resume
def test_resume_at_epoch_boundary_is_bitwise(tmp_path):
    """Save at the 4 -> 6 boundary, resume in a fresh loop (events
    replayed, the epoch's program built before step 1): the rest of the
    run is bitwise the uninterrupted one."""
    _, _, api, params = _pair()
    seen = {}
    whole = _port_loop(api)
    whole.run(9, params=params,
              on_step=lambda s, p, m: seen.setdefault(s, (p, m["loss"])))
    first = _port_loop(api, ckpt=CheckpointManager(str(tmp_path)))
    first.run(3, params=params)
    assert first.ckpt.program_key()["member_set"] == [0, 1, 2, 3, 4, 5]
    resumed = _port_loop(api, ckpt=CheckpointManager(str(tmp_path)))
    got = {}
    resumed.run(9, resume=True, params=params,
                on_step=lambda s, p, m: got.setdefault(s, (p, m["loss"])))
    assert sorted(got) == list(range(3, 9))
    assert resumed._progs.stats()["hits"] >= 1     # built before step 1
    # phase counters restart on a resume (not part of the checkpoint)
    strip = lambda log: [{k: v for k, v in e.items() if k != "phase"}
                         for e in log]
    assert strip(resumed.epoch_log) == strip(whole.epoch_log[1:])
    for s in range(3, 9):
        assert torch.equal(got[s][1], seen[s][1])
        for a, b in zip(tree_flatten(got[s][0])[1],
                        tree_flatten(seen[s][0])[1]):
            assert torch.equal(a, b)


def test_checkpoint_keeps_bf16_bits(tmp_path):
    cfg = get_config("smollm-135m").reduced(dtype="bfloat16")
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    opt = AdamW()
    st = opt.init(params)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(7, params, st, extra={"data": {"seed": 0, "step": 7}})
    step, tree, extra = mgr.restore({"params": params, "opt": st._asdict()})
    assert step == 7 and extra["data"]["step"] == 7
    for a, b in zip(tree_flatten(tree["params"])[1], tree_flatten(params)[1]):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    names = json.loads((tmp_path / "step_000000007" / "manifest.json")
                       .read_text())["leaves"]
    assert "params_blocks_attn_wq" in names and "opt_step" in names


# ------------------------------------------------------------------ CLI
def test_train_cli_elastic_on_cpu(capsys):
    rc = launch_train.main(["--arch", "smollm-135m", "--reduced",
                            "--device", "cpu", "--workers", "3",
                            "--batch", "12", "--seq", "16", "--steps", "8",
                            "--elastic", "join@2,fail@5"])
    out = capsys.readouterr().out
    assert rc == 0, out
    bounds = [json.loads(l)["epoch_boundary"] for l in out.splitlines()
              if l.startswith('{"epoch_boundary"')]
    assert [len(b["live"]) for b in bounds] == [4, 3]
    assert "(DECREASED)" in out


def test_train_cli_trace_and_metrics(tmp_path, capsys):
    """``--trace``: host spans for every step and re-build, plus each
    program's round grid once per build (the reference emits it once
    per lowering); ``--metrics-out``: step timings and cache counts."""
    trace, mets = tmp_path / "t.json", tmp_path / "m.json"
    rc = launch_train.main(["--reduced", "--device", "cpu", "--workers",
                            "3", "--batch", "12", "--seq", "16", "--steps",
                            "6", "--elastic", "join@2", "--trace",
                            str(trace), "--metrics-out", str(mets)])
    assert rc in (0, 1), capsys.readouterr().out
    events = json.loads(trace.read_text())["traceEvents"]
    names = [e["name"] for e in events]
    assert names.count("train.step") == 6
    assert names.count("epoch.relower") == 1
    rounds = sum(PhaserCollective(n, "data", kind="phaser_scsl",
                                  keys=keys).stats()["rounds"]
                 for n, keys in ((3, (0, 1, 2)), (4, (0, 1, 2, 3))))
    assert sum(e.get("cat") == "gradsync" for e in events) == rounds
    counters = json.loads(mets.read_text())["metrics"]["counters"]
    assert counters["program_cache.misses"] == 2
    assert counters["train.relower"] == 1


def test_pipeline_stages_are_not_ported_yet():
    """The 2-D pipeline is ported (``tests/test_torch_pipeline.py``); what
    stays refused is a pipeline without the collective program, as the
    reference's loop refuses it."""
    _, _, api, _ = _pair()
    from repro_torch.train import build_train_step
    with pytest.raises(ValueError, match="collective program"):
        build_train_step(api, AdamW(), pipeline_stages=2, device="cpu")
    step = build_train_step(
        api, AdamW(), pipeline_stages=2, device="cpu", program=True,
        collective=PhaserCollective(2, "data", kind="xla_psum"))
    assert step.program.n_stages == 2


def test_train_cli_refuses_what_is_not_ported(capsys):
    """Every option of the reference's CLI is ported (the multi-host
    runtime: ``tests/test_torch_dist.py``); what stays refused is what the
    reference refuses too: a crash without host processes, link chaos
    without a socket fabric, and host ranks without hosts."""
    for extra, msg in ((["--elastic", "kill@3"], "need --processes > 1"),
                       (["--processes", "2", "--chaos-links", "0|1@1+1"],
                        "needs --fabric socket|tcp"),
                       (["--host-devices", "2"], "--processes > 1")):
        with pytest.raises(SystemExit):
            launch_train.main(["--reduced", "--device", "cpu", *extra])
        assert msg in capsys.readouterr().err
