"""The port's SSM and hybrid (zamba2) families against the JAX package,
on the CPU, from the same inputs (numpy seeds) and parameters
(initialised by JAX, carried across by ``params_from_jax``).

Tolerances: ``mamba2_scan_plain`` against the Pallas kernel in interpret
mode in f32 1e-4 (both are f32 evaluations of the same chunked scan and
each lies up to ~1e-4 from an f64 evaluation of the recurrence at these
shapes: the cumulative log-decay reaches ~-100, so one rounding of it
moves exp(la) by ~1e-5 relative), in bf16 3e-2; against the exact
recurrence ``mamba2_ref`` the reference test's 1e-3 (f32) and 3e-2
(bf16). The model in f32: 1e-5 for ``ssm_apply`` and decode steps, 1e-4
for logits, states and caches, gradients 1e-4 of each leaf's largest
value. The serving engine: identical token streams, epochs, events and
``serve.*`` counters, with every consumed argmax won by more than 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_kernels
from repro.kernels.ops import mamba2_scan_op
from repro.models import ssm as ref_ssm
from repro.models.registry import get_api as ref_get_api
from repro.models.registry import get_config as ref_get_config
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.data import make_batch
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.kernels.mamba2_scan import mamba2_scan, mamba2_scan_plain
from repro_torch.launch import serve as launch_serve
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer
from repro_torch.models.registry import get_api, get_config
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.utils import tree_flatten
from test_torch_serve import MARGIN, _MarginProbe

SCAN_SHAPES = [(2, 2, 256, 64, 16, 64), (1, 4, 512, 32, 64, 128),
               (2, 1, 128, 64, 64, 128)]
VARIANTS = {"zamba2-reduced": {},
            "ssm-reduced": {"family": "ssm", "hybrid_attn_every": 0}}


def _scan_inputs(B, NH, S, P, N, dtype, seed=0):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, NH, S, P)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    Cm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, NH, S)))).astype(np.float32)
    a = np.exp(-np.log1p(np.exp(rng.standard_normal((B, NH, S))))
               ).astype(np.float32)
    jx, jb, jc = (jnp.asarray(t).astype(dtype) for t in (x, Bm, Cm))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx, tb, tc = (torch.tensor(np.asarray(t.astype(jnp.float32))).to(tdt)
                  for t in (jx, jb, jc))
    return ((jx, jb, jc, jnp.asarray(a), jnp.asarray(dt)),
            (tx, tb, tc, torch.tensor(a), torch.tensor(dt)))


def _f32(t):
    return np.asarray(t.float().numpy() if torch.is_tensor(t) else
                      np.asarray(t, np.float32), np.float32)


# ------------------------------------------------------------ the scan
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,NH,S,P,N,chunk", SCAN_SHAPES)
def test_scan_plain_matches_pallas_interpret(B, NH, S, P, N, chunk, dtype):
    jin, tin = _scan_inputs(B, NH, S, P, N, dtype)
    want = mamba2_scan_op(*jin, chunk=chunk, interpret=True)
    got = mamba2_scan(*tin, chunk=chunk)            # CPU: the plain version
    assert got.dtype == tin[0].dtype and got.shape == (B, NH, S, P)
    tol = 3e-2 if dtype == jnp.bfloat16 else 1e-4
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,NH,S,P,N,chunk", SCAN_SHAPES + [
    (2, 3, 200, 16, 16, 64),        # ragged: 200 = 3 chunks + 8 rows
    (1, 2, 1, 32, 16, 256)])        # one row
def test_scan_plain_matches_recurrence(B, NH, S, P, N, chunk, dtype):
    jin, tin = _scan_inputs(B, NH, S, P, N, dtype, seed=1)
    want = ref_kernels.mamba2_ref(*jin)
    got = mamba2_scan_plain(*tin, chunk=chunk)
    tol = 3e-2 if dtype == jnp.bfloat16 else 1e-3
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_scan_out_dtype_keeps_f32():
    """bf16 inputs with ``out_dtype=float32`` are the f32 scan of the
    bf16 values (the model keeps the result in f32), not a rounded
    one."""
    _, tin = _scan_inputs(1, 2, 70, 16, 16, jnp.bfloat16, seed=2)
    got = mamba2_scan(*tin, chunk=64, out_dtype=torch.float32)
    want = mamba2_scan_plain(*(t.float() for t in tin), chunk=64)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


# --------------------------------------------------------- the block
SSM_KW = dict(state=16, conv=4, expand=2, headdim=16)


def _ssm_params(d_model=64):
    p = ref_ssm.ssm_init(jax.random.key(3), d_model, layers=None,
                         dtype=jnp.float32, **SSM_KW)
    # non-trivial decay, skip and bias (the init's are 0, 1, 0)
    rng = np.random.default_rng(4)
    nh = p["A_log"].shape[0]
    p = dict(p, A_log=jnp.asarray(rng.normal(size=nh) * 0.5, jnp.float32),
             D=jnp.asarray(rng.normal(size=nh), jnp.float32),
             dt_bias=jnp.asarray(rng.normal(size=nh) * 0.5, jnp.float32))
    return p, {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("S", [1, 40, 300])
def test_ssm_apply_matches_reference(S):
    ref_p, p = _ssm_params()
    u = np.random.default_rng(S).normal(size=(2, S, 64)).astype(np.float32)
    want = ref_ssm.ssm_apply(ref_p, jnp.asarray(u), **SSM_KW)
    got = SSM.ssm_apply(p, torch.tensor(u), **SSM_KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_ssm_decode_steps_match_reference():
    ref_p, p = _ssm_params()
    rng = np.random.default_rng(5)
    ref_st = ref_ssm.ssm_init_state(2, 64, dtype=jnp.float32, **SSM_KW)
    st = SSM.ssm_init_state(2, 64, dtype=torch.float32, device="cpu",
                            **SSM_KW)
    for _ in range(6):
        u = rng.normal(size=(2, 1, 64)).astype(np.float32)
        want, ref_st = ref_ssm.ssm_decode_step(ref_p, jnp.asarray(u), ref_st,
                                               **SSM_KW)
        got, st = SSM.ssm_decode_step(p, torch.tensor(u), st, **SSM_KW)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    for leaf in ("h", "conv"):
        np.testing.assert_allclose(st[leaf].numpy(), np.asarray(ref_st[leaf]),
                                   rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- the model
def _pair(variant):
    ov = VARIANTS[variant]
    ref_cfg = ref_get_config("zamba2-7b").reduced(**ov)
    cfg = get_config("zamba2-7b").reduced(**ov)
    assert cfg.__dict__ == ref_cfg.__dict__
    ref_api = ref_get_api(ref_cfg)
    ref_params = ref_api.init_params(jax.random.key(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             cfg, device="cpu")
    return ref_api, ref_params, get_api(cfg), params


def _assert_tree_close(got, want, tol, what=""):
    """Every leaf of a port tree within ``tol`` of the JAX tree's, the
    two trees having the same leaves in the same (sorted-key) order."""
    gp, gl = tree_flatten(got)
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert gp == [tuple(k.key for k in p) for p, _ in wl], what
    for path, g, (_, w) in zip(gp, gl, wl):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=tol, atol=tol,
                                   err_msg=f"{what} {path}")


def test_config_matches_reference():
    assert (get_config("zamba2-7b").__dict__
            == ref_get_config("zamba2-7b").__dict__)
    assert get_config("zamba2-7b").param_count() == 6_750_245_968


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_param_spec_and_round_trip(variant):
    ref_api, ref_params, api, params = _pair(variant)
    spec = api.param_spec()
    sp, sl = tree_flatten(spec)
    pp, pl = tree_flatten(params)
    assert sp == pp
    for s, t in zip(sl, pl):
        assert s.shape == t.shape and s.dtype == t.dtype
    assert params["blocks"]["ssm"]["A_log"].dtype == torch.float32
    init = api.init_params(torch.Generator().manual_seed(0), "cpu")
    assert [(tuple(t.shape), t.dtype) for t in tree_flatten(init)[1]] == \
        [(tuple(t.shape), t.dtype) for t in sl]
    back = params_to_numpy(params, api.cfg)
    _assert_tree_close(back, ref_params, 0.0, "round trip")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_and_caches_match(variant):
    ref_api, ref_params, api, params = _pair(variant)
    tokens = np.random.default_rng(0).integers(
        0, api.cfg.vocab_size, (3, 37)).astype(np.int32)
    want_logits, want_caches = ref_api.prefill_full_fn(
        ref_params, {"tokens": jnp.asarray(tokens)})
    logits, caches = api.prefill_full_fn(
        params, {"tokens": torch.tensor(tokens, dtype=torch.long)})
    assert logits.shape == (3, 37, api.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)
    if variant == "ssm-reduced":
        assert caches == {"layers": None} and want_caches["layers"] is None
    else:
        G = transformer.n_shared_apps(api.cfg)
        assert caches["layers"]["k"].shape == (G, 3, 37, 2, 16)
        _assert_tree_close(caches, want_caches, 1e-4, "caches")
    last, _ = api.prefill_fn(params, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(last.numpy(), np.asarray(want_logits[:, -1]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_steps_match(variant):
    """12 tokens through a window of 8: the hybrid's ring-buffer cache
    wraps, and the SSM carries run over every step."""
    ref_api, ref_params, api, params = _pair(variant)
    B, W = 2, 8
    rng = np.random.default_rng(1)
    ref_state = ref_api.init_decode_state(B, W)
    state = api.init_decode_state(B, W, device="cpu")
    decode = jax.jit(ref_api.decode_fn)
    for step in range(12):
        tok = rng.integers(0, api.cfg.vocab_size, (B,)).astype(np.int32)
        t = np.array([step, step + 3], np.int32)
        want, ref_state = decode(ref_params, ref_state,
                                 {"token": jnp.asarray(tok),
                                  "t": jnp.asarray(t)})
        got, state = api.decode_fn(params, state, {"token": torch.tensor(tok),
                                                   "t": torch.tensor(t)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    _assert_tree_close(state, ref_state, 1e-4, "state")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match(variant):
    ref_api, ref_params, api, params = _pair(variant)
    b = make_batch(api.cfg.vocab_size, 2, 21, seed=0, step=0)
    (want_total, want_m), want_g = jax.value_and_grad(
        ref_api.loss_fn, has_aux=True)(
        ref_params, {k: jnp.asarray(v) for k, v in b.items()})
    (total, m), grads = api.value_and_grad(
        params, {k: torch.tensor(v) for k, v in b.items()})
    assert abs(float(total) - float(want_total)) <= 1e-5
    assert abs(float(m["loss"]) - float(want_m["loss"])) <= 1e-5
    gp, gl = tree_flatten(grads)
    wl = jax.tree_util.tree_flatten_with_path(want_g)[0]
    assert gp == [tuple(k.key for k in p) for p, _ in wl]
    for path, g, (_, w) in zip(gp, gl, wl):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), (path, err)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_state_matches(variant):
    """The length-masked decode pass: logits at each row's own len-1 and
    every state leaf, for rows of 40 and 23 tokens in one 40-row group
    (row 1 freezes for its last 17 steps, its KV writes included)."""
    ref_api, ref_params, api, params = _pair(variant)
    tokens = np.random.default_rng(2).integers(
        0, api.cfg.vocab_size, (2, 40)).astype(np.int32)
    lengths = np.array([40, 23], np.int32)
    want_nxt, want_state = ref_api.prefill_state_fn(
        ref_params, jnp.asarray(tokens), jnp.asarray(lengths), window=48)
    nxt, state = api.prefill_state_fn(params, torch.tensor(tokens), lengths,
                                      window=48)
    np.testing.assert_allclose(nxt.numpy(), np.asarray(want_nxt), rtol=1e-4,
                               atol=1e-4)
    _assert_tree_close(state, want_state, 1e-4, "state")
    # the two admission algorithms agree: the chunked scan's logits at
    # len-1 equal the recurrence's next-token logits
    full, _ = api.prefill_full_fn(params, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(full[[0, 1], lengths - 1].numpy(),
                               nxt.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_state_bdims_match(variant):
    ref_api, _, api, _ = _pair(variant)
    want = ref_api.decode_state_bdims(4, 16)
    got = api.decode_state_bdims(4, 16)
    assert tree_flatten(got) == (
        [tuple(k.key for k in p) for p, _ in
         jax.tree_util.tree_flatten_with_path(want)[0]],
        jax.tree_util.tree_leaves(want))


# ----------------------------------------------------------- serving
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_engine_recurrent_bulk_matches_sequential(variant):
    """Lengths 5, 7, 6 share bucket 8 and length 3 takes bucket 4: two
    bulk groups, whose streams equal token-by-token admission's."""
    _, _, api, params = _pair(variant)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 50, size=L).astype(np.int32)
               for L in (5, 7, 6, 3)]
    eng = ServeEngine(api, params, batch=4, window=32)
    groups = []
    orig = eng._admit_bulk_recurrent
    eng._admit_bulk_recurrent = \
        lambda g, b: (groups.append((len(g), b)), orig(g, b))[1]
    reqs = [Request(rid=i, prompt=p, max_new=4)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert sorted(groups) == [(1, 4), (3, 8)], groups

    seq = ServeEngine(api, params, batch=4, window=32)
    seq._bulk = seq._bulk_rec = False       # force token-by-token
    reqs2 = [Request(rid=i, prompt=p, max_new=4)
             for i, p in enumerate(prompts)]
    for r in reqs2:
        seq.submit(r)
    seq.run_until_drained()
    assert [r.out for r in reqs] == [r.out for r in reqs2]
    assert seq.metrics.snapshot()["counters"]["serve.admit.sequential"] == 4


LENGTHS = [5, 30, 1, 12, 40, 3, 17, 8, 2, 9]
MAX_NEW = [4, 6, 1, 5, 3, 1, 6, 2, 5, 4]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_engine_matches_reference(variant, monkeypatch):
    """Against the JAX engine: prompts in several length buckets, one of
    40 past the window (the sequential path with its fresh-slot reset),
    ``max_new=1`` requests retired at admission, and more requests than
    slots (slot reuse)."""
    ref_api, ref_params, api, params = _pair(variant)
    ref_eng = RefEngine(ref_api, ref_params, batch=4, window=32)
    eng = ServeEngine(api, params, batch=4, window=32)
    probe = _MarginProbe(eng)
    monkeypatch.setattr(engine_mod, "torch", probe)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, api.cfg.vocab_size, n).astype(np.int32)
               for n in LENGTHS]
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new=m)
                for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    reqs = [Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, MAX_NEW))]
    for a, b in zip(ref_reqs, reqs):
        ref_eng.submit(a)
        eng.submit(b)
    ref_done = ref_eng.run_until_drained()
    done = eng.run_until_drained()

    assert [r.rid for r in done] == [r.rid for r in ref_done]
    assert all(r.done and len(r.out) == r.max_new for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert min(probe.margins) > MARGIN
    assert eng.epoch == ref_eng.epoch
    assert len(eng.gate.events) == len(ref_eng.gate.events)
    assert ([(e.index, e.phase_start, e.live) for e in eng.gate.epochs]
            == [(e.index, e.phase_start, e.live)
                for e in ref_eng.gate.epochs])
    counters = eng.metrics.snapshot()["counters"]
    assert counters == ref_eng.metrics.snapshot()["counters"]
    assert counters["serve.admit.sequential"] == 1
    assert counters["serve.admit.rec"] == len(LENGTHS) - 1
    assert counters["serve.prefill_state.traces"] >= 3
    _assert_tree_close(eng.state, ref_eng.state, 1e-4, "engine state")


def test_launch_serve_cli_cpu(capsys):
    rc = launch_serve.main(["--arch", "zamba2-7b", "--reduced",
                            "--device", "cpu", "--requests", "5",
                            "--batch", "2", "--window", "16",
                            "--prompt-len", "20", "--max-new", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "served 5/5 requests" in out
