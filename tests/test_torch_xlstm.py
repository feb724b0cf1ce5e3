"""The port's xLSTM family (xlstm-125m) against the JAX package, on the
CPU, from the same inputs (numpy seeds) and parameters (initialised by
JAX, carried across by ``params_from_jax``).

The reduced config has 4 layers in 2 groups of (1 mLSTM + 1 sLSTM),
d_model 64, 4 heads: the mLSTM's head dim is 32, the sLSTM's 16.

Tolerances: ``mlstm_chunkwise_plain`` against the Pallas kernel in
interpret mode and against the exact recurrence ``mlstm_ref`` in f32
2e-4 (the reference kernel test's). The blocks and decode steps in f32
1e-5, except ``mlstm_apply`` 5e-5: with its gates perturbed to scale 0.2
both f32 evaluations lie up to 2e-5 from an f64 one at S = 300. The
model's logits, states and caches 1e-4, gradients 1e-4 of each
leaf's largest value. The serving engine: identical token streams,
epochs, events and ``serve.*`` counters, with every consumed argmax won
by more than 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_kernels
from repro.kernels.ops import mlstm_op
from repro.models import xlstm as ref_xl
from repro.models.registry import get_api as ref_get_api
from repro.models.registry import get_config as ref_get_config
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.data import make_batch
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.kernels.mlstm_kernel import (mlstm_chunkwise,
                                              mlstm_chunkwise_plain)
from repro_torch.launch import serve as launch_serve
from repro_torch.models import xlstm as XL
from repro_torch.models.registry import get_api, get_config
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.utils import tree_flatten
from test_torch_serve import MARGIN, _MarginProbe
from test_torch_ssm import _assert_tree_close

ARCH = "xlstm-125m"
TOL = 2e-4


def _mlstm_inputs(B, NH, S, hd, seed=0):
    """The reference kernel test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, NH, S, hd)).astype(np.float32)
    k = (rng.standard_normal((B, NH, S, hd)) / np.sqrt(hd)).astype(np.float32)
    v = rng.standard_normal((B, NH, S, hd)).astype(np.float32)
    logi = (rng.standard_normal((B, NH, S)) * 0.5).astype(np.float32)
    logf = -np.log1p(np.exp(-(rng.standard_normal((B, NH, S)) + 2.0))
                     ).astype(np.float32)
    return (tuple(jnp.asarray(t) for t in (q, k, v, logi, logf)),
            tuple(torch.tensor(t) for t in (q, k, v, logi, logf)))


# ------------------------------------------------------------ the kernel
@pytest.mark.parametrize("B,NH,S,hd,chunk", [(2, 2, 256, 64, 64),
                                             (1, 4, 512, 32, 128)])
def test_mlstm_plain_matches_pallas_interpret(B, NH, S, hd, chunk):
    jin, tin = _mlstm_inputs(B, NH, S, hd)
    want = mlstm_op(*jin, chunk=chunk, interpret=True)
    got = mlstm_chunkwise_plain(*tin, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (B, NH, S, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("B,NH,S,hd,chunk", [
    (2, 3, 200, 32, 64),            # ragged: 200 = 3 chunks + 8 rows
    (1, 2, 300, 64, 256),           # ragged: one chunk + 44 rows
    (1, 2, 1, 32, 256)])            # one row
def test_mlstm_plain_matches_recurrence(B, NH, S, hd, chunk):
    jin, tin = _mlstm_inputs(B, NH, S, hd, seed=1)
    want = ref_kernels.mlstm_ref(*jin)
    got = mlstm_chunkwise_plain(*tin, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_mlstm_out_dtype_keeps_f32():
    """bf16 q/k/v with ``out_dtype=float32`` are the f32 recurrence of
    the bf16 values (the model keeps the result in f32), not a rounded
    one; the chunk length changes only rounding."""
    _, tin = _mlstm_inputs(1, 2, 70, 32, seed=2)
    tin = tuple(t.to(torch.bfloat16) for t in tin[:3]) + tin[3:]
    got = mlstm_chunkwise(*tin, out_dtype=torch.float32)  # CPU: the plain
    want = mlstm_chunkwise_plain(*(t.float() for t in tin))
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    other = mlstm_chunkwise_plain(*tin, chunk=16, out_dtype=torch.float32)
    torch.testing.assert_close(other, got, rtol=1e-5, atol=1e-5)
    assert mlstm_chunkwise(*tin).dtype == torch.bfloat16


def _bf16_split(t, lo=True):
    """hi + lo, each a bf16 value: the two operands the tensor-core kernel
    feeds for one f32 operand (hi alone where the lo product is
    dropped)."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float() if lo else hi


LO_PRODUCTS = ("w", "c", "dv")    # W in W v, C in q C, dec o v in the update


def _mlstm_tensor_core_emulated(q, k, v, logi, logf, chunk=64,
                                lo=LO_PRODUCTS):
    """The bf16 CUDA kernel's arithmetic in plain f32: 64-row chunks (rows
    past S zero, logi = logf = 0); q kᵀ exact (bf16 inputs); m from the
    prefix max of logi - lf; W, C and dec ∘ v each rounded to a bf16 hi/lo
    pair before its product (hi alone for a product not in ``lo``), and n
    before q n; C, n, the gate vectors and every sum in f32."""
    B, NH, S, hd = q.shape
    q, k, v = q.float(), k.float(), v.float()
    C = torch.zeros(B, NH, hd, hd)
    n = torch.zeros(B, NH, hd)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    ys = []
    for s0 in range(0, S, chunk):
        nr = min(chunk, S - s0)

        def rows(t):
            t = t.narrow(2, s0, nr)
            shape = list(t.shape)
            shape[2] = chunk - nr
            return torch.cat([t, t.new_zeros(shape)], 2)

        qc, kc, vc, ic, fc = (rows(t) for t in (q, k, v, logi, logf))
        lf = torch.cumsum(fc, -1)
        m = torch.maximum(lf + torch.cummax(ic - lf, -1).values, lf)
        a, b = lf - m, ic - lf
        W = torch.where(causal, qc @ kc.transpose(-1, -2)
                        * torch.exp(a[..., :, None] + b[..., None, :]),
                        torch.tensor(0.0))
        wl = torch.exp(a)
        qn = (qc @ _bf16_split(n)[..., None])[..., 0]
        den = torch.maximum((W.sum(-1) + wl * qn).abs(), torch.exp(-m))
        y = (_bf16_split(W, "w" in lo) @ vc
             + wl[..., None] * (qc @ _bf16_split(C, "c" in lo)))
        ys.append((y / den[..., None])[:, :, :nr])
        dec = torch.exp(lf[..., -1:] - lf + ic)
        eend = torch.exp(lf[..., -1])
        C = eend[..., None, None] * C + kc.transpose(-1, -2) @ _bf16_split(
            vc * dec[..., None], "dv" in lo)
        n = eend[..., None] * n + (kc * dec[..., None]).sum(-2)
    return torch.cat(ys, 2)


def _xlstm_width_inputs(S, seed=3):
    """xlstm-125m's mLSTM head dim (384), two heads, q/k/v in bf16."""
    _, tin = _mlstm_inputs(1, 2, S, 384, seed=seed)
    return tuple(t.to(torch.bfloat16) for t in tin[:3]) + tin[3:]


@pytest.mark.parametrize("S", [2048, 1000])
def test_mlstm_tensor_core_rounding_fits_the_f32_tolerance(S):
    """The bf16 kernel's rounding points, emulated on the CPU at hd 384,
    against the f32 chunked mLSTM of the same bf16 inputs: within the 2e-4
    of max(1, max|y|) the card holds the kernel to (the emulation lands
    near 1e-4, a fortieth of it)."""
    tin = _xlstm_width_inputs(S)
    want = mlstm_chunkwise_plain(*tin, out_dtype=torch.float32)
    got = _mlstm_tensor_core_emulated(*tin)
    assert got.shape == want.shape
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= TOL * scale


@pytest.mark.parametrize("dropped", LO_PRODUCTS)
def test_mlstm_tensor_core_each_lo_product_is_needed(dropped):
    """Why each lo product stays: with any one of them dropped (one bf16
    rounding of W, of C or of dec ∘ v) y lands several times past the
    tolerance at S = 2048."""
    tin = _xlstm_width_inputs(2048)
    want = mlstm_chunkwise_plain(*tin, out_dtype=torch.float32)
    got = _mlstm_tensor_core_emulated(
        *tin, lo=tuple(p for p in LO_PRODUCTS if p != dropped))
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() > 3 * TOL * scale


# ------------------------------------------------------------ the blocks
D, NH = 64, 4


def _block_params(kind):
    key = jax.random.key(3)
    if kind == "mlstm":
        p = ref_xl.mlstm_init(key, D, n_heads=NH, layers=None,
                              dtype=jnp.float32)
        # non-trivial gates and forget bias (the init's are small and 3)
        rng = np.random.default_rng(4)
        p = dict(p, wi=jnp.asarray(rng.normal(size=p["wi"].shape) * 0.2,
                                   jnp.float32),
                 fb=jnp.asarray(rng.normal(size=NH) + 1.0, jnp.float32))
    else:
        p = ref_xl.slstm_init(key, D, n_heads=NH, layers=None,
                              dtype=jnp.float32)
        p = dict(p, b=jnp.asarray(np.random.default_rng(5).normal(
            size=p["b"].shape) * 0.5, jnp.float32))
    return p, {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("S", [1, 40, 300])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_apply_matches_reference(kind, S):
    ref_p, p = _block_params(kind)
    u = np.random.default_rng(S).normal(size=(2, S, D)).astype(np.float32)
    ref_fn, fn = ((ref_xl.mlstm_apply, XL.mlstm_apply) if kind == "mlstm"
                  else (ref_xl.slstm_apply, XL.slstm_apply))
    want = ref_fn(ref_p, jnp.asarray(u), n_heads=NH)
    got = fn(p, torch.tensor(u), n_heads=NH)
    tol = 5e-5 if kind == "mlstm" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_steps_match_reference(kind):
    """Six tokens from the zero state (the decode state's start, ``m``
    included); each output and every state leaf after them."""
    ref_p, p = _block_params(kind)
    rng = np.random.default_rng(6)
    if kind == "mlstm":
        ref_step, step = ref_xl.mlstm_decode_step, XL.mlstm_decode_step
        shapes = XL.mlstm_state_shapes(2, D, n_heads=NH)
    else:
        ref_step, step = ref_xl.slstm_decode_step, XL.slstm_decode_step
        shapes = XL.slstm_state_shapes(2, D, n_heads=NH)
    st = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in shapes.items()}
    ref_st = {k: jnp.zeros(s, jnp.float32) for k, (s, _) in shapes.items()}
    for _ in range(6):
        u = rng.normal(size=(2, 1, D)).astype(np.float32)
        want, ref_st = ref_step(ref_p, jnp.asarray(u), ref_st, n_heads=NH)
        got, st = step(p, torch.tensor(u), st, n_heads=NH)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    for leaf in shapes:
        np.testing.assert_allclose(st[leaf].numpy(), np.asarray(ref_st[leaf]),
                                   rtol=1e-5, atol=1e-5, err_msg=leaf)


# ----------------------------------------------------------- the model
@pytest.fixture(scope="module")
def pair():
    ref_cfg = ref_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    assert cfg.__dict__ == ref_cfg.__dict__
    ref_api = ref_get_api(ref_cfg)
    ref_params = ref_api.init_params(jax.random.key(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             cfg, device="cpu")
    return ref_api, ref_params, get_api(cfg), params


def test_config_matches_reference():
    cfg = get_config(ARCH)
    assert cfg.__dict__ == ref_get_config(ARCH).__dict__
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.slstm_every) == \
        (12, 768, 4, 4)
    assert XL.mlstm_dims(cfg.d_model, cfg.n_heads) == (1536, 384)
    assert cfg.param_count() == ref_get_config(ARCH).param_count()


def test_param_spec_and_round_trip(pair):
    ref_api, ref_params, api, params = pair
    spec = api.param_spec()
    sp, sl = tree_flatten(spec)
    pp, pl = tree_flatten(params)
    assert sp == pp
    for s, t in zip(sl, pl):
        assert s.shape == t.shape and s.dtype == t.dtype
    init = api.init_params(torch.Generator().manual_seed(0), "cpu")
    assert [(tuple(t.shape), t.dtype) for t in tree_flatten(init)[1]] == \
        [(tuple(t.shape), t.dtype) for t in sl]
    back = params_to_numpy(params, api.cfg)
    _assert_tree_close(back, ref_params, 0.0, "round trip")
    # at full width in bf16 the gates and biases stay f32, as in the
    # reference's tree
    full = get_api(ARCH).param_spec()["blocks"]
    ref_full = jax.eval_shape(ref_get_api(ARCH).init_params,
                              jax.random.key(0))["blocks"]
    for blk, leaf in (("mlstm", "wi"), ("mlstm", "wf"), ("mlstm", "fb"),
                      ("slstm", "b"), ("mlstm", "wq"), ("slstm", "wr")):
        want = ref_full[blk][leaf]
        assert tuple(full[blk][leaf].shape) == want.shape
        assert str(full[blk][leaf].dtype).split(".")[1] == str(want.dtype)
    assert full["mlstm"]["wi"].dtype == torch.float32
    assert full["mlstm"]["wq"].dtype == torch.bfloat16
    # the init's distributions: wi/wf at the reference's 0.02 scale
    for name in ("wi", "wf"):
        np.testing.assert_allclose(float(init["blocks"]["mlstm"][name].std()),
                                   float(jnp.std(ref_params["blocks"]
                                                 ["mlstm"][name])), rtol=0.2)


def test_forward_logits_match(pair):
    ref_api, ref_params, api, params = pair
    tokens = np.random.default_rng(0).integers(
        0, api.cfg.vocab_size, (3, 300)).astype(np.int32)
    want_logits, want_caches = ref_api.prefill_full_fn(
        ref_params, {"tokens": jnp.asarray(tokens)})
    logits, caches = api.prefill_full_fn(
        params, {"tokens": torch.tensor(tokens, dtype=torch.long)})
    assert logits.shape == (3, 300, api.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)
    assert caches == {"layers": None} and want_caches["layers"] is None
    last, _ = api.prefill_fn(params, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(last.numpy(), np.asarray(want_logits[:, -1]),
                               rtol=1e-4, atol=1e-4)


def test_decode_steps_match(pair):
    ref_api, ref_params, api, params = pair
    B, W = 2, 8
    rng = np.random.default_rng(1)
    ref_state = ref_api.init_decode_state(B, W)
    state = api.init_decode_state(B, W, device="cpu")
    _assert_tree_close(state, ref_state, 0.0, "initial state")
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


def test_loss_and_grads_match(pair):
    ref_api, ref_params, api, params = pair
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


def test_prefill_state_matches(pair):
    """The length-masked decode pass: logits at each row's own len-1 and
    every state leaf (the stabilisers ``m`` included), for rows of 40
    and 23 tokens in one 40-row group (row 1 freezes for its last 17
    steps)."""
    ref_api, ref_params, api, params = pair
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
    assert set(state["layers"]) == {"mlstm", "slstm"}
    assert state["layers"]["mlstm"]["C"].shape == (2, 1, 2, 4, 32, 32)
    # the two admission algorithms agree: the chunked form's logits at
    # len-1 equal the recurrence's next-token logits
    full, _ = api.prefill_full_fn(params, {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(full[[0, 1], lengths - 1].numpy(),
                               nxt.numpy(), rtol=1e-4, atol=1e-4)


def test_decode_state_bdims_match(pair):
    ref_api, _, api, _ = pair
    want = ref_api.decode_state_bdims(4, 16)
    got = api.decode_state_bdims(4, 16)
    assert tree_flatten(got) == (
        [tuple(k.key for k in p) for p, _ in
         jax.tree_util.tree_flatten_with_path(want)[0]],
        jax.tree_util.tree_leaves(want))


# ----------------------------------------------------------- serving
def test_engine_recurrent_bulk_matches_sequential(pair):
    """Lengths 5, 7, 6 share bucket 8 and length 3 takes bucket 4: two
    bulk groups, whose streams equal token-by-token admission's."""
    _, _, api, params = pair
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


def test_engine_matches_reference(pair, monkeypatch):
    """Against the JAX engine: prompts in several length buckets, one of
    40 past the window (the sequential path, whose fresh-slot reset
    clears a reused slot's mLSTM and sLSTM carries), ``max_new=1``
    requests retired at admission, and more requests than slots (slot
    reuse)."""
    ref_api, ref_params, api, params = pair
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
    rc = launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                            "--requests", "5", "--batch", "2", "--window",
                            "16", "--prompt-len", "20", "--max-new", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "served 5/5 requests" in out
