"""The port's MoE family against the JAX package's, reduced mixtral-8x7b
(top-2, sliding window 16) and llama4-scout (top-1) in f32, from the
same parameters (initialised by JAX, carried across by
``params_from_jax``), within 1e-4 unless stated:

- ``moe_apply`` alone, as one group (T = group size, no padding) and
  with T not a multiple of the group size, where the zero-padded rows'
  router probabilities all tie (the top-k order then decides the aux
  loss, held to 1e-6);
- the forward's logits, caches and aux loss with several dispatch
  groups and a padded tail;
- decode steps past the window (a ring buffer for mixtral, dropped
  writes for llama4), where a step's B tokens overflow an expert's
  capacity of 1;
- the loss and every gradient against ``jax.grad``;
- the ``ServeEngine`` against the JAX engine on the same requests:
  identical greedy tokens, epochs and counters (bulk KV admission)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.models.registry import get_api as ref_get_api
from repro.models.registry import get_config as ref_get_config
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.registry import get_api, get_config
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, ServeEngine
from test_torch_serve import MARGIN, _MarginProbe

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e")


@functools.lru_cache(maxsize=None)
def _pair(arch, **overrides):
    """(JAX api, JAX params, port api, port params) of the reduced
    ``arch``, built once a module (no test mutates them)."""
    ref_cfg = ref_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    assert cfg == type(cfg)(**ref_cfg.__dict__)
    ref_api = ref_get_api(ref_cfg)
    ref_params = ref_api.init_params(jax.random.key(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             cfg, device="cpu")
    return ref_api, ref_params, get_api(cfg), params


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# (B, S, group size): one group of all 16 tokens; 14 tokens in groups of
# 4, whose last group holds 2 zero rows
CASES = {"one-group": (2, 8, 16), "padded-ties": (2, 7, 4)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches(arch, case):
    cfg = get_config(arch).reduced()
    B, S, group = CASES[case]
    ref_p = ref_moe.moe_init(jax.random.key(1), cfg.d_model, cfg.d_ff,
                             cfg.n_experts, layers=None, dtype=jnp.float32)
    p = {k: torch.tensor(np.asarray(v)) for k, v in ref_p.items()}
    x = np.random.default_rng(0).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
              group_size=group)
    want_y, want_aux = jax.jit(functools.partial(ref_moe.moe_apply, **kw))(
        ref_p, jnp.asarray(x))
    y, aux = moe.moe_apply(p, torch.tensor(x), **kw)
    assert y.shape == (B, S, cfg.d_model) and aux.dtype == torch.float32
    _close(y, want_y)
    _close(aux, want_aux, rtol=1e-6, atol=1e-6)
    if case == "padded-ties":
        # the pad rows' probabilities tie: the first choice is expert 0
        assert (B * S) % group
        pad = torch.zeros((1, cfg.d_model)) @ p["router"]
        _, idx = moe._top_k(torch.softmax(pad, -1), cfg.top_k)
        assert idx.tolist() == [list(range(cfg.top_k))]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_caches_and_aux_match(arch):
    # 3 x 13 = 39 tokens in groups of 16: three groups, 9 padded rows
    ref_api, ref_params, api, params = _pair(arch, moe_group_size=16)
    tokens = np.random.default_rng(0).integers(
        0, api.cfg.vocab_size, (3, 13)).astype(np.int32)
    # the reference's prefill_full_fn is this forward without its aux
    want_logits, want_aux, want_caches = jax.jit(functools.partial(
        ref_tf.forward, ref_api.cfg, want_cache=True))(
        ref_params, jnp.asarray(tokens))
    logits, caches = api.prefill_full_fn(params,
                                         {"tokens": torch.tensor(tokens)})
    assert logits.shape == (3, 13, api.cfg.vocab_size)
    _close(logits, want_logits)
    for leaf in ("k", "v"):
        _close(caches["layers"][leaf], want_caches["layers"][leaf])
    _, aux, _ = tf.forward(api.cfg, params, torch.tensor(tokens))
    assert float(aux) > 0
    _close(aux, want_aux, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_past_the_window(arch):
    ref_api, ref_params, api, params = _pair(arch)
    B, W = 3, 20                # mixtral's cache is its 16-slot ring
    rng = np.random.default_rng(1)
    ref_state = ref_api.init_decode_state(B, W)
    state = api.init_decode_state(B, W, device="cpu")
    decode = jax.jit(ref_api.decode_fn)
    for step in range(22):
        tok = rng.integers(0, api.cfg.vocab_size, (B,)).astype(np.int32)
        t = np.array([step, step + 2, step + 1], np.int32)
        want, ref_state = decode(ref_params, ref_state,
                                 {"token": jnp.asarray(tok),
                                  "t": jnp.asarray(t)})
        got, state = api.decode_fn(params, state,
                                   {"token": torch.tensor(tok),
                                    "t": torch.tensor(t)})
        _close(got, want)
    assert int(t.max()) >= W
    for leaf in ("k", "v", "pos"):
        _close(state["layers"][leaf], ref_state["layers"][leaf])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(arch):
    ref_api, ref_params, api, params = _pair(arch, moe_group_size=16)
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, api.cfg.vocab_size, (2, 11)).astype(np.int32)
             for k in ("tokens", "targets")}
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        ref_api.loss_fn, has_aux=True))(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    (total, metrics), grads = api.value_and_grad(
        params, {k: torch.tensor(v) for k, v in batch.items()})
    _close(total, want)
    _close(metrics["aux"], want_m["aux"], rtol=1e-6, atol=1e-6)
    got = params_to_numpy(grads, api.cfg)
    flat = jax.tree_util.tree_flatten_with_path(want_g)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(leaf), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


def _requests(cls, vocab):
    # bulk admission in three length buckets (1, 8, 16; three prefill
    # traces), one prompt past the 16-slot ring (token by token), decode
    # wrapping the ring, slot reuse
    rng = np.random.default_rng(0)
    lengths = [5, 14, 1, 9, 20, 10, 16, 7]
    max_new = [12, 6, 3, 14, 4, 1, 8, 5]
    return [cls(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                max_new=m) for i, (n, m) in enumerate(zip(lengths, max_new))]


def test_engine_matches_reference(monkeypatch):
    ref_api, ref_params, api, params = _pair("mixtral-8x7b")
    ref_eng = RefEngine(ref_api, ref_params, batch=4, window=32)
    eng = ServeEngine(api, params, batch=4, window=32)
    probe = _MarginProbe(eng)
    monkeypatch.setattr(engine_mod, "torch", probe)
    ref_reqs = _requests(RefRequest, api.cfg.vocab_size)
    reqs = _requests(Request, api.cfg.vocab_size)
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
    counters = eng.metrics.snapshot()["counters"]
    assert counters == ref_eng.metrics.snapshot()["counters"]
    assert counters["serve.admit.kv"] == 7
    assert counters["serve.admit.sequential"] == 1
    assert counters["serve.prefill.traces"] == 3
    for leaf in ("k", "v", "pos"):
        _close(eng.state["layers"][leaf], ref_eng.state["layers"][leaf])
