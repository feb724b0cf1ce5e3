"""The port's enc-dec (reduced whisper-small) and VLM backbone (reduced
llava-next-34b) against the JAX package's in f32, from the same
parameters (initialised by JAX, carried across by ``params_from_jax``),
within 1e-4:

- whisper: ``encode`` (non-causal self-attention over the frames), the
  teacher-forced ``forward`` logits and its cross K/V caches, decode
  steps past the self-attention window with the prefill's cross K/V
  copied into the state (as ``tests/test_arch_smoke.py`` fills it);
- llava: ``forward`` with the patch embeddings ahead of the tokens, its
  caches, and decode from the prefill's KV;
- both: the loss (llava's over the text positions only) and every
  gradient against ``jax.grad``, and the ``ServeEngine`` against the JAX
  engine (token-by-token admission from a zero state, as the reference
  engine admits these families)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as ref_encdec
from repro.models.registry import get_api as ref_get_api
from repro.models.registry import get_config as ref_get_config
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models import encdec
from repro_torch.models.registry import get_api, get_config
from repro_torch.serve.engine import Request, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
WHISPER, LLAVA = "whisper-small", "llava-next-34b"


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX api, JAX params, port api, port params) of the reduced
    ``arch``, built once a module (no test mutates them)."""
    ref_cfg = ref_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    assert cfg == type(cfg)(**ref_cfg.__dict__)
    ref_api = ref_get_api(ref_cfg)
    ref_params = ref_api.init_params(jax.random.key(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             cfg, device="cpu")
    return ref_api, ref_params, get_api(cfg), params


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _batch(cfg, B, S, seed, targets=False):
    """numpy inputs: tokens (and targets), plus frames or patches."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if targets:
        b["targets"] = rng.integers(0, cfg.vocab_size,
                                    (B, S)).astype(np.int32)
    if cfg.is_encdec:
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["patches"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.tensor(v) for k, v in b.items()})


def test_encode_matches():
    ref_api, ref_params, api, params = _pair(WHISPER)
    ref_b, b = _batch(api.cfg, 2, 3, seed=0)
    want = jax.jit(functools.partial(ref_encdec.encode, ref_api.cfg))(
        ref_params, ref_b["frames"])
    got = encdec.encode(api.cfg, params, b["frames"])
    assert got.shape == (2, api.cfg.encoder_seq, api.cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("arch", (WHISPER, LLAVA))
def test_prefill_then_decode_match(arch):
    ref_api, ref_params, api, params = _pair(arch)
    cfg = api.cfg
    B, S = 2, 9
    n_pre = cfg.vision_tokens + S
    W = 12 if cfg.is_encdec else n_pre + 6      # decode runs past W
    ref_b, b = _batch(cfg, B, S, seed=1)
    want_logits, want_caches = jax.jit(ref_api.prefill_full_fn)(ref_params,
                                                                ref_b)
    logits, caches = api.prefill_full_fn(params, b)
    assert logits.shape == (B, n_pre, cfg.vocab_size)
    _close(logits, want_logits)
    ref_state = ref_api.init_decode_state(B, W)
    state = api.init_decode_state(B, W, device="cpu")
    if cfg.is_encdec:
        assert set(caches) == {"cross_k", "cross_v"}
        for leaf in caches:
            _close(caches[leaf], want_caches[leaf])
            state[leaf].copy_(caches[leaf])
        ref_state = {**ref_state, **want_caches}
        t0 = 0                  # the decoder's self-attention starts empty
    else:
        for leaf in ("k", "v"):
            _close(caches["layers"][leaf], want_caches["layers"][leaf])
        # splice the prefill's KV (patches and tokens) into both states
        n = n_pre - 1
        for leaf in ("k", "v"):
            state["layers"][leaf][:, :, :n] = caches["layers"][leaf][:, :, :n]
        state["layers"]["pos"][:, :, :n] = torch.arange(n, dtype=torch.int32)
        ref_state = {"layers": {
            "k": ref_state["layers"]["k"].at[:, :, :n].set(
                want_caches["layers"]["k"][:, :, :n]),
            "v": ref_state["layers"]["v"].at[:, :, :n].set(
                want_caches["layers"]["v"][:, :, :n]),
            "pos": ref_state["layers"]["pos"].at[:, :, :n].set(
                jnp.arange(n, dtype=jnp.int32))}}
        t0 = n
    decode = jax.jit(ref_api.decode_fn)
    rng = np.random.default_rng(2)
    tok = b["tokens"][:, -1].numpy() if t0 else np.zeros(B, np.int32)
    for step in range(14):
        t = np.full((B,), t0 + step, np.int32)
        t[1] += 1
        want, ref_state = decode(ref_params, ref_state,
                                 {"token": jnp.asarray(tok),
                                  "t": jnp.asarray(t)})
        got, state = api.decode_fn(params, state,
                                   {"token": torch.tensor(tok),
                                    "t": torch.tensor(t)})
        _close(got, want)
        if step == 0 and t0:
            # the last prompt token decoded from the prefill's KV gives
            # the prefill's last logits
            _close(got[0], want_logits[0, -1])
        tok = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
    for leaf in ("k", "v", "pos"):
        _close(state["layers"][leaf], ref_state["layers"][leaf])


@pytest.mark.parametrize("arch", (WHISPER, LLAVA))
def test_loss_and_grads_match(arch):
    ref_api, ref_params, api, params = _pair(arch)
    ref_b, b = _batch(api.cfg, 2, 7, seed=3, targets=True)
    (want, _), want_g = jax.jit(jax.value_and_grad(
        ref_api.loss_fn, has_aux=True))(ref_params, ref_b)
    (total, _), grads = api.value_and_grad(params, b)
    _close(total, want)
    got = params_to_numpy(grads, api.cfg)
    flat = jax.tree_util.tree_flatten_with_path(want_g)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(leaf), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", (WHISPER, LLAVA))
def test_engine_matches_reference(arch):
    ref_api, ref_params, api, params = _pair(arch)
    ref_eng = RefEngine(ref_api, ref_params, batch=2, window=16)
    eng = ServeEngine(api, params, batch=2, window=16)
    rng = np.random.default_rng(4)
    mix = [(4, 5), (9, 3), (2, 6)]
    for i, (n, m) in enumerate(mix):
        prompt = rng.integers(0, api.cfg.vocab_size, n).astype(np.int32)
        ref_eng.submit(RefRequest(rid=i, prompt=prompt, max_new=m))
        eng.submit(Request(rid=i, prompt=prompt, max_new=m))
    ref_done = ref_eng.run_until_drained()
    done = eng.run_until_drained()
    assert [r.out for r in done] == [r.out for r in ref_done]
    assert all(r.done and len(r.out) == r.max_new for r in done)
    counters = eng.metrics.snapshot()["counters"]
    assert counters == ref_eng.metrics.snapshot()["counters"]
    assert counters["serve.admit.sequential"] == len(mix)
