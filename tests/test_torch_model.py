"""The port's dense decoder against the JAX package's on reduced smollm
in f32, from the same parameters (initialised by JAX, carried across by
``params_from_jax``): prefill logits and caches, then decode steps that
run past the cache window (where JAX drops the write), within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import get_api as ref_get_api
from repro.models.registry import get_config as ref_get_config
from repro_torch.interop import params_from_jax
from repro_torch.models.registry import get_api, get_config

TOL = dict(rtol=1e-4, atol=1e-4)

VARIANTS = {
    "smollm-reduced": {},
    "smollm-reduced-g3": {"n_heads": 6, "n_kv_heads": 2},   # GQA 3:1
    # sliding window: windowed prefill mask, ring-buffer decode cache
    "smollm-reduced-swa": {"sliding_window": 5},
}


def _pair(overrides):
    ref_cfg = ref_get_config("smollm-135m").reduced(**overrides)
    cfg = get_config("smollm-135m").reduced(**overrides)
    assert cfg == type(cfg)(**ref_cfg.__dict__)
    ref_api = ref_get_api(ref_cfg)
    ref_params = ref_api.init_params(jax.random.key(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             cfg, device="cpu")
    return ref_api, ref_params, get_api(cfg), params


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_config_matches_reference():
    ref = ref_get_config("smollm-135m")
    assert get_config("smollm-135m").__dict__ == ref.__dict__


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_logits_and_caches_match(variant):
    ref_api, ref_params, api, params = _pair(VARIANTS[variant])
    tokens = np.random.default_rng(0).integers(
        0, api.cfg.vocab_size, (3, 13)).astype(np.int32)
    want_logits, want_caches = ref_api.prefill_full_fn(
        ref_params, {"tokens": jnp.asarray(tokens)})
    logits, caches = api.prefill_full_fn(
        params, {"tokens": torch.tensor(tokens, dtype=torch.long)})
    assert logits.dtype == torch.float32 and logits.shape == (3, 13, 128)
    _close(logits, want_logits)
    for leaf in ("k", "v"):
        _close(caches["layers"][leaf], want_caches["layers"][leaf])
    last, _ = api.prefill_fn(params, {"tokens": torch.tensor(tokens)})
    _close(last, want_logits[:, -1])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_steps_match_past_the_window(variant):
    ref_api, ref_params, api, params = _pair(VARIANTS[variant])
    B, W = 2, 7
    rng = np.random.default_rng(1)
    ref_state = ref_api.init_decode_state(B, W)
    state = api.init_decode_state(B, W, device="cpu")
    decode = jax.jit(ref_api.decode_fn)
    for step in range(8):
        tok = rng.integers(0, api.cfg.vocab_size, (B,)).astype(np.int32)
        # row 1 runs two positions ahead: it passes W first
        t = np.array([step, step + 2], np.int32)
        want, ref_state = decode(ref_params, ref_state,
                                 {"token": jnp.asarray(tok),
                                  "t": jnp.asarray(t)})
        got, state = api.decode_fn(params, state,
                                   {"token": torch.tensor(tok),
                                    "t": torch.tensor(t)})
        _close(got, want)
    # past the window: a full cache drops the write, a ring buffer wraps
    assert int(t.max()) >= W
    for leaf in ("k", "v", "pos"):
        _close(state["layers"][leaf], ref_state["layers"][leaf])


def test_decode_state_bdims_and_families():
    api = get_api(get_config("smollm-135m").reduced())
    assert api.decode_state_bdims(4, 16) == {
        "layers": {"k": 1, "v": 1, "pos": 1}}
    cfg = get_config("smollm-135m").reduced(family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_api(cfg).init_params(torch.Generator().manual_seed(0), "cpu")


def test_init_params_match_reference_shapes_and_scale():
    ref_api, ref_params, api, _ = _pair({})
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    for path, leaf in flat_ref:
        node = params
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        # same distribution family: equal spread within sampling error
        np.testing.assert_allclose(float(node.float().std()),
                                   float(jnp.std(leaf)), rtol=0.1, atol=1e-6)
