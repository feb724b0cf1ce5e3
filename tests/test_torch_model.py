"""The port's dense decoder against the JAX package's on reduced configs
in f32, from the same parameters (initialised by JAX, carried across by
``params_from_jax``): prefill logits and caches, then decode steps that
run past the cache window (where JAX drops the write), within 1e-4. The
variants cover smollm-135m (GQA 3:1 and a sliding window among them),
the QKV bias and an untied head, and the dense configs granite-3-2b,
qwen2.5-3b and qwen2-72b. Every architecture of ``ALL_ARCHS``: its
config equals the reference's, and its parameters have the reference's
tree, shapes and dtypes."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as REF_ALL_ARCHS
from repro.models.registry import get_api as ref_get_api
from repro.models.registry import get_config as ref_get_config
from repro_torch.configs import ALL_ARCHS
from repro_torch.interop import params_from_jax
from repro_torch.models.registry import available, get_api, get_config

TOL = dict(rtol=1e-4, atol=1e-4)

# name: (arch, overrides of its reduced config)
VARIANTS = {
    "smollm-reduced": ("smollm-135m", {}),
    "smollm-reduced-g3": ("smollm-135m", {"n_heads": 6,
                                          "n_kv_heads": 2}),   # GQA 3:1
    # sliding window: windowed prefill mask, ring-buffer decode cache
    "smollm-reduced-swa": ("smollm-135m", {"sliding_window": 5}),
    "smollm-reduced-qkv-bias": ("smollm-135m", {"qkv_bias": True}),
    "smollm-reduced-untied": ("smollm-135m", {"tie_embeddings": False}),
    "granite-3-2b-reduced": ("granite-3-2b", {}),
    "qwen2.5-3b-reduced": ("qwen2.5-3b", {}),      # QKV bias, tied
    "qwen2-72b-reduced": ("qwen2-72b", {}),        # QKV bias, untied
}


def _pair(variant):
    """``variant``: an (arch, overrides) pair of ``VARIANTS``, or the
    overrides of reduced smollm."""
    arch, overrides = variant if isinstance(variant, tuple) \
        else ("smollm-135m", variant)
    ref_cfg = ref_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    assert cfg == type(cfg)(**ref_cfg.__dict__)
    ref_api = ref_get_api(ref_cfg)
    # the reference initialises the QKV biases to zero: draw them, so the
    # bias variants add something
    rng = np.random.default_rng(7)
    ref_params = jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(rng.standard_normal(x.shape),
                                     x.dtype) * 0.5
                         if path[-1].key in ("bq", "bk", "bv") else x),
        ref_api.init_params(jax.random.key(0)))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params),
                             cfg, device="cpu")
    return ref_api, ref_params, get_api(cfg), params


@functools.lru_cache(maxsize=None)
def _variant_pair(name):
    """``_pair`` of ``VARIANTS[name]``, built once a module (no test
    mutates it)."""
    return _pair(VARIANTS[name])


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_config_matches_reference():
    ref = ref_get_config("smollm-135m")
    assert get_config("smollm-135m").__dict__ == ref.__dict__


def test_every_arch_is_registered():
    assert ALL_ARCHS == REF_ALL_ARCHS
    assert set(available()) == set(ALL_ARCHS)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_arch_config_matches_reference(name):
    ref_cfg = ref_get_config(name)
    cfg = get_config(name)
    assert cfg == type(cfg)(**ref_cfg.__dict__)
    assert cfg.reduced() == type(cfg)(**ref_cfg.reduced().__dict__)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_arch_input_specs_match_reference(name):
    """``input_specs`` of every cell shape (frames for enc-dec, patches
    for the VLM) as the reference's, and ``make_inputs`` fills them."""
    from repro.configs import SHAPES
    from repro_torch.configs import ShapeConfig
    api = get_api(get_config(name))
    ref = ref_get_api(ref_get_config(name))
    for shape in SHAPES:
        want = {k: (s.shape, str(s.dtype))
                for k, s in ref.input_specs(shape).items()}
        got = {k: (tuple(t.shape), str(t.dtype).split(".")[1])
               for k, t in api.input_specs(ShapeConfig(
                   shape.name, shape.seq_len, shape.global_batch,
                   shape.kind)).items()}
        assert got == want, shape.name
    small = get_api(get_config(name).reduced())
    cell = ShapeConfig("smoke", 24, 2, "train")
    batch = small.make_inputs(cell, seed=0, device="cpu")
    spec = small.input_specs(cell)
    assert {k: (t.shape, t.dtype) for k, t in batch.items()} == {
        k: (t.shape, t.dtype) for k, t in spec.items()}
    assert int(batch["tokens"].max()) < small.cfg.vocab_size
    loss, _ = small.loss_fn(small.init_params(
        torch.Generator().manual_seed(0), "cpu"), batch)
    assert torch.isfinite(loss)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_arch_params_match_reference_tree(name):
    """The port builds every architecture (reduced, on the CPU) with the
    reference's parameter tree, shapes and dtypes, and ``param_spec``
    describes it exactly."""
    cfg = get_config(name).reduced()
    ref_api = ref_get_api(ref_get_config(name).reduced())
    want = jax.tree_util.tree_flatten_with_path(ref_api.param_spec())[0]
    api = get_api(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), "cpu")
    spec = api.param_spec()
    for tree in (params, spec):
        got = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                got[path] = (tuple(node.shape), str(node.dtype).split(".")[1])
        walk(tree, ())
        assert got == {tuple(k.key for k in path):
                       (leaf.shape, str(leaf.dtype)) for path, leaf in want}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_logits_and_caches_match(variant):
    ref_api, ref_params, api, params = _variant_pair(variant)
    tokens = np.random.default_rng(0).integers(
        0, api.cfg.vocab_size, (3, 13)).astype(np.int32)
    want_logits, want_caches = jax.jit(ref_api.prefill_full_fn)(
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
    ref_api, ref_params, api, params = _variant_pair(variant)
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
    kv = {"k": 1, "v": 1, "pos": 1}
    for name in ("smollm-135m", "mixtral-8x7b", "llava-next-34b"):
        api = get_api(get_config(name).reduced())
        assert api.decode_state_bdims(4, 16) == {"layers": kv}
    api = get_api(get_config("whisper-small").reduced())
    assert api.decode_state_bdims(4, 16) == {"layers": kv, "cross_k": 1,
                                            "cross_v": 1}
    # every family is ported: no arch raises at init
    for name in ALL_ARCHS:
        cfg = get_config(name).reduced()
        ref = ref_get_api(ref_get_config(name).reduced())
        state = get_api(cfg).init_decode_state(2, 8, "cpu")
        want = jax.tree_util.tree_map(lambda s: s.shape,
                                      ref.decode_state_spec(2, 8))
        got = jax.tree_util.tree_map(lambda t: tuple(t.shape), state)
        assert got == want, name


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
