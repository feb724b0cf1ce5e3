"""Model API (serving half) and the port's own config registry.

Port of ``repro/models/registry.py``. ``ModelAPI`` hides family
differences behind init / prefill / decode; the loss, pipeline-stage and
input-spec halves arrive with the training slice. Only the families the
port has (dense) are registered.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from . import transformer


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig

    # ------------------------------------------------------------- init
    def init_params(self, generator: torch.Generator, device="cuda"):
        return transformer.init_params(self.cfg, generator, device)

    # ------------------------------------------------------------- serve
    def prefill_full_fn(self, params, batch: Dict):
        """Prefill returning logits at EVERY position (plus caches).
        Length-bucketed admission pads prompts up to a shared bucket
        length; causality keeps positions below the true prompt length
        unaffected, so the serving engine reads each request's next
        token at its own ``len - 1`` instead of the padded tail."""
        logits, _, caches = transformer.forward(
            self.cfg, params, batch["tokens"], want_cache=True)
        return logits, caches

    def prefill_fn(self, params, batch: Dict):
        logits, caches = self.prefill_full_fn(params, batch)
        return logits[:, -1], caches

    def decode_fn(self, params, state: Dict, batch: Dict):
        """One decode step; updates ``state`` in place and returns
        (logits, state)."""
        return transformer.decode_step(self.cfg, params, state,
                                       batch["token"], batch["t"])

    def init_decode_state(self, batch: int, window: int, device="cuda"):
        return transformer.init_decode_state(self.cfg, batch, window,
                                             device)

    def decode_state_bdims(self, batch: int, window: int):
        """Per-leaf index of the decode state's BATCH dim, found by
        diffing the state's shapes at two batch sizes."""
        s1 = transformer.decode_state_shapes(self.cfg, batch, window)
        s2 = transformer.decode_state_shapes(self.cfg, batch + 1, window)

        def diff(a, b):
            if isinstance(a, dict):
                return {k: diff(a[k], b[k]) for k in a}
            return next(i for i, (x, y) in enumerate(zip(a[0], b[0]))
                        if x != y)
        return diff(s1, s2)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def available() -> Tuple[str, ...]:
    _load_all()
    return tuple(sorted(_REGISTRY))


def get_config(name: str) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; ported: {available()}")
    return _REGISTRY[name]()


def get_api(name_or_cfg) -> ModelAPI:
    if isinstance(name_or_cfg, ModelConfig):
        return ModelAPI(name_or_cfg)
    return ModelAPI(get_config(name_or_cfg))


def _load_all():
    from ..configs import smollm_135m  # noqa: F401  (registers the config)
