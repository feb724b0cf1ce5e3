"""Model API and the port's own config registry.

Port of ``repro/models/registry.py``. ``ModelAPI`` hides family
differences behind init / loss / prefill / decode; the pipeline-stage
functions wait for ROADMAP A.9 and the input specs for the dry-run
tooling (A.11). Only configs of the families the port has are
registered: smollm-135m (dense), zamba2-7b (hybrid) and xlstm-125m
(xLSTM: family ssm with sLSTM groups);
``reduced(family="ssm", hybrid_attn_every=0)`` of the hybrid gives the
plain-ssm family.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..utils import tree_flatten, tree_unflatten
from . import transformer


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig

    # ------------------------------------------------------------- init
    def init_params(self, generator: torch.Generator, device="cuda"):
        return transformer.init_params(self.cfg, generator, device)

    def param_spec(self):
        """The parameter tree as ``meta`` tensors (no allocation)."""
        return transformer.param_spec(self.cfg)

    # ------------------------------------------------------------- train
    def loss_fn(self, params, batch: Dict, *, remat: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
        logits, aux, _ = transformer.forward(self.cfg, params,
                                             batch["tokens"], remat=remat)
        loss = _xent(logits, batch["targets"])
        total = loss + 0.01 * aux
        return total, {"loss": loss, "aux": aux}

    def loss_from_logits(self, logits, targets):
        return _xent(logits, targets)

    def value_and_grad(self, params, batch: Dict, *, remat: bool = False):
        """``jax.value_and_grad(loss_fn, has_aux=True)``: returns
        ((total, metrics), grads), grads a tree like ``params`` in the
        parameters' dtypes, everything detached."""
        paths, leaves = tree_flatten(params)
        with torch.enable_grad():
            req = [p.detach().requires_grad_(True) for p in leaves]
            total, metrics = self.loss_fn(tree_unflatten(paths, req), batch,
                                          remat=remat)
            grads = torch.autograd.grad(total, req)
        return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
                tree_unflatten(paths, list(grads)))

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
        (logits, state). An optional ``batch["live"]`` (B,) bool freezes
        the rows where it is False."""
        return transformer.decode_step(self.cfg, params, state,
                                       batch["token"], batch["t"],
                                       batch.get("live"))

    def prefill_state_fn(self, params, tokens: torch.Tensor, lengths, *,
                         window: int):
        """Bulk prefill for RECURRENT decode states (ssm/xlstm/hybrid): one
        length-masked decode pass over a padded (G, S_bucket) prompt
        group. A row's state (its recurrent carries, KV rows and ``pos``)
        freezes once ``t >= lengths[g]``, so the final state equals the
        one token-by-token admission produces, leaf for leaf. Returns
        (next_logits (G, V) f32 at each request's own len-1, decode
        state for a G-slot batch)."""
        G, Sb = tokens.shape
        dev = tokens.device
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        state = self.init_decode_state(G, window, dev)
        nxt = torch.zeros((G, self.cfg.vocab_size), dtype=torch.float32,
                          device=dev)
        for t in range(Sb):
            pos = torch.full((G,), t, dtype=torch.int32, device=dev)
            logits, state = self.decode_fn(
                params, state, {"token": tokens[:, t], "t": pos,
                                "live": pos < lengths})
            nxt = torch.where((pos == lengths - 1)[:, None], logits.float(),
                              nxt)
        return nxt, state

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
    from ..configs import (smollm_135m, xlstm_125m,  # noqa: F401
                           zamba2_7b)                # (register)
