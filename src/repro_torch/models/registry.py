"""Model API and the port's own config registry.

Port of ``repro/models/registry.py``. ``ModelAPI`` hides family
differences behind init / loss / prefill / decode, the pipeline-stage
functions (embed, a slice of the blocks, head) and the input specs of a
benchmark cell. Every architecture of ``configs.ALL_ARCHS`` is
registered (``configs/archs.py``); enc-dec (whisper-small) goes to
``encdec.py``, every other family to ``transformer.py``.
``reduced(family="ssm", hybrid_attn_every=0)`` of the hybrid gives the
plain-ssm family.

The batch keys are the reference's: ``tokens`` (and ``targets``), plus
``frames`` (B, enc_seq, D) for enc-dec and ``patches`` (B, n_vis, D)
for the VLM backbone, whose loss reads the text positions only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..utils import tree_flatten, tree_map, tree_unflatten
from . import encdec, transformer


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if type(logits) is not torch.Tensor:       # the dry-run's DTensors
        gold = _gather_shards(logits, targets.long()[..., None])
        return torch.mean(lse[..., None] - gold)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _gather_shards(x, idx):
    """``torch.gather(x, -1, idx)`` on DTensors, the gathered dim kept.
    Logits whose vocab dim is not sharded are gathered per rank
    (``local_map``: DTensor has no gather rule over two mesh axes of
    one dim, the data-parallel-only layout's); vocab-sharded ones take
    ``_GatherLast``."""
    from ..kernels import meta
    from torch.distributed.tensor import Shard
    if any(isinstance(p, Shard) and p.dim == x.ndim - 1
           for p in x.placements):
        return _GatherLast.apply(x, idx)
    pl = x.placements
    return meta.run(lambda a, i: torch.gather(a, -1, i), (x, idx),
                    (pl, pl), pl)


class _GatherLast(torch.autograd.Function):
    """``torch.gather(x, -1, idx)`` on DTensors, its dim kept (a
    vocab-sharded gather carries a mask of that shape). Its gradient
    starts from ``zeros_like(x)``, laid out as x is: the native formula's
    ``new_zeros`` of x's size makes DTensor build the gradient
    replicated, at the full global size."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(x, idx)
        return torch.gather(x, -1, idx)

    @staticmethod
    def backward(ctx, g):
        x, idx = ctx.saved_tensors
        return torch.zeros_like(x).scatter_add(-1, idx, g), None


@dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig

    @property
    def _stack(self):
        """The module of this family's stack."""
        return encdec if self.cfg.is_encdec else transformer

    # ------------------------------------------------------------- init
    def init_params(self, generator: torch.Generator, device="cuda"):
        return self._stack.init_params(self.cfg, generator, device)

    def param_spec(self):
        """The parameter tree as ``meta`` tensors (no allocation)."""
        return self._stack.param_spec(self.cfg)

    def _forward(self, params, batch: Dict, **kw):
        """(logits, aux, caches) of the family's full forward."""
        cfg = self.cfg
        if cfg.is_encdec:
            return encdec.forward(cfg, params, batch["tokens"],
                                  batch["frames"], **kw)
        return transformer.forward(cfg, params, batch["tokens"],
                                   patches=batch.get("patches"), **kw)

    # ------------------------------------------------------------- train
    def loss_fn(self, params, batch: Dict, *, remat: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
        logits, aux, _ = self._forward(params, batch, remat=remat)
        if self.cfg.family == "vlm":
            logits = logits[:, self.cfg.vision_tokens:]   # text positions
        loss = _xent(logits, batch["targets"])
        total = loss + 0.01 * aux
        return total, {"loss": loss, "aux": aux}

    # ------------------------------------------- pipeline stages (train)
    def pipeline_supported(self) -> bool:
        """Whether the model decomposes into pipeline stages: a single
        stacked-blocks scan (dense/moe/ssm/xlstm/hybrid decoder-only).
        vlm prepends patches (stage 0 would need the vision frontend)
        and enc-dec has two stacks; both keep the single-axis path."""
        return (not self.cfg.is_encdec
                and self.cfg.family in ("dense", "moe", "ssm", "hybrid"))

    def embed_fn(self, params, tokens):
        """Input-side stage: tokens (B, S) -> activations (B, S, D)."""
        return transformer.embed_tokens(self.cfg, params, tokens)

    def stage_fn(self, io_params, blocks, h, *, remat: bool = False):
        """One stage's compute: a slice of the stacked blocks over the
        incoming activation. ``io_params`` carries the non-block
        parameters (the hybrid family's shared attention is applied
        inside each group). Returns (h, aux)."""
        return transformer.forward_stage(
            self.cfg, blocks, h, shared=io_params.get("shared"),
            remat=remat)

    def head_fn(self, params, h):
        """Output-side stage: final norm + (tied) unembedding."""
        return transformer.head_logits(self.cfg, params, h)

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
        token at its own ``len - 1`` instead of the padded tail. Enc-dec's
        caches are the cross K/V ``{"cross_k", "cross_v"}``; the VLM's
        logits cover the patches' positions too."""
        logits, _, caches = self._forward(params, batch, want_cache=True)
        return logits, caches

    def prefill_fn(self, params, batch: Dict):
        logits, caches = self.prefill_full_fn(params, batch)
        return logits[:, -1], caches

    def decode_fn(self, params, state: Dict, batch: Dict):
        """One decode step; updates ``state`` in place and returns
        (logits, state). An optional ``batch["live"]`` (B,) bool freezes
        the rows where it is False."""
        return self._stack.decode_step(self.cfg, params, state,
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
        return self._stack.init_decode_state(self.cfg, batch, window,
                                             device)

    def decode_state_spec(self, batch: int, window: int):
        """The decode state as ``meta`` tensors (no allocation)."""
        return tree_map(lambda s: torch.empty(s[0], dtype=s[1],
                                              device="meta"),
                        self._stack.decode_state_shapes(self.cfg, batch,
                                                        window))

    def decode_state_bdims(self, batch: int, window: int):
        """Per-leaf index of the decode state's BATCH dim, found by
        diffing the state's shapes at two batch sizes."""
        return tree_map(
            lambda a, b: next(i for i, (x, y) in enumerate(zip(a.shape,
                                                               b.shape))
                              if x != y),
            self.decode_state_spec(batch, window),
            self.decode_state_spec(batch + 1, window))

    # ------------------------------------------------------------- specs
    def input_specs(self, shape: ShapeConfig) -> Dict:
        """``meta`` tensors standing in for the step inputs of a cell."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def f(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")
        if shape.kind == "decode":
            return {"token": f(B), "t": f(B)}
        dt = getattr(torch, cfg.dtype)
        specs: Dict = {}
        if cfg.family == "vlm":
            n_vis = cfg.vision_tokens
            specs["patches"] = f(B, n_vis, cfg.d_model, dtype=dt)
            S -= n_vis
        if cfg.is_encdec:
            specs["frames"] = f(B, cfg.encoder_seq, cfg.d_model, dtype=dt)
        specs["tokens"] = f(B, S)
        if shape.kind == "train":
            specs["targets"] = f(B, S)
        return specs

    def make_inputs(self, shape: ShapeConfig, seed: int = 0,
                    device="cuda") -> Dict:
        """Concrete random inputs matching ``input_specs``, from a
        generator seeded with ``seed`` (smoke runs)."""
        gen = torch.Generator(device).manual_seed(seed)
        out = {}
        for name, s in self.input_specs(shape).items():
            if s.dtype == torch.int32:
                hi = (self.cfg.vocab_size
                      if name in ("tokens", "targets", "token")
                      else shape.seq_len)
                out[name] = torch.randint(0, hi, s.shape, generator=gen,
                                          dtype=torch.int32, device=device)
            else:
                out[name] = torch.randn(s.shape, generator=gen,
                                        device=device).to(s.dtype)
        return out


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
    from ..configs import archs  # noqa: F401  (registers all configs)
