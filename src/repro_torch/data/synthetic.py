"""Deterministic synthetic LM data pipeline.

A real text pipeline is replaced (offline container) by a *learnable*
synthetic stream: order-k Markov token sequences from a seeded generator,
so the ~100M-param example run shows a genuinely decreasing loss (the model
can learn the transition structure; iid-uniform tokens would pin loss at
log V). Deterministic per (seed, step): restarting from a checkpoint
reproduces the exact stream — the pipeline state is just the step counter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


def _transition(vocab: int, seed: int, branch: int = 8) -> np.ndarray:
    """Sparse-ish Markov transition: each token has ``branch`` likely
    successors."""
    rng = np.random.default_rng(seed)
    nxt = rng.integers(0, vocab, size=(vocab, branch))
    return nxt


def make_batch(vocab: int, batch: int, seq: int, *, seed: int, step: int,
               extra: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """One (tokens, targets) batch; deterministic in (seed, step)."""
    nxt = _transition(vocab, seed)
    rng = np.random.default_rng((seed * 1_000_003 + step) % (2**63))
    toks = np.empty((batch, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=batch)
    choices = rng.integers(0, nxt.shape[1], size=(batch, seq))
    for t in range(seq):
        toks[:, t + 1] = nxt[toks[:, t], choices[:, t]]
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if extra:
        for name, spec in extra.items():
            r = np.random.default_rng((seed * 7 + step) % (2**63))
            out[name] = r.normal(size=spec.shape).astype(np.float32)
    return out


@dataclass
class SyntheticLM:
    """Checkpointable iterator over synthetic batches."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0
    step: int = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = make_batch(self.vocab, self.batch, self.seq, seed=self.seed,
                       step=self.step)
        self.step += 1
        return b

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> Dict:
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, st: Dict) -> None:
        self.seed = int(st["seed"])
        self.step = int(st["step"])
