"""The traffic generators that every mix file parameterises, seeded from
the run's ``--seed``. The program receives only what they generate.

``lm_batch`` is a copy of the port's seeded ``SyntheticLM`` stream
(``data/synthetic.py::make_batch``): order-1 Markov token sequences,
each token with ``branch`` likely successors, deterministic in (seed,
step). The serving mixes' schedule is drawn by their driver
(``drivers/serve_open_loop.py::requests``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def lm_batch(vocab: int, batch: int, seq: int, *, seed: int, step: int,
             branch: int = 8) -> Dict[str, np.ndarray]:
    nxt = np.random.default_rng(seed).integers(0, vocab,
                                               size=(vocab, branch))
    rng = np.random.default_rng((seed * 1_000_003 + step) % (2**63))
    toks = np.empty((batch, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=batch)
    choices = rng.integers(0, branch, size=(batch, seq))
    for t in range(seq):
        toks[:, t + 1] = nxt[toks[:, t], choices[:, t]]
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class BatchPool:
    """The train loop's data: ``n`` distinct batches of the stream made
    in set-up, handed out in turn (the window's host work stays the
    same from step to step)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int, n: int,
                 branch: int = 8):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self.batches = [lm_batch(vocab, batch, seq, seed=seed, step=i,
                                 branch=branch) for i in range(n)]
        self.step = 0

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batches[self.step % len(self.batches)]
        self.step += 1
        return b
