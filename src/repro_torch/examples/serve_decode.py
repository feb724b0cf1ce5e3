"""Batched serving with continuous slot refill (eager request admission).

  PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]

Serves reduced qwen2.5-3b (QKV biases, tied embedding), as the
reference example does: ten 6-token prompts through 4 slots.
"""
import argparse

import numpy as np
import torch

from ..models.registry import get_api, get_config
from ..serve.engine import Request, ServeEngine

ARCH = "qwen2.5-3b"


def serve(api, params, *, batch: int = 4, window: int = 64):
    """The reference example's run on ``params``: returns (requests,
    decode steps)."""
    eng = ServeEngine(api, params, batch=batch, window=window)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, api.cfg.vocab_size, 6)
                    .astype(np.int32), max_new=10) for i in range(10)]
    for r in reqs:
        eng.submit(r)

    steps = 0
    while any(not r.done for r in reqs) and steps < 500:
        if eng.step() == 0 and not eng.queue:
            break
        steps += 1
    return reqs, steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(ARCH).reduced()
    api = get_api(cfg)
    params = api.init_params(torch.Generator(args.device).manual_seed(0),
                             args.device)
    reqs, steps = serve(api, params)
    assert all(r.done for r in reqs)
    print(f"served {len(reqs)} requests in {steps} decode steps "
          f"(batch=4 slots, continuous refill)")
    for r in reqs[:4]:
        print(f"  req {r.rid}: prompt={list(r.prompt)} -> out={r.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
