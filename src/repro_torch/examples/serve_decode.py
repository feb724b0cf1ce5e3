"""Batched serving with continuous slot refill (eager request admission).

  PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]

The reference example serves reduced qwen2.5-3b, a config the port does
not register yet (ROADMAP A.8); this one serves reduced smollm-135m.
"""
import argparse

import numpy as np
import torch

from ..models.registry import get_api, get_config
from ..serve.engine import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-135m").reduced()
    api = get_api(cfg)
    params = api.init_params(torch.Generator(args.device).manual_seed(0),
                             args.device)
    eng = ServeEngine(api, params, batch=4, window=64)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 6)
                    .astype(np.int32), max_new=10) for i in range(10)]
    for r in reqs:
        eng.submit(r)

    steps = 0
    while any(not r.done for r in reqs) and steps < 500:
        if eng.step() == 0 and not eng.queue:
            break
        steps += 1

    assert all(r.done for r in reqs)
    print(f"served {len(reqs)} requests in {steps} decode steps "
          f"(batch=4 slots, continuous refill)")
    for r in reqs[:4]:
        print(f"  req {r.rid}: prompt={list(r.prompt)} -> out={r.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
