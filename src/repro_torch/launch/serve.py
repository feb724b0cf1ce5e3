"""Serving launcher CLI: batched decode with continuous slot refill.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --reduced --requests 8 --max-new 16

``--arch`` takes any registered architecture (``configs.ALL_ARCHS``).
Dense and MoE prompts are admitted in bulk through one padded prefill,
the recurrent families through a length-masked decode pass, enc-dec and
the VLM backbone token by token from a zero state (no frames or
patches), as the reference's engine does. Runs on the GPU by default;
``--device cpu`` runs the kernels' plain versions (tests).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models.registry import available, get_api, get_config
from ..serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    help=f"one of {', '.join(available())}")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--window", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = get_api(cfg)
    params = api.init_params(torch.Generator(device).manual_seed(0), device)
    eng = ServeEngine(api, params, batch=args.batch, window=args.window)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    steps = 0
    while any(not r.done for r in reqs):
        if eng.step() == 0 and not eng.queue:
            break
        steps += 1
    dt = time.time() - t0
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    print(f"served {done}/{len(reqs)} requests, {toks} tokens in "
          f"{steps} steps, {dt:.2f}s ({toks/max(dt,1e-9):.1f} tok/s)")
    print(f"phase-gated batch membership: {eng.epoch} schedule swaps "
          f"({len(eng.gate.epochs)} epochs) over "
          f"{eng.gate.ph.released() + 1} phases, "
          f"{len(eng.gate.events)} join/leave events")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {list(r.prompt)} -> {r.out}")
    return 0 if done == len(reqs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
