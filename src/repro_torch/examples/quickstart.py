"""Quickstart: create a phaser, synchronize dynamic tasks, then train a
small model end to end with phaser-coordinated steps.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``--device`` defaults to ``cuda``; ``cpu`` runs the kernels' plain
versions.
"""
import argparse

import torch

from ..core.phaser import DistPhaser
from ..data import SyntheticLM
from ..models.registry import get_api, get_config
from ..optim import AdamW
from ..train.loop import TrainLoop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("== distributed phaser: dynamic membership ==")
    ph = DistPhaser(4, seed=0)
    print("phase after everyone signals:", ph.next())          # -> 0
    ph.async_add(0, 10)          # task 0 asyncs task 10 onto the phaser
    print("phase with the new member:", ph.next())             # -> 1
    ph.drop(2)                   # task 2 deregisters
    print("phase after a departure:", ph.next())               # -> 2
    print("message counts:", dict(ph.net.sent))
    print("critical path (hops):", ph.net.max_depth)

    print(f"\n== end-to-end training (reduced smollm config, "
          f"{args.device}) ==")
    cfg = get_config("smollm-135m").reduced()
    api = get_api(cfg)
    opt = AdamW(lr=3e-3, warmup=10, total_steps=60)
    data = SyntheticLM(vocab=cfg.vocab_size, batch=8, seq=128, seed=0)
    loop = TrainLoop(api=api, opt=opt, data=data, log_every=10,
                     device=args.device)
    loop.run(60, params=api.init_params(
        torch.Generator(args.device).manual_seed(0), args.device))
    for m in loop.metrics_log:
        print(f"  step {m['step']:3d}  loss {m['loss']:.4f}")
    first, last = loop.metrics_log[0]["loss"], loop.metrics_log[-1]["loss"]
    assert last < first, "loss did not decrease"
    print(f"loss {first:.3f} -> {last:.3f}: learning works")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
