"""PyTorch/CUDA port of the distributed-phaser system.

The JAX package ``repro`` is the reference; this package keeps its
module names so each counterpart is easy to find. It imports ``torch``
and never ``jax`` or ``repro``: the pure-Python modules it needs
(protocol actors, skip list, schedules, metrics) are copied here.

Entry points default to ``device="cuda"``. Every kernel wrapper takes its
plain PyTorch version only for a CPU tensor; for a CUDA tensor it
launches the hand-written Hopper kernel or raises.
"""
