"""Elastic fault-tolerant training on the collective execution engine.

The paper's protocol is the coordination layer AND the data-plane
scheduler of this run: every training step is one phaser phase, and
gradient sync executes the *current epoch's schedule* over the team
stacked on one device, each round one ``bucket_combine`` launch
(``collective_exec``). The schedule is ``recursive_doubling``; the
non-power-of-two epochs (6 and 3 workers) keep that kind through the
elimination derivation instead of falling back to ``phaser_scsl``.

Membership churn (grow 4 -> 6 at step 15, shrink 6 -> 3 at step 35: one
failure and two graceful leaves) lands as epoch boundaries: the boundary
swaps to the next epoch's program from the epoch-aware cache (built once
per (member_set, kind)), a checkpoint makes the swap crash-consistent,
and the schedule is verified against the live protocol actors'
converged topology and a fresh skip-list oracle.

Every step also runs an ``xla_psum`` baseline program from the *same*
params: the engine's loss matches the baseline to f32 tolerance at every
step of every epoch, and so do the updated parameters.

With ``--pipeline-stages S`` the train path is the 2-D pipeline program
instead (``pipeline_exec``, DESIGN.md §6): the stacked blocks split over
S stage rows, microbatches flow through the wave-synchronous 1F1B
schedule derived from the point-to-point phaser graph, and each stage
row syncs its gradients over the team through the SAME per-epoch
schedule. ``--interleave v`` runs the interleaved 1F1B order (v
non-contiguous chunks per stage; bubble (S-1)/(vM+S-1) instead of
(S-1)/(M+S-1)). The baseline stays the single-axis program, which the
2-D path must match step for step through the same churn, and every
epoch boundary also proves the 1F1B phase ordering against real SIG/WAIT
phaser actors (``verify_phase_order``).

  PYTHONPATH=src python -m repro_torch.examples.elastic_train \\
      [--pipeline-stages 2] [--interleave 2] [--device cpu]
"""
import argparse
import shutil
import tempfile

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..collective_exec import ProgramCache, build_gradsync_program
from ..core.collective import PhaserCollective
from ..data.synthetic import make_batch
from ..models.registry import get_api, get_config
from ..optim import AdamW, OptState
from ..pipeline_exec import (build_pipeline_program, derive_interleaved,
                             verify_phase_order)
from ..runtime_elastic import ElasticPhaserRuntime
from ..utils import to_device_copy, tree_leaves

STEPS = 60
BATCH, SEQ = 4, 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline-stages", type=int, default=1)
    ap.add_argument("--interleave", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    S, V, dev = args.pipeline_stages, args.interleave, args.device
    pipe = S > 1 or V > 1
    M = 2 if pipe else 1                   # pipeline depth (1F1B M)

    # the scan axis must split into S*v chunks (one layer per chunk is
    # enough for the reduced config)
    cfg = get_config("smollm-135m").reduced(n_layers=max(2, S * V))
    api = get_api(cfg)
    opt = AdamW(lr=3e-3, warmup=10, total_steps=STEPS)

    rt = ElasticPhaserRuntime(4, seed=0, kind="recursive_doubling")
    ckpt_dir = tempfile.mkdtemp(prefix="elastic_ckpt_")
    ckpt = CheckpointManager(ckpt_dir, async_write=False)

    # epoch-aware program caches, built once per (member_set, kind); the
    # engine programs run the pipelined round order over the readiness
    # groups (DESIGN.md §5), bitwise equal to eager by design.
    # block_groups=2 splits the stacked-blocks bucket group into scan-row
    # sub-groups, past the 3 coarse readiness classes.
    if pipe:
        programs = ProgramCache(
            lambda pc: build_pipeline_program(
                api, opt, pc, n_stages=S, interleave=V, device=dev,
                microbatches=M, stacked=True, overlap="pipelined",
                block_groups=2),
            extra_key=("pipeline", S, V, "pipelined", M, 2))
    else:
        programs = ProgramCache(
            lambda pc: build_gradsync_program(
                api, opt, pc, device=dev, stacked=True,
                overlap="pipelined", block_groups=2),
            extra_key=("pipelined", 1, 2))
    baseline = ProgramCache(
        lambda pc: build_gradsync_program(
            api, opt,
            PhaserCollective(pc.n, pc.axis_name, kind="xla_psum",
                             keys=pc.keys, seed=pc.seed),
            device=dev, stacked=True))
    rt.bind_program_cache(programs)

    params = api.init_params(torch.Generator(dev).manual_seed(0), dev)
    opt_state = opt.init(params)

    def worker_batches(team, step):
        """Each worker draws its own deterministic shard (seeded by its
        phaser key); the stacked leading axis is the epoch's team."""
        bs = [make_batch(cfg.vocab_size, BATCH, SEQ, seed=1000 + w,
                         step=step) for w in team]
        return {k: to_device_copy(np.stack([b[k] for b in bs]), dev)
                for k in bs[0]}

    def verify_pipeline_phase_order():
        """The stage axis's own per-boundary proof: the (interleaved)
        1F1B wave schedule through real SIG/WAIT phaser actors."""
        if pipe:
            verify_phase_order(derive_interleaved(S, M, V))

    losses = []
    verify_pipeline_phase_order()
    print(f"epoch 0: live={list(rt.epoch.live)} kind={rt.epoch.kind} "
          f"schedule={rt.epoch.stats()}"
          + (f" pipeline: {S} stages x {V} chunks x {M} microbatches, "
             f"bubble {derive_interleaved(S, M, V).bubble_fraction():.3f}"
             f" (phase order verified)" if pipe else ""))

    for step in range(STEPS):
        if step == 15:                      # grow 4 -> 6: eager inserts
            w1 = rt.request_join(step=step)
            w2 = rt.request_join(step=step)
            print(f"step {step}: workers {w1},{w2} JOINED "
                  f"(live={len(rt.live)}; program swap queued for "
                  "boundary)")
        if step == 35:                      # shrink 6 -> 3
            victim = max(rt.live)
            rt.request_leave(victim, fail=True, step=step)
            leavers = sorted(rt.live)[-2:]
            for w in leavers:
                rt.request_leave(w, step=step)
            print(f"step {step}: worker {victim} FAILED, {leavers} left "
                  f"(live={sorted(rt.live)}; phase completes without "
                  "them)")
            # restart path: restore the latest checkpoint (consistent
            # with the epoch swap saved at the last boundary)
            tpl = {"params": params, "opt": opt_state._asdict()}
            s, tree, _ = ckpt.restore(tpl)
            params = tree["params"]
            opt_state = OptState(**tree["opt"])
            print(f"          restored checkpoint @ step {s}")

        # one step == one phaser phase; workers that left mid-epoch are
        # masked (zeros, and the alive count rescales the mean)
        team = list(rt.epoch.live)
        alive = torch.tensor([1.0 if w in rt.live else 0.0 for w in team],
                             dtype=torch.float32, device=dev)
        batch = worker_batches(team, step)
        prog = programs.get(rt.collective())
        ref = baseline.get(rt.collective())
        # the baseline runs from the SAME params: the engine must match
        p_ref, _, m_ref = ref.step(params, opt_state, batch, alive)
        p_dev, o_dev = prog.bind_state(params, opt_state)
        p_dev, o_dev, m = prog.step(p_dev, o_dev, batch, alive)
        params, opt_state = prog.readout_state(p_dev, o_dev)
        r, rr = prog.reduce_metrics(m), ref.reduce_metrics(m_ref)
        loss, loss_ref = float(r["loss"]), float(rr["loss"])
        np.testing.assert_allclose(loss, loss_ref, rtol=1e-5, atol=1e-6)
        for a, b in zip(tree_leaves(params), tree_leaves(p_ref)):
            np.testing.assert_allclose(a.float().cpu().numpy(),
                                       b.float().cpu().numpy(),
                                       rtol=2e-4, atol=2e-5)
        losses.append(loss)

        before = rt.epoch.index
        released = rt.advance(step=step)
        if rt.epoch.index != before:
            # epoch boundary: checkpoint, swap programs, verify vs oracle
            ckpt.save(step + 1, params, opt_state)
            rt.verify_epoch()
            verify_pipeline_phase_order()
            ep = rt.epoch
            assert programs.get(ep.collective) is not None
            print(f"epoch {ep.index} @ phase {released}: "
                  f"live={list(ep.live)} kind={ep.kind} "
                  f"schedule={ep.stats()} — verified vs oracle; "
                  f"programs={programs.stats()}")
        if step % 10 == 0:
            print(f"step {step:3d} phase {released:3d} loss {loss:.4f} "
                  f"(psum {loss_ref:.4f}) live={int(float(r['alive']))} "
                  f"epoch={rt.epoch.index}")
        if (step + 1) % 20 == 0:
            ckpt.save(step + 1, params, opt_state)

    print("\ncontroller:", {k: v for k, v in rt.stats().items()
                            if k != "messages"})
    print("program cache:", programs.stats())
    assert len(rt.epochs) >= 3, "expected grow + shrink epochs"
    for ep in rt.epochs:
        if ep.collective is not None:
            assert ep.collective.matches_oracle(), ep.index
            assert ep.kind == "recursive_doubling", \
                f"epoch {ep.index} fell back to {ep.kind}"
    # one program per distinct (member_set, kind), reused otherwise
    assert programs.stats()["misses"] == len(rt.epochs)
    assert losses[-1] < losses[0], "loss did not decrease through churn"
    mode = (f"on the 2-D ({S}-stage"
            + (f" x{V}-interleaved" if V > 1 else "")
            + " 1F1B x data) grid" if pipe else "synced on-device")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} across grow 4->6 / "
          f"shrink 6->3, {mode} by the OVERLAPPED {rt.kind} schedule "
          f"({programs.get(rt.collective()).meta['bucket_groups']} bucket "
          f"groups): OK")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
