"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py
    python3 chip_smoke.py --planted

Phases, in order, except that the kernel parity and timing phases 2, 5,
8, 13 and 21 run first and the families' phases 20 and 22-25 after
phase 3 (after the training phases' profiles, torch.profiler loses most
short sessions' records); any failure exits non-zero and no result is
printed. ``--planted`` runs phase 1 and then only the check of phase 21
against faults planted in the bf16 kernels' sources (``planted``):

1. build: compile every CUDA source of ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once), timed;
2. parity: each kernel against its plain PyTorch version on the card,
   at the serving path's shapes (smollm-135m: H=9, Kh=3, hd=64), in
   bf16 (tolerance 2e-2) and f32 (1e-4); the attention forward's saved
   per-row LSE against the plain one at the timing shape (1e-3); then
   timing of each kernel (the attention rows with their achieved
   TFLOP/s), its plain version and one PyTorch library call as a
   yardstick. bf16 attention runs on the tensor-core kernels, f32 on
   the CUDA-core ones (``ATTN_FWD_BF16`` and ``ATTN_BWD_BF16`` name the
   CUDA functions a bf16 call launches, ``DECODE`` flash_decode's one);
   the host time to enqueue one attention forward, backward and decode
   at one token, bf16 (which builds TMA descriptors) against f32;
3. reference: a reduced smollm in f32 served through the kernels on the
   card and through the plain versions on the CPU, from the same
   parameters: prefill and decode logits agree within 1e-3;
4. serve: smollm-135m at full width (30 layers, d_model 576, vocab
   49152, bf16, random weights from a seeded generator) through
   ``ServeEngine``: batch 8, window 1024, 24 prompts of 1..900 tokens
   plus one of 1088 (the token-by-token path, past the window), 32 new
   tokens each. Every request must finish with in-vocabulary tokens,
   and both kernels' launch counters, zeroed just before, must be > 0;
5. train parity: the flash-attention backward kernel against autograd of
   the plain version at B=3, H=9, Kh=3, hd=64, S in {1, 7, 100, 1024},
   causal, sliding window on and off, in bf16 (2e-2) and f32 (1e-4),
   each relative to max(1, max|ref|); ``bucket_combine`` against its
   plain version over add/copy with mixed gates at n=6, bitwise, on
   group views and on the whole team-6 buffer (6 x 2055 x 65536 f32, the
   main path's shape); then timing of both at the train cell's shapes
   beside their plain versions and a library yardstick (SDPA's autograd
   backward; ``torch.addcmul``);
6. train reference: reduced smollm in f32, one ``GradSyncProgram`` step
   per schedule kind at n=6 with one departed worker, on the card and on
   the CPU from the same parameters: loss and updated parameters agree
   within 1e-4 and the reduced ``grad_norm`` within 1e-4 relative, and
   the pipelined round order is bitwise eager on the card;
7. train: smollm-135m at full width (bf16, random weights from a seeded
   generator). First the first step's gradient (team 4, the same
   parameters and batch) through the kernels against autograd of the
   plain attention on the card: every gradient leaf within 5e-2
   relative L2, the loss within 2e-2 relative. Then ``TrainLoop``:
   global batch 12 x 1024 tokens, 30 steps, lr 1e-3 (warmup 6),
   ``phaser_scsl`` sync, elastic churn
   ``join@8,join@8,fail@18,leave@18,leave@18`` (4 -> 6 -> 3 workers).
   Every loss finite; the last below the first by at least 0.05 and by
   five times the spread of the first parameters' loss over five
   batches; the first step's loss and ``grad_norm`` within 2e-2 of the
   plain attention's; 3 epochs, each proved by ``verify_epoch``; 3
   program-cache misses; the launch counters of the three training
   kernels, zeroed just before, all > 0; each epoch's program's last
   reduced row equal to the sum of the stack it synced. A profiled
   extra step splits device time among forward+backward, sync and the
   optimizer (full table in ``chiprun_out/train_profile.txt``).
8. hybrid parity: ``mamba2_scan`` against its plain version at
   zamba2-7b's full-width prefill (B=2, NH=112, S=2048, P=N=64), at a
   ragged S=1000 and at one chunk (S=64), bf16 and f32 x, y in f32 as
   the model asks, within 1e-3 (relative and absolute; bf16 x runs the
   tensor-core kernel, whose hi/lo operands read about 1.2e-4, and the
   limit fails the variants that drop lo products; f32 x the reference
   kernel test's 1e-3); flash_attention and flash_decode at the
   shared block's hd 112 (32 heads) within 2e-2 / 1e-4, the forward's
   LSE at its timing shape within 1e-3; then each timed (no PyTorch call
   computes the scan: its library time is null; bf16 inputs run the
   tensor-core kernel ``SCAN_BF16``, f32 the CUDA-core ``ssd_kernel``);
9. hybrid reference: reduced zamba2 in f32, kernels on the card against
   plain versions on the CPU: prefill and admission-pass logits within
   1e-4, the same requests served with identical token streams, epochs
   and ``serve.*`` counters;
10. hybrid cross-check: zamba2-7b at full width, depth 3, f32: the
   chunked scan's logits (``prefill_full_fn`` at each prompt's len-1)
   against the recurrence's (``prefill_state_fn``) within 1e-3
   relative L2, lengths [512, 301];
11. hybrid prefill: zamba2-7b at full width and depth (81 Mamba2
   layers, 27 shared-block applications, bf16, random weights from a
   seeded generator): ``prefill_fn`` on 2 x 2048 tokens three times,
   with 81 ``mamba2_scan`` and 27 ``flash_attention`` launches a forward
   exactly; then the cross-check at full depth in bf16 against
   ``CROSS_BF16_BOUND`` (PERF.md gives its reason), lengths [256, 141];
12. hybrid serve: the same model through ``ServeEngine`` (batch 4,
   window 256): 8 prompts of 4..200 tokens (recurrent bulk admission)
   plus one of 300 (the sequential path), 16 new tokens each; every
   request drained with in-vocabulary tokens, 8 recurrent and 1
   sequential admissions, ``flash_decode`` launched; a profiled decode
   step and prefill, each port kernel group's share of device busy (the
   scan's in the prefill; full tables in ``hybrid_profile.txt`` beside
   the other logs).
13. xlstm parity: ``mlstm_chunkwise`` against its plain version at
   xlstm-125m's full-width prefill (B=8, NH=4, S=2048, hd=384), at a
   ragged S=1000, one short chunk (S=40), S=1 and at hd 64, q/k/v in
   bf16 and f32, y in f32 (2e-4 of max(1, max|ref|)) and bf16
   (element-wise, 2e-2 of |ref| plus 1e-2); then timed (no PyTorch call
   computes the mLSTM: its library time is null; bf16 inputs at hd 384
   run the tensor-core kernel ``MLSTM_BF16``, f32 the CUDA-core
   ``mlstm_kernel``), with ptxas' registers and spills of the bf16 one
   from the build;
14. xlstm reference: reduced xlstm-125m in f32, the kernel on the card
   against the plain version on the CPU: prefill and admission-pass
   logits within 1e-4, the same requests served with identical token
   streams, epochs and ``serve.*`` counters;
15. xlstm cross-check: xlstm-125m at full width and depth in f32, the
   chunked form's logits (``prefill_full_fn`` at each prompt's len-1)
   against the recurrence's (``prefill_state_fn``) within 1e-3 relative
   L2, lengths [300, 170];
16. xlstm prefill: xlstm-125m at full width and depth (9 mLSTM and 3
   sLSTM layers, bf16, random weights from a seeded generator):
   ``prefill_fn`` on 8 x 2048 tokens three times with exactly 9
   ``mlstm_chunkwise`` launches a forward and no other kernel; one block
   of each kind timed alone; then the cross-check in bf16 against
   ``CROSS_BF16_BOUND``, lengths [300, 170];
17. xlstm serve: the same model through ``ServeEngine`` (batch 8, window
   256): 12 prompts of 4..200 tokens (recurrent bulk admission) plus one
   of 300 (the sequential path), 16 new tokens each; every request
   drained with in-vocabulary tokens, 12 recurrent and 1 sequential
   admissions, no kernel launched (admission and decode are plain
   decode passes); a profiled decode step and prefill (8 x 512; tables
   in ``xlstm_profile.txt``);
18. pipeline reference: reduced smollm in f32, one 2-D (stage x data)
   pipeline step on the card and one on the CPU from the same
   parameters, batch and alive mask (team 3, one departed worker), for
   (S=2, M=2, v=1, eager) and (S=2, M=2, v=2, pipelined, block_groups 2,
   4 layers): loss and updated parameters within 1e-4, and on the card
   within the reference's tolerances of the single-axis ``xla_psum``
   program (loss rtol 1e-5, params rtol 2e-4 / atol 2e-5);
19. pipeline train: smollm-135m at full width and depth (bf16, random
   weights from a seeded generator) through ``TrainLoop`` on the 2-D
   program: 3 stages x interleave 2 (6 chunks of 5 layers), 3
   microbatches, overlapped sync, global batch 18 x 1024, ``phaser_scsl``
   sync, churn ``join@4,leave:0@8`` (2 -> 3 -> 2 workers, three member
   sets), 12 steps. The first step's loss and ``grad_norm`` within 2e-2
   of the single-axis program's from the same parameters and batch;
   every loss finite and the last below the first; 3 epochs, each proved
   by ``verify_epoch`` and ``verify_phase_order``; 3 program-cache
   misses; the launch counters of the attention forward, its backward
   and ``bucket_combine``, zeroed just before, all > 0, and
   ``bucket_combine``'s equal to what the schedule predicts (rounds x
   bucket groups a step: the stage rows fold into one launch);
   ``bucket_combine`` bitwise against its plain version at the path's
   largest operand (team 3, the stage rows of the largest group); median
   step seconds per epoch; a profiled extra step split among
   ``pipeline.fwd``, ``pipeline.bwd``, ``gradsync.sync`` and
   ``gradsync.update`` (full table in ``pipeline_profile.txt``).
20. families reference: reduced mixtral-8x7b, llama4-scout (top 1 of 16
   experts), whisper-small and llava-next-34b in f32, the kernels on the
   card against the plain versions on the CPU from the same parameters:
   prefill logits and 24 decode steps past the window (whisper's over
   the prefill's cross K/V) within 1e-4, the MoE aux loss within 1e-5,
   both attention kernels' counters, zeroed just before, > 0;
21. families parity: both attention kernels at the families' shapes,
   bf16 (2e-2 absolute and ``FAM_ROW_TOL`` of every output row) and f32
   (1e-4) against their plain versions: the forward
   at hd 128 over S 4608 with mixtral's window of 4096, at g = 7
   (llava), whisper's non-causal cross-attention (Sq 448, Sk 1500) and
   encoder (S 1500); the decode over mixtral's 4096-slot ring (holes,
   g = 4) and over whisper's 1500 cross keys (all valid, g = 1); each
   timed beside its plain version, SDPA and its bound;
22. mixtral serve: mixtral-8x7b at full width, 8 of 32 layers, bf16,
   through ``ServeEngine`` (4 slots, a 4096-slot ring): 8 prompts of
   512..4000 tokens with 64 new tokens and one of 4000 with 160, all
   through bulk KV admission; every request drained with in-vocabulary
   tokens, 9 bulk admissions, both kernels launched, the ring wrapped;
   admission and decode rates; a profiled decode step and admission
   prefill split between the attention and MoE layers (``fam.*``
   ranges; tables in ``families_profile.txt``; a profile counts only if
   it recorded every attention kernel the wrappers launched);
23. whisper: whisper-small whole, bf16, 4 requests of 1500 frames:
   ``prefill_full_fn``, the cross K/V copied into the decode state, the
   prompt decoded through it (the last token's logits against the
   prefill's, relative L2 within ``FAM_BF16_BOUND``), 64 greedy tokens;
   encode timed alone; a profiled decode step;
24. llava: llava-next-34b at full width, 16 of 60 layers, bf16, 2
   requests of 576 patches + 512 tokens: prefill, the KV spliced into
   the decode state, the last prompt token decoded through it against
   the prefill's logits, 32 greedy steps from position 1088; a profiled
   decode step;
25. config sweep: llama4-scout (2 of 48 layers), qwen2-72b (4 of 80),
   granite-3-2b and qwen2.5-3b (whole), full width, bf16: one prefill
   of 1024 tokens and 8 decode steps each (the dense ones' last prompt
   token through the cache against the prefill's logits), finite
   logits, both kernels launched; each model freed before the next;
26. multihost reference: reduced smollm (2 layers, f32), 3 host
   processes x 2 ranks in-process (``InprocCluster``), 4 steps with one
   join: every step's per-host loss and the final loss probes on the
   card within 1e-4 of the same run on the CPU;
27. multihost in-process: smollm-135m at full width and depth (bf16),
   3 hosts x 2 ranks stacked on the card, 2 x 1024 tokens a rank,
   ``phaser_scsl`` at both levels, 12 steps, ``join@4,fail:1@8`` (3 -> 4
   -> 3 hosts): the first step's parameters within 1e-4 (relative L2) of
   the flat ``build_gradsync_program`` over the same 6 ranks and
   batches; the loss probes bitwise equal on every live host after every
   step; ``bucket_combine`` launches equal to live hosts x local rounds
   summed over the steps; each host's program-cache misses equal to the
   process sets it was live in; the central level-1 exchange timed; a
   profiled step (``multihost_profile.txt``);
28. multihost socket: the same model and layout over real worker
   processes (``SocketCluster``, AF_UNIX, each its own CUDA context on
   the card), 8 steps, ``kill@5``: the SIGKILLed host detected by
   heartbeats and evicted non-cooperatively, training going on with 2;
   the survivors' loss probes bitwise equal after every step; the last
   step's peer-to-peer level-1 exchange bitwise equal (SHA-256) to the
   central executor on the same host buffers; detection and recovery
   seconds (a 20 s silence floor), the frame size, each worker's peak
   card memory and launches;
29. dry-run against the card: ``launch.dryrun`` traces smollm-135m x
   train_4k with ``dp_over_model`` on the 16x16 mesh (a fake group of
   256 ranks, meta shards: rank 0 holds every parameter and one 4096-token
   sequence) and predicts rank 0's peak bytes and FLOPs; that rank's
   program then runs on the card at full width (``build_train_step``,
   B = 1, S = 4096, remat, the team of 1 a single card stacks), its
   FLOPs counted by the same counters on the real tensors, its peak
   ``torch.cuda.max_memory_allocated()`` over the step above the bytes
   held before it, its median step time against
   ``analytic_terms(..., chips=256, tp=1)``'s per-GPU bound. The
   measured peak over the predicted must lie in ``DRYRUN_PEAK_BAND``
   (PERF.md gives its reason) and the attention kernels' counters,
   zeroed just before the step, be > 0. Then int8 compression with
   error feedback on the multi-host flat buffer's shape (2055 x 65536
   f32) on the card against the CPU (scale 1e-7 relative, q equal off
   the .5 rounding ties, residual 1e-6), timed; and ``python -m
   repro_torch.obs.regress`` over the committed ``BENCH_*.json`` must
   exit 0.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(the counterparts of all five TPU kernels and the attention backward,
plus the attention kernels' rows at hd 112 and at the families' shapes;
``launches`` sums the serve, train, hybrid prefill, hybrid serve, xlstm
prefill, xlstm serve, pipeline, multihost (the in-process run and the
socket survivors' own counts), mixtral serve, whisper, llava, config
sweep and dry-run check runs, split in ``launches_by_path``), prefill, decode and
training rates, the whole run's time, and as the last line
``{"ok": true, "device": {...}}``. f32
matmuls run without TF32 (``allow_tf32`` off) wherever f32 results are
compared.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
# keep CUPTI alive between profiler sessions: with kineto's default
# teardown, time_ms's sessions lose kernel records now and then (3 of 40
# in tools/profiler_loss.py, none of 40 with this set); read when torch
# loads the profiler, so set before torch is imported
os.environ.setdefault("TEARDOWN_CUPTI", "0")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and bf16 / f32 flop/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# the attention kernels' CUDA functions in bf16 (the tensor-core kernels;
# f32 keeps attn_kernel, bwd_dkdv and bwd_dq on the CUDA cores)
ATTN_FWD_BF16 = ("fa_fwd_wgmma",)
ATTN_BWD_BF16 = ("bwd_dot", "fa_dkdv_wgmma", "fa_dq_wgmma")
# flash_decode's one CUDA function (both dtypes); the SSD scan's with bf16
# inputs (the tensor-core kernel; f32 inputs keep ssd_kernel)
DECODE = ("flash_decode_kernel",)
SCAN_BF16 = ("ssd_tc_kernel",)
# the mLSTM's with bf16 inputs at hd 384 (the tensor-core kernel; f32
# inputs and hd 32 / 64 keep mlstm_kernel)
MLSTM_BF16 = ("mlstm_tc_kernel",)
LSE_TOL = 1e-3                   # the forward's saved LSE, bf16


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


RANGE_PREFIX = "gradsync."       # the train step's profiler ranges
# every step's ranges: the single-axis step's, the pipeline step's waves
RANGES = (RANGE_PREFIX, "pipeline.")


def cuda_kernels(prof):
    """(name, milliseconds) of every CUDA kernel a profiler recorded (the
    device-side marks of ``record_function`` ranges are not kernels)."""
    from torch.autograd import DeviceType
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
            for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(RANGES)]


PROFILE_TRIES = 3


def time_ms(fn, calls: int = 1, iters: int = 10, kernels: tuple = ()):
    """Per call of the timed function (``fn`` makes ``calls`` calls):
    (device ms, host ms). Device ms sums the CUDA kernels the profiler
    records; host ms is CUDA-event time over back-to-back runs, which
    for a short kernel is the host's launch rate, not the kernel.
    ``kernels`` names the port's CUDA functions that each call launches
    once: a profile counts only if it holds exactly ``iters * calls``
    launches of each (and, for any ``fn``, some kernel). The profiler
    loses records now and then (``tools/profiler_loss.py``), so a
    profile that fails the count is reported and taken again, and the
    run fails after ``PROFILE_TRIES`` such profiles."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    host = start.elapsed_time(end) / (iters * calls)
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        recorded = cuda_kernels(prof)
        seen = {m: sum(m in name for name, _ in recorded) for m in kernels}
        if recorded and all(n == iters * calls for n in seen.values()):
            return sum(ms for _, ms in recorded) / (iters * calls), host
        print(f"time_ms: profile {attempt} of {PROFILE_TRIES} recorded "
              f"{len(recorded)} CUDA kernels, launches of the port's "
              f"kernels {seen}, want {iters * calls} each (CUDA events "
              f"read {host:.4f} ms a call)")
    fail(f"time_ms: {PROFILE_TRIES} profiles missed launches")


def _to(tree, dev):
    """A tree of tensors moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# --------------------------------------------------------------- phases
def phase_build() -> float:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    dt = time.perf_counter() - t0
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "ptxas.txt"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    print(f"build: {len(build.sources())} kernels in {dt:.2f} s")
    return dt


def ptxas_regs(source: str, func: str) -> str:
    """'N registers, S bytes spilled' of the CUDA function matching
    ``func`` in csrc/<source>.cu, from the build's ptxas report
    (``chiprun_out/ptxas.txt``), or "not measured" when this process
    found the library built."""
    import re
    try:
        with open(os.path.join(HERE, "chiprun_out", "ptxas.txt")) as f:
            log = f.read().split(f"== {source}\n", 1)[1].split("\n== ", 1)[0]
    except (OSError, IndexError):
        return "not measured"
    m = re.search(func + r".*?\n.*?(\d+) bytes spill stores.*?\n"
                  r".*?Used (\d+) registers", log)
    return (f"{m.group(2)} registers, {m.group(1)} bytes spilled" if m
            else "not measured")


def _attn_inputs(B, S, dtype, gen, H=9, Kh=3, hd=64):
    import torch
    # the model's layout: (B, S, heads, hd) projections, passed transposed
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Kh, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Kh, hd), generator=gen, device="cuda").to(dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _decode_inputs(B, W, dtype, gen, L=1, H=9, Kh=3, hd=64):
    import torch
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dtype)
    # the model's cache layout (L, B, W, Kh, hd), read as permuted views
    k = torch.randn((L, B, W, Kh, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((L, B, W, Kh, hd), generator=gen, device="cuda").to(dtype)
    lengths = torch.randint(1, W + 1, (B,), generator=gen, device="cuda")
    valid = (torch.arange(W, device="cuda")[None] < lengths[:, None])
    valid = valid.to(torch.int32)
    valid[0] = 0                        # a fully masked row: mean of v
    return q, k, v, valid


def print_timing(r: dict) -> None:
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    rate = (f", {r['tflops']:.1f} TFLOP/s" if "tflops" in r else "")
    print(f"timing {r['name']} ({r['shape']}), device ms per call: "
          f"kernel {r['ms']:.4f} (host-timed {r['host_ms']:.4f}{rate}), "
          f"plain {r['plain_ms']:.4f}, library {lib}, bound "
          f"{r['bound_ms']:.4f} ({r['bound_by']})")


def _attn_row(q, k, v, causal, win, err, shape):
    """The timing row of one bf16 flash_attention call at (q, k, v)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    B, H, Sq, hd = q.shape
    Kh, Sk = k.shape[1], k.shape[2]
    flops = FA.attention_flops(B, H, Sq, Sk, hd, causal, win)
    nbytes = 2 * (2 * B * H * Sq * hd + 2 * B * Kh * Sk * hd)
    ms, host = time_ms(lambda: FA.flash_attention(
        q, k, v, causal=causal, sliding_window=win), kernels=ATTN_FWD_BF16)
    plain, _ = time_ms(lambda: FA.attention_ref(
        q, k, v, causal=causal, sliding_window=win), iters=3)
    # SDPA takes a window that cuts as a boolean mask
    mask = None
    if win and win < Sq:
        pos = torch.arange(Sq, device="cuda")
        mask = ((pos[None] <= pos[:, None])
                & (pos[:, None] - pos[None] < win))
    lib, _ = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=H != Kh))
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "shape": shape, "max_abs_err": err, "ms": ms, "host_ms": host,
        "plain_ms": plain, "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib, "tflops": flops / ms / 1e9}


def _decode_row(q, views, valid, err, shape):
    """The timing row of bf16 flash_decode over the caches ``views``
    (one a layer, each cold in L2 when it is read)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as FD
    B, H, hd = q.shape
    Kh = views[0][0].shape[1]
    L = len(views)
    n_valid = int(valid.sum())
    flops = FD.decode_flops(H, hd, n_valid)
    nbytes = 2 * (2 * n_valid * Kh * hd + 2 * B * H * hd) + 4 * valid.numel()

    def cycle(fn):
        return lambda: [fn(kk, vv) for kk, vv in views]
    ms, host = time_ms(cycle(lambda kk, vv: FD.flash_decode(q, kk, vv,
                                                           valid)),
                       calls=L, kernels=DECODE)
    plain, _ = time_ms(cycle(lambda kk, vv: FD.decode_ref(q, kk, vv, valid)),
                       calls=L, iters=3)
    q4, mask = q[:, :, None, :], (valid[:, None, None, :] > 0)
    lib, _ = time_ms(cycle(lambda kk, vv: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=mask, enable_gqa=H != Kh)), calls=L)
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:63",
        "shape": f"{shape}, {n_valid}/{valid.numel()} slots valid",
        "max_abs_err": err, "ms": ms, "host_ms": host, "plain_ms": plain,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib}


def check_lse(q, k, v, window, what: str) -> None:
    """The forward's saved per-row LSE (natural log) against the plain
    one, bf16, causal, at a timing shape."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    _, lse = FA._forward(q, k, v, True, window, want_lse=True)
    want = FA.attention_lse_ref(q, k, causal=True, sliding_window=window)
    torch.cuda.synchronize()
    e = (lse - want).abs().max().item()
    print(f"parity flash_attention LSE bf16 {what} {tuple(q.shape)}: "
          f"max_abs_err={e:.3e}")
    if not e <= LSE_TOL:
        fail(f"flash_attention LSE {what} err {e} > {LSE_TOL}")
    del lse, want


def enqueue_ms() -> None:
    """Host milliseconds to enqueue one attention forward, one backward
    and one decode at one token (B=1, S=W=1: the device work is
    negligible), bf16 against f32: the bf16 attention kernels' extra host
    cost is building their TMA descriptors and checking the layout TMA
    needs; the decode's is its checks and one output allocation."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros((1, 9, 1, 64), dtype=dtype, device="cuda")
        kv = torch.zeros((1, 3, 1, 64), dtype=dtype, device="cuda")
        valid = torch.ones((1, 1), dtype=torch.int32, device="cuda")
        out, lse = FA._forward(q, kv, kv, True, None, want_lse=True)
        for what, fn in (
                ("forward", lambda: FA.flash_attention(q, kv, kv)),
                ("backward", lambda: FA.flash_attention_bwd(
                    q, kv, kv, out, q, lse)),
                ("decode", lambda: FD.flash_decode(q[:, :, 0], kv, kv,
                                                   valid))):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            got[f"{what} {str(dtype).split('.')[1]}"] = (
                (time.perf_counter() - t0) / 200 * 1e3)
            torch.cuda.synchronize()
    print("host enqueue ms per attention call at B=1, S=W=1: "
          + ", ".join(f"{k} {v:.4f}" for k, v in got.items()))


def phase_parity():
    """Each kernel against its plain version at the main path's shapes;
    returns the kernels' timing rows."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD

    gen = torch.Generator("cuda").manual_seed(0)
    err = {"flash_attention": 0.0, "flash_decode": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        # the serving path's buckets, plus one sliding-window case
        for B, S, win in ((8, 1, None), (8, 8, None), (4, 100, None),
                          (2, 1024, None), (2, 1024, 200)):
            q, k, v = _attn_inputs(B, S, dtype, gen)
            got = FA.flash_attention(q, k, v, causal=True,
                                     sliding_window=win)
            want = FA.attention_ref(q, k, v, causal=True,
                                    sliding_window=win)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            print(f"parity flash_attention {name} B={B} S={S} window={win}:"
                  f" max_abs_err={e:.3e}")
            if not e <= TOL[name]:
                fail(f"flash_attention {name} B={B} S={S} window={win} "
                     f"err {e}")
            if dtype == torch.bfloat16:
                err["flash_attention"] = max(err["flash_attention"], e)
        for B, W in ((8, 100), (8, 1024)):
            q, k, v, valid = _decode_inputs(B, W, dtype, gen)
            kv = (k[0].permute(0, 2, 1, 3), v[0].permute(0, 2, 1, 3))
            got = FD.flash_decode(q, *kv, valid)
            want = FD.decode_ref(q, *kv, valid)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            print(f"parity flash_decode {name} B={B} W={W}: "
                  f"max_abs_err={e:.3e}")
            if not e <= TOL[name]:
                fail(f"flash_decode {name} B={B} W={W} err {e}")
            if dtype == torch.bfloat16:
                err["flash_decode"] = max(err["flash_decode"], e)

    # timing at the serving path's largest shapes, bf16
    rows = []
    B, S, H, Kh, hd = 8, 1024, 9, 3, 64
    q, k, v = _attn_inputs(B, S, torch.bfloat16, gen)
    check_lse(q, k, v, None, "hd 64")
    rows.append(_attn_row(q, k, v, True, None, err["flash_attention"],
                          f"B={B} H={H} Kh={Kh} S={S} hd={hd} bf16 causal"))

    # decode: cycle the 30 layers of a full-size cache, as a decode step
    # does, so each launch finds its K/V cold in L2 (30 x 12.6 MB)
    B, W, L = 8, 1024, 30
    q, k, v, valid = _decode_inputs(B, W, torch.bfloat16, gen, L=L)
    valid[0] = 1
    views = [(k[l].permute(0, 2, 1, 3), v[l].permute(0, 2, 1, 3))
             for l in range(L)]
    rows.append(_decode_row(q, views, valid, err["flash_decode"],
                            f"B={B} H={H} Kh={Kh} W={W} hd={hd} bf16"))
    for r in rows:
        print_timing(r)
    enqueue_ms()
    return rows


def phase_reference() -> None:
    """Kernels on the card vs plain versions on the CPU, reduced f32."""
    import numpy as np
    import torch
    from repro_torch.models.registry import get_api, get_config

    cfg = get_config("smollm-135m").reduced()
    api = get_api(cfg)
    params = api.init_params(torch.Generator("cpu").manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int64)
    worst = 0.0
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        logits, caches = api.prefill_full_fn(
            p, {"tokens": torch.tensor(tokens, device=dev)})
        state = api.init_decode_state(2, 32, dev)
        steps = []
        for t in range(36):             # runs past the window of 32
            tok = torch.tensor(tokens[:, t % 24], device=dev)
            lg, state = api.decode_fn(
                p, state, {"token": tok,
                           "t": torch.full((2,), t, dtype=torch.int32,
                                           device=dev)})
            steps.append(lg)
        outs[dev] = [logits, caches["layers"]["k"], *steps]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        if not torch.isfinite(b).all():
            fail("reference: non-finite logits on the card")
        worst = max(worst, (a - b.cpu()).abs().max().item())
    print(f"reference: reduced smollm f32, card vs CPU plain: "
          f"max_abs_err={worst:.3e}")
    if not worst <= 1e-3:
        fail(f"reference: card and CPU disagree by {worst}")


def phase_serve() -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config("smollm-135m")
    api = get_api(cfg)
    params = api.init_params(torch.Generator("cuda").manual_seed(0), "cuda")
    eng = ServeEngine(api, params, batch=8, window=1024)
    rng = np.random.default_rng(0)
    lengths = list(rng.integers(1, 901, 24)) + [1088]
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new=32)
            for i, n in enumerate(lengths)]
    for r in reqs:
        eng.submit(r)
    # host wall time of each admission path (both end in a device sync)
    spent = {"bulk": 0.0, "sequential": 0.0}

    def timed(fn, key):
        def run(*args):
            t = time.perf_counter()
            fn(*args)
            spent[key] += time.perf_counter() - t
        return run

    eng._admit_bulk = timed(eng._admit_bulk, "bulk")
    eng._admit_sequential = timed(eng._admit_sequential, "sequential")
    torch.cuda.synchronize()
    FA.flash_attention.launches = 0
    FD.flash_decode.launches = 0
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": FA.flash_attention.launches,
                "flash_decode": FD.flash_decode.launches}
    if not all(r.done and len(r.out) == r.max_new for r in reqs):
        fail("serve: not every request finished")
    if not all(0 <= tok < cfg.vocab_size for r in reqs for tok in r.out):
        fail("serve: a token outside the vocabulary")
    if not all(n > 0 for n in launches.values()):
        fail(f"serve: a kernel was never launched: {launches}")
    snap = eng.metrics.snapshot()
    dec = snap["hists"]["serve.decode.token_seconds"]
    decode_s = dec["total"]
    decoded = sum(len(r.out) - 1 for r in reqs)
    seq_toks = sum(len(r.prompt) for r in reqs if len(r.prompt) > 1024)
    bulk_toks = sum(len(r.prompt) for r in reqs) - seq_toks
    counters = snap["counters"]
    print(f"serve: smollm-135m full width bf16, batch 8, window 1024: "
          f"{len(reqs)} requests ({bulk_toks + seq_toks} prompt tokens, "
          f"{sum(len(r.out) for r in reqs)} generated) in {wall:.3f} s: "
          f"bulk admission {spent['bulk']:.3f} s, sequential admission "
          f"{spent['sequential']:.3f} s, {dec['count']} decode steps "
          f"{decode_s:.3f} s")
    print(f"serve: decode {decoded / decode_s:.1f} tok/s "
          f"({1e3 * decode_s / dec['count']:.3f} ms/step, batch 8 incl. "
          f"inactive slots); bulk prefill {bulk_toks / spent['bulk']:.1f} "
          f"tok/s; sequential prefill {seq_toks / spent['sequential']:.1f} "
          f"tok/s; admit counters "
          f"{ {k: v for k, v in counters.items() if 'admit' in k} }; "
          f"epochs {eng.epoch}; launches {launches}")
    phase_profile(api, params, eng)
    return launches


def phase_profile(api, params, eng) -> None:
    """Where a decode step and a bulk prefill spend their time: device
    kernel time by name over a few steps (torch.profiler), against the
    host wall clock. The full tables go to chiprun_out/profile.txt."""
    import numpy as np
    import torch

    B = eng.batch
    tok = torch.zeros((B,), dtype=torch.int32, device="cuda")
    t = torch.full((B,), 900, dtype=torch.int32, device="cuda")
    prompt = torch.tensor(np.random.default_rng(1).integers(
        0, api.cfg.vocab_size, (B, 1024)), device="cuda")
    profile_work({
        "decode step": (5, lambda: api.decode_fn(
            params, eng.state, {"token": tok, "t": t})),
        "prefill 8x1024": (2, lambda: api.prefill_full_fn(
            params, {"tokens": prompt})),
    }, "profile.txt")


# the port's own kernels, by the names of their CUDA functions
PORT_KERNELS = {"attention": ("attn_kernel", "fa_fwd_wgmma", "bwd_dot",
                              "bwd_dkdv", "bwd_dq", "fa_dkdv_wgmma",
                              "fa_dq_wgmma") + DECODE,
                "ssd scan": ("ssd_kernel",) + SCAN_BF16,
                "mlstm": ("mlstm_kernel",) + MLSTM_BF16}


def profile_work(work: dict, fname: str) -> None:
    """Each ``name: (n, fn)`` of ``work`` run n times under torch.profiler
    after one warm run: host wall per run against device busy, the port's
    kernels' share, the top kernels. Full tables to ``fname`` in the
    output directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    report = []
    for name, (n, fn) in work.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n
        by_name = {}
        launches = 0
        for kname, ms in cuda_kernels(prof):
            by_name[kname] = by_name.get(kname, 0.0) + ms / n
            launches += 1
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        share = {group: sum(v for k, v in by_name.items()
                            if any(m in k for m in marks))
                 for group, marks in PORT_KERNELS.items()}
        ours = "; ".join(f"{group} kernels {ms:.3f} ms ("
                         f"{100 * ms / max(busy, 1e-9):.1f}% of busy)"
                         for group, ms in share.items())
        print(f"profile {name}: host wall {1e3 * wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / (1e3 * wall):.1f}%), "
              f"{launches / n:.0f} kernel launches, {ours}, "
              f"{len(by_name)} kernel names; top: "
              + "; ".join(f"{k[:40]} {v:.3f}" for k, v in top[:4]))
        report.append(f"== {name}: wall {1e3 * wall:.4f} ms/iter, busy "
                      f"{busy:.4f} ms/iter, {launches / n:.0f} launches/iter\n"
                      + "\n".join(f"{v:10.4f} ms  {k}" for k, v in top))
    with open(os.path.join(HERE, "chiprun_out", fname), "w") as f:
        f.write("\n\n".join(report) + "\n")


# ------------------------------------------------------- training phases
TRAIN_CHURN = "join@8,join@8,fail@18,leave@18,leave@18"   # 4 -> 6 -> 3


def phase_train_parity():
    """The training kernels against their plain versions, then timed at
    the train cell's shapes; returns their timing rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.collective_exec import make_layout
    from repro_torch.kernels import bucket_combine as BC
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.registry import get_api, get_config

    gen = torch.Generator("cuda").manual_seed(1)
    err = {"flash_attention_bwd": 0.0}
    H, Kh, hd = 9, 3, 64
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for S in (1, 7, 100, 1024):
            for win in (None, 5 if S < 1024 else 200):
                q, k, v = _attn_inputs(3, S, dtype, gen)
                do = torch.randn((3, S, H, hd), generator=gen,
                                 device="cuda").to(dtype).transpose(1, 2)
                leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
                out = FA.flash_attention(*leaves, causal=True,
                                         sliding_window=win)
                got = torch.autograd.grad(out, leaves, do)
                want = FA.attention_bwd_ref(q, k, v, do, causal=True,
                                            sliding_window=win)
                torch.cuda.synchronize()
                worst = 0.0
                for g, w in zip(got, want):
                    e = (g.float() - w.float()).abs().max().item()
                    lim = TOL[name] * max(1.0, w.float().abs().max().item())
                    if not e <= lim:
                        fail(f"flash_attention_bwd {name} S={S} window={win}"
                             f" err {e} > {lim}")
                    worst = max(worst, e)
                print(f"parity flash_attention_bwd {name} B=3 S={S} "
                      f"window={win}: max_abs_err={worst:.3e}")
                if dtype == torch.bfloat16:
                    err["flash_attention_bwd"] = max(
                        err["flash_attention_bwd"], worst)
    gate = torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.int32, device="cuda")
    whole = torch.randn((6, 24, 65536), generator=gen, device="cuda")
    y = torch.randn((6, 8, 65536), generator=gen, device="cuda")
    for op in ("add", "copy"):
        for acc in (whole[:, :8], whole[:, 10:18]):     # whole, group view
            got = BC.bucket_combine(acc, y, gate, op=op)
            want = BC.combine_ref(acc, y, gate, op=op)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"bucket_combine {op}: not bitwise equal to its plain "
                     f"version (max err {(got - want).abs().max().item()})")
        print(f"parity bucket_combine {op} n=6 gates {gate.tolist()}: "
              "bitwise equal")
    del whole, y

    rows = []
    # backward at the team-3 epoch's shard (4 x 1024 tokens), bf16
    B, S = 4, 1024
    q, k, v = _attn_inputs(B, S, torch.bfloat16, gen)
    do = torch.randn((B, S, H, hd), generator=gen,
                     device="cuda").to(torch.bfloat16).transpose(1, 2)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = FA.flash_attention(*leaves, causal=True)
    ms, host = time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                   retain_graph=True),
                       kernels=ATTN_BWD_BF16)
    plain, _ = time_ms(lambda: FA.attention_bwd_ref(q, k, v, do), iters=3)
    sq = [x.detach().requires_grad_(True) for x in (q, k, v)]
    so = F.scaled_dot_product_attention(*sq, is_causal=True, enable_gqa=True)
    lib, _ = time_ms(lambda: torch.autograd.grad(so, sq, do,
                                                 retain_graph=True))
    flops = FA.attention_bwd_flops(B, H, S, S, hd, True, None)
    nbytes = (2 * (3 * B * S * H * hd + 2 * B * S * Kh * hd) + 4 * B * H * S
              + 2 * (B * S * H * hd + 2 * B * S * Kh * hd))
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73 (backward; "
                    "the reference differentiates "
                    "src/repro/models/attention.py:85)",
        "shape": f"B={B} H={H} Kh={Kh} S={S} hd={hd} bf16 causal",
        "max_abs_err": err["flash_attention_bwd"], "ms": ms,
        "host_ms": host, "plain_ms": plain,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib, "tflops": flops / ms / 1e9})
    del q, k, v, do, leaves, out, sq, so

    # the team-6 epoch's whole stacked buffer, the main path's shape:
    # bitwise against the plain version for both ops, then one add round
    # timed
    lay = make_layout(get_api(get_config("smollm-135m")).param_spec())
    n = 6
    acc = torch.randn((n, lay.n_buckets, lay.bucket_elems), generator=gen,
                      device="cuda")
    y = torch.randn(acc.shape, generator=gen, device="cuda")
    gf = gate.float().reshape(n, 1, 1)
    err["bucket_combine"] = 0.0
    for op in ("add", "copy"):
        got = BC.bucket_combine(acc, y, gate, op=op)
        want = BC.combine_ref(acc, y, gate, op=op)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        if not torch.equal(got, want):
            fail(f"bucket_combine {op} at {tuple(acc.shape)}: not bitwise "
                 f"equal to its plain version (max err {e})")
        err["bucket_combine"] = max(err["bucket_combine"], e)
        del got, want
    print(f"parity bucket_combine add, copy at {tuple(acc.shape)} gates "
          f"{gate.tolist()}: bitwise equal")
    ms, host = time_ms(lambda: BC.bucket_combine(acc, y, gate, op="add"),
                       kernels=("combine_",))
    plain, _ = time_ms(lambda: BC.combine_ref(acc, y, gate, op="add"),
                       iters=3)
    lib, _ = time_ms(lambda: torch.addcmul(acc, gf, y))
    t_bytes = 3 * 4 * acc.numel() / PEAK_BYTES
    t_ops = acc.numel() / PEAK_FLOPS["float32"]
    rows.append({
        "name": "bucket_combine", "route": "cuda",
        "source": "src/repro_torch/csrc/bucket_combine.cu",
        "replaces": "src/repro/kernels/bucket_combine.py:49",
        "shape": f"n={n} x ({lay.n_buckets}, {lay.bucket_elems}) f32, add, "
                 f"gates {gate.tolist()}",
        "max_abs_err": err["bucket_combine"], "ms": ms, "host_ms": host,
        "plain_ms": plain, "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib})
    del acc, y
    torch.cuda.empty_cache()
    for r in rows:
        print_timing(r)
    return rows


def phase_train_reference() -> None:
    """One gradient-sync step per kind: kernels on the card against the
    plain versions on the CPU, reduced smollm in f32."""
    import torch
    from repro_torch.collective_exec import build_gradsync_program
    from repro_torch.core.collective import ALLREDUCE_KINDS, PhaserCollective
    from repro_torch.data import make_batch
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.optim import AdamW
    from repro_torch.utils import tree_flatten, tree_map

    cfg = get_config("smollm-135m").reduced()
    api = get_api(cfg)
    opt = AdamW(lr=1e-3, warmup=2, total_steps=10)
    params = api.init_params(torch.Generator("cpu").manual_seed(0), "cpu")
    batch = make_batch(cfg.vocab_size, 12, 16, seed=0, step=0)
    worst = worst_norm = 0.0
    for kind in ALLREDUCE_KINDS:
        res = {}
        for dev, ov in (("cpu", "eager"), ("cuda", "eager"),
                        ("cuda", "pipelined")):
            prog = build_gradsync_program(
                api, opt, PhaserCollective(6, "data", kind=kind, seed=0),
                device=dev, overlap=ov)
            p = tree_map(lambda t: t.to(dev), params)
            alive = torch.tensor([1, 1, 0, 1, 1, 1], dtype=torch.float32,
                                 device=dev)
            newp, _, pm = prog.step(p, opt.init(p), {
                k: torch.tensor(v, device=dev) for k, v in batch.items()},
                alive)
            m = prog.reduce_metrics(pm)
            res[(dev, ov)] = (tree_flatten(newp)[1], m["loss"].item(),
                              m["grad_norm"].item())
        card, cpu = res[("cuda", "eager")], res[("cpu", "eager")]
        e = max(abs(card[1] - cpu[1]),
                *((a.cpu() - b).abs().max().item()
                  for a, b in zip(card[0], cpu[0])))
        e_norm = abs(card[2] - cpu[2]) / cpu[2]
        if not all(torch.isfinite(a).all() for a in card[0]):
            fail(f"train reference {kind}: non-finite params on the card")
        if not e <= 1e-4:
            fail(f"train reference {kind}: card and CPU disagree by {e}")
        if not e_norm <= 1e-4:
            fail(f"train reference {kind}: grad_norm {card[2]} on the card, "
                 f"{cpu[2]} on the CPU")
        if not all(torch.equal(a, b) for a, b in
                   zip(card[0], res[("cuda", "pipelined")][0])):
            fail(f"train reference {kind}: pipelined != eager on the card")
        worst = max(worst, e)
        worst_norm = max(worst_norm, e_norm)
    print(f"train reference: reduced smollm f32, n=6, one departed worker, "
          f"every kind, card vs CPU plain: loss and params "
          f"max_abs_err={worst:.3e}, grad_norm rel err {worst_norm:.3e}; "
          f"pipelined bitwise eager on the card")


TRAIN_LR, TRAIN_WARMUP = 1e-3, 6
# the least fall of the loss over the 30 steps that counts as learning:
# many times the spread of one step's loss from batch to batch
LOSS_DROP = 0.05


def full_width_grads(api, params, batch, n: int, plain: bool):
    """The first step's gradient at full width, as the step computes it
    (every rank's shard, summed in f32, the mean over the team), through
    the attention kernels or, with ``plain``, through autograd of the
    plain attention on the card. Returns (mean loss, f32 grad leaves)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as ATT
    from repro_torch.utils import tree_flatten

    calls = [0]

    def attention_ref(q, k, v, *, causal=True, sliding_window=None):
        calls[0] += 1
        return FA.attention_ref(q, k, v, causal=causal,
                                sliding_window=sliding_window)
    before = (FA.flash_attention.launches, FA.flash_attention_bwd.launches)
    if plain:
        ATT.flash_attention = attention_ref
    try:
        loss, total = 0.0, None
        for r in range(n):
            shard = {k: v.reshape(n, -1, *v.shape[1:])[r]
                     for k, v in batch.items()}
            (_, m), g = api.value_and_grad(params, shard)
            g = [t.float() for t in tree_flatten(g)[1]]
            total = g if total is None else [a + b for a, b in zip(total, g)]
            loss += m["loss"].item() / n
    finally:
        ATT.flash_attention = FA.flash_attention
    after = (FA.flash_attention.launches, FA.flash_attention_bwd.launches)
    layers = api.cfg.n_layers
    if plain and (calls[0] != n * layers or after != before):
        fail(f"train: the plain gradient took {calls[0]} plain attention "
             f"calls and {after} kernel launches (from {before})")
    if not plain and not (after[0] > before[0] and after[1] > before[1]):
        fail("train: the kernels' gradient launched no attention kernel")
    return loss, [t / n for t in total]


def phase_train() -> dict:
    import statistics
    import torch
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.kernels import bucket_combine as BC
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.train import parse_elastic
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.optim import AdamW, global_norm
    from repro_torch.runtime_elastic import ElasticPhaserRuntime
    from repro_torch.train import TrainLoop

    cfg = get_config("smollm-135m")
    api = get_api(cfg)
    B, S, steps, n0 = 12, 1024, 30, 4
    params = api.init_params(torch.Generator("cuda").manual_seed(0), "cuda")
    # the first step's gradient at full width: the kernels against the
    # plain attention, same parameters and batch as the loop's first step
    first = {k: torch.tensor(v, device="cuda") for k, v in
             make_batch(cfg.vocab_size, B, S, seed=0, step=0).items()}
    k_loss, k_grads = full_width_grads(api, params, first, n0, plain=False)
    p_loss, p_grads = full_width_grads(api, params, first, n0, plain=True)
    leaf_err = max(((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                   for a, b in zip(k_grads, p_grads))
    p_norm = global_norm(dict(enumerate(p_grads))).item()
    del k_grads, p_grads
    # the spread of the first parameters' loss over the loop's first five
    # batches: the noise a fall of the loss has to clear
    with torch.no_grad():
        spread = statistics.pstdev(
            api.loss_fn(params, {k: torch.tensor(v, device="cuda")
                                 for k, v in make_batch(
                                     cfg.vocab_size, B, S, seed=0,
                                     step=i).items()})[1]["loss"].item()
            for i in range(5))
    del first
    torch.cuda.empty_cache()

    runtime = ElasticPhaserRuntime(n0, seed=0, kind="phaser_scsl")
    loop = TrainLoop(api=api, opt=AdamW(lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                        total_steps=steps),
                     data=SyntheticLM(vocab=cfg.vocab_size, batch=B, seq=S,
                                      seed=0),
                     log_every=1, runtime=runtime,
                     elastic_events=parse_elastic(TRAIN_CHURN),
                     device="cuda")
    torch.cuda.synchronize()
    FA.flash_attention.launches = 0
    FA.flash_attention_bwd.launches = 0
    BC.bucket_combine.launches = 0
    t0 = time.perf_counter()
    params, opt_state = loop.run(steps, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": FA.flash_attention.launches,
                "flash_attention_bwd": FA.flash_attention_bwd.launches,
                "bucket_combine": BC.bucket_combine.launches}
    # each epoch's program keeps its last step's stacked buffer and rank
    # 0's reduced row: the row must be the stack's sum
    checked = {}
    for ts in loop._progs.programs():
        stacked, row0 = ts.program.last_sync()
        want = stacked.sum(0)
        checked[ts.program.n] = ((row0 - want).abs().max().item(),
                           want.abs().max().item())
    losses = [m["loss"] for m in loop.metrics_log]
    g0 = loop.metrics_log[0]["grad_norm"]
    norm_err = abs(g0 - p_norm) / p_norm
    teams = [len(e["live"]) for e in loop.epoch_log]
    print(f"train: smollm-135m full width bf16, {B}x{S} tokens/step, "
          f"{steps} steps in {wall:.3f} s, lr {TRAIN_LR} (warmup "
          f"{TRAIN_WARMUP}), loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(every 5th step: {[round(x, 4) for x in losses[::5]]}); epochs "
          f"{[n0] + teams}; program cache {loop._progs.stats()}; launches "
          f"{launches}; reduced buffer vs stack sum (max err, max |sum|) "
          f"{checked}")
    print(f"train: first step at full width, kernels vs plain attention on "
          f"the card: loss {k_loss:.6f} vs {p_loss:.6f}, grad leaves' "
          f"largest relative L2 error {leaf_err:.3e}; the loop's grad_norm "
          f"{g0:.6f} vs plain {p_norm:.6f} (rel err {norm_err:.3e}); the "
          f"first parameters' loss over 5 batches: std {spread:.5f}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"train: losses not all finite: {losses}")
    drop = max(LOSS_DROP, 5 * spread)
    if not losses[-1] < losses[0] - drop:
        fail(f"train: loss fell by less than {drop}: {losses[0]} -> "
             f"{losses[-1]}")
    if not abs(losses[0] - p_loss) <= TOL["bfloat16"] * p_loss:
        fail(f"train: first loss {losses[0]}, plain attention {p_loss}")
    if not leaf_err <= 5e-2:
        fail(f"train: a gradient leaf through the kernels is {leaf_err} "
             "(relative L2) from the plain attention's")
    if not norm_err <= TOL["bfloat16"]:
        fail(f"train: first grad_norm {g0}, plain attention {p_norm}")
    if runtime.epoch.index != 2 or teams != [6, 3]:
        fail(f"train: epochs {runtime.epoch.index + 1}, boundaries {teams}")
    runtime.verify_epoch()
    if loop._progs.stats()["misses"] != 3:
        fail(f"train: program cache {loop._progs.stats()}")
    if not all(n > 0 for n in launches.values()):
        fail(f"train: a kernel was never launched: {launches}")
    if sorted(checked) != [3, 4, 6] or not all(
            e <= 1e-5 * max(1.0, m) for e, m in checked.values()):
        fail(f"train: reduced buffer vs the stack's sum: {checked}")
    by_team = {}
    for m in loop.metrics_log:
        by_team.setdefault(int(m["team"]), []).append(m["dt"])
    rates = {n: statistics.median(dts) for n, dts in by_team.items()}
    for n, med in rates.items():
        print(f"train: team {n}: {len(by_team[n])} steps, median step "
              f"{med:.4f} s, {B * S / med:.1f} tokens/s")
    phase_train_profile(loop, params, opt_state)
    return launches


def phase_train_profile(loop, params, opt_state) -> None:
    """One more step of the last epoch's program under torch.profiler:
    device busy against host wall, split into the step's three ranges."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ts = loop._build_step()
    n = ts.program.n
    alive = torch.ones((n,), device="cuda")
    batch = {k: torch.tensor(v, device="cuda")
             for k, v in next(loop.data).items()}
    ts.fn(params, opt_state, batch, alive)          # warm: one unprofiled
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts.fn(params, opt_state, batch, alive)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = cuda_kernels(prof)
    busy = sum(ms for _, ms in kernels)
    marks = {e.name: e for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and e.name.startswith(RANGE_PREFIX)}
    spans = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith(RANGE_PREFIX):
            spans[e.name] = {"host_ms": (e.time_range.end
                                         - e.time_range.start) / 1e3}
    for name, mark in marks.items():
        lo, hi = mark.time_range.start, mark.time_range.end
        spans.setdefault(name, {})["device_ms"] = sum(
            (e.time_range.end - e.time_range.start) / 1e3
            for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(RANGE_PREFIX)
            and lo <= e.time_range.start and e.time_range.end <= hi)
    by_name = {}
    for k, ms in kernels:
        by_name[k] = by_name.get(k, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    attn = sum(v for k, v in by_name.items()
               if any(m in k for m in PORT_KERNELS["attention"]))
    parts = "; ".join(f"{k[len(RANGE_PREFIX):]} host "
                      f"{v.get('host_ms', float('nan')):.3f} ms device "
                      f"{v.get('device_ms', float('nan')):.3f} ms"
                      for k, v in sorted(spans.items()))
    print(f"profile train step (team {n}, {tuple(batch['tokens'].shape)} "
          f"tokens): host wall "
          f"{1e3 * wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / (1e3 * wall):.1f}%); attention kernels "
          f"{attn:.3f} ms; {parts}; top: "
          + "; ".join(f"{k[:40]} {v:.3f}" for k, v in top[:4]))
    with open(os.path.join(HERE, "chiprun_out", "train_profile.txt"),
              "w") as f:
        f.write(f"== train step, team {n}: wall {1e3 * wall:.4f} ms, busy "
                f"{busy:.4f} ms\n{json.dumps(spans, indent=1)}\n"
                + "\n".join(f"{v:10.4f} ms  {k}" for k, v in top) + "\n")
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=60) + "\n")


# --------------------------------------------------------- hybrid phases
HYBRID = "zamba2-7b"
# relative and absolute, y in f32. bf16 x: the tensor-core kernel's
# limit, set from its readings (about 1.2e-4 of 1 + |y|), so that a
# fault in a lo product shows: without the lo products of h and the
# scaled x it reads 2.9e-2, inside the reference kernel test's bf16 3e-2,
# and without any 5.1e-2 (tools/decode_scan_variants.py). f32 x: the
# reference kernel test's 1e-3.
SCAN_TOL = {"bfloat16": 1e-3, "float32": 1e-3}
# the two admission algorithms at full depth in bf16 (PERF.md says why)
CROSS_BF16_BOUND = 0.2
CROSS_F32_BOUND = 1e-3


def _scan_inputs(gen, B, NH, S, dtype, P=64, N=64):
    """The model's layout at zamba2's widths: x a (B, NH, S, P) view of
    (B, S, NH, P); B and C slices of one (B, S, 2N) tensor; a and dt
    (B, NH, S) views of (B, S, NH) f32."""
    import torch
    import torch.nn.functional as F
    x = torch.randn((B, S, NH, P), generator=gen, device="cuda").to(dtype)
    bc = (torch.randn((B, S, 2 * N), generator=gen, device="cuda")
          * 0.5).to(dtype)
    dt = F.softplus(torch.randn((B, S, NH), generator=gen, device="cuda"))
    a = torch.exp(-F.softplus(torch.randn((B, S, NH), generator=gen,
                                          device="cuda")))
    return (x.transpose(1, 2), bc[..., :N], bc[..., N:], a.transpose(1, 2),
            dt.transpose(1, 2))


# zamba2-7b's shared attention block: 32 heads over 32 KV heads, hd 112
SHARED = dict(H=32, Kh=32, hd=112)


def phase_hybrid_parity():
    """The hybrid path's kernels against their plain versions at its
    shapes: mamba2_scan at zamba2-7b's full-width prefill (B=2, NH=112,
    S=2048, P=N=64), at a ragged S and at one chunk; flash_attention and
    flash_decode at the shared block's hd 112. Then each timed; returns
    the timing rows."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import mamba2_scan as MS

    gen = torch.Generator("cuda").manual_seed(2)
    err = {"mamba2_scan": 0.0, "fa112": 0.0, "fd112": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        tol = SCAN_TOL[name]
        for B, NH, S in ((2, 112, 2048), (2, 112, 1000), (1, 112, 64)):
            ins = _scan_inputs(gen, B, NH, S, dtype)
            got = MS.mamba2_scan(*ins, out_dtype=torch.float32)
            want = MS.mamba2_scan_plain(*ins, out_dtype=torch.float32)
            torch.cuda.synchronize()
            d = (got - want).abs()
            e = d.max().item()
            ok = bool((d <= tol * (1 + want.abs())).all())
            print(f"parity mamba2_scan {name} x, f32 y, B={B} NH={NH} S={S}"
                  f" P=N=64: max_abs_err={e:.3e} (max |y| "
                  f"{want.abs().max().item():.3e})")
            if not ok or not torch.isfinite(got).all():
                fail(f"mamba2_scan {name} B={B} S={S} err {e}")
            if dtype == torch.bfloat16:
                err["mamba2_scan"] = max(err["mamba2_scan"], e)
            del ins, got, want, d
        for B, S in ((2, 2048), (4, 200)):
            q, k, v = _attn_inputs(B, S, dtype, gen, **SHARED)
            got = FA.flash_attention(q, k, v, causal=True, sliding_window=4096)
            want = FA.attention_ref(q, k, v, causal=True, sliding_window=4096)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            print(f"parity flash_attention hd=112 {name} B={B} S={S} H=Kh=32"
                  f": max_abs_err={e:.3e}")
            if not e <= TOL[name]:
                fail(f"flash_attention hd=112 {name} B={B} S={S} err {e}")
            if dtype == torch.bfloat16:
                err["fa112"] = max(err["fa112"], e)
            del q, k, v, got, want
        for B, W in ((4, 256), (4, 4096)):
            q, k, v, valid = _decode_inputs(B, W, dtype, gen, **SHARED)
            kv = (k[0].permute(0, 2, 1, 3), v[0].permute(0, 2, 1, 3))
            got = FD.flash_decode(q, *kv, valid)
            want = FD.decode_ref(q, *kv, valid)
            torch.cuda.synchronize()
            e = (got.float() - want.float()).abs().max().item()
            print(f"parity flash_decode hd=112 {name} B={B} W={W} H=Kh=32: "
                  f"max_abs_err={e:.3e}")
            if not e <= TOL[name]:
                fail(f"flash_decode hd=112 {name} B={B} W={W} err {e}")
            if dtype == torch.bfloat16:
                err["fd112"] = max(err["fd112"], e)
    torch.cuda.empty_cache()

    rows = []
    # the scan at the full-width prefill, as the model calls it
    B, NH, S, P, N, c = 2, 112, 2048, 64, 64, 256
    ins = _scan_inputs(gen, B, NH, S, torch.bfloat16)
    ms, host = time_ms(lambda: MS.mamba2_scan(*ins, out_dtype=torch.float32),
                       kernels=SCAN_BF16)
    plain, _ = time_ms(lambda: MS.mamba2_scan_plain(
        *ins, out_dtype=torch.float32), iters=3)
    nbytes = (2 * B * NH * S * P + 4 * B * NH * S * P + 2 * 4 * B * NH * S
              + 2 * 2 * B * S * N)
    flops = MS.scan_flops(B, NH, S, P, N, c)
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    rows.append({
        "name": "mamba2_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/mamba2_scan.cu",
        "replaces": "src/repro/kernels/mamba2_scan.py:64",
        "shape": f"B={B} NH={NH} S={S} P={P} N={N}, x bf16, y f32",
        "max_abs_err": err["mamba2_scan"], "ms": ms, "host_ms": host,
        "plain_ms": plain, "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None})
    del ins

    # the shared block's prefill attention, hd 112
    B, S, H, hd = 2, 2048, 32, 112
    q, k, v = _attn_inputs(B, S, torch.bfloat16, gen, **SHARED)
    check_lse(q, k, v, 4096, "hd 112")
    rows.append(_attn_row(q, k, v, True, 4096, err["fa112"],
                          f"B={B} H=Kh={H} S={S} hd={hd} bf16 causal "
                          f"(zamba2 shared)"))
    del q, k, v

    # the shared block's decode over the serve cell's 27 applications'
    # caches (batch 4, window 256), each cold in L2 when it is read
    B, W, L = 4, 256, 27
    q, k, v, valid = _decode_inputs(B, W, torch.bfloat16, gen, L=L,
                                    **SHARED)
    valid[0] = 1
    views = [(k[l].permute(0, 2, 1, 3), v[l].permute(0, 2, 1, 3))
             for l in range(L)]
    rows.append(_decode_row(q, views, valid, err["fd112"],
                            f"B={B} H=Kh={H} W={W} hd={hd} bf16 "
                            f"(zamba2 shared)"))
    del q, k, v, views
    torch.cuda.empty_cache()
    for r in rows:
        print_timing(r)
    return rows


def phase_hybrid_reference() -> None:
    """Reduced zamba2 in f32: the kernels on the card against the plain
    versions on the CPU, from the same parameters. Prefill logits and the
    length-masked admission pass's logits within 1e-4; the same requests
    through ServeEngine give identical token streams and serve.*
    counters."""
    import numpy as np
    import torch
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(HYBRID).reduced()
    api = get_api(cfg)
    params = api.init_params(torch.Generator("cpu").manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int64)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 30, 1, 12, 40, 3, 17, 8)]
    outs, served = {}, {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        tok = torch.tensor(tokens, device=dev)
        logits, _ = api.prefill_full_fn(p, {"tokens": tok})
        nxt, _ = api.prefill_state_fn(p, tok, [40, 23], window=48)
        outs[dev] = (logits, nxt)
        eng = ServeEngine(api, p, batch=4, window=32)
        reqs = [Request(i, pr, max_new=5) for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        served[dev] = ([r.out for r in reqs], eng.epoch,
                       eng.metrics.snapshot()["counters"])
    worst = 0.0
    for a, b in zip(outs["cpu"], outs["cuda"]):
        if not torch.isfinite(b).all():
            fail("hybrid reference: non-finite logits on the card")
        worst = max(worst, (a - b.cpu()).abs().max().item())
    print(f"hybrid reference: reduced {HYBRID} f32, card vs CPU plain: "
          f"prefill and admission logits max_abs_err={worst:.3e}; engine "
          f"streams equal: {served['cpu'] == served['cuda']} "
          f"({served['cuda'][2]})")
    if not worst <= 1e-4:
        fail(f"hybrid reference: card and CPU disagree by {worst}")
    if served["cpu"] != served["cuda"]:
        fail(f"hybrid reference: the engine served {served['cuda']} on the "
             f"card, {served['cpu']} on the CPU")


def cross_check(api, params, lengths, seed: int) -> float:
    """The two admission algorithms on one padded prompt group: the
    chunked scan's (``prefill_full_fn``) logits at each prompt's len-1
    against the recurrence's (``prefill_state_fn``) next-token logits.
    Returns their relative L2 distance."""
    import numpy as np
    import torch
    S = max(lengths)
    tokens = torch.tensor(np.random.default_rng(seed).integers(
        0, api.cfg.vocab_size, (len(lengths), S)), device="cuda")
    full, _ = api.prefill_full_fn(params, {"tokens": tokens})
    chunked = full[torch.arange(len(lengths), device="cuda"),
                   torch.tensor(lengths, device="cuda") - 1].float()
    del full
    nxt, _ = api.prefill_state_fn(params, tokens, lengths, window=S)
    if not (torch.isfinite(chunked).all() and torch.isfinite(nxt).all()):
        fail(f"{api.cfg.name} cross-check: non-finite logits")
    return ((chunked - nxt).norm() / nxt.norm()).item()


def phase_hybrid_cross_f32() -> float:
    """zamba2-7b at full width, depth 3 (one group), f32: the chunked
    scan against the recurrence within 1e-3 relative L2."""
    import dataclasses
    import torch
    from repro_torch.models.registry import get_api, get_config

    cfg = dataclasses.replace(get_config(HYBRID), n_layers=3,
                              dtype="float32")
    api = get_api(cfg)
    params = api.init_params(torch.Generator("cuda").manual_seed(1), "cuda")
    t0 = time.perf_counter()
    rel = cross_check(api, params, [512, 301], seed=3)
    torch.cuda.synchronize()
    print(f"hybrid cross-check: {HYBRID} full width, depth 3, f32, lengths "
          f"[512, 301]: prefill_full_fn vs prefill_state_fn next-token "
          f"logits relative L2 {rel:.3e} (bound {CROSS_F32_BOUND}) in "
          f"{time.perf_counter() - t0:.2f} s")
    if not rel <= CROSS_F32_BOUND:
        fail(f"hybrid cross-check f32: relative L2 {rel}")
    del params
    torch.cuda.empty_cache()
    return rel


def phase_hybrid_prefill():
    """zamba2-7b at full width and depth, bf16, random weights from a
    seeded generator: the prefill step (``prefill_fn``) on 2 x 2048
    tokens, three times, with the launch counters zeroed just before;
    then the two admission algorithms at full depth. Returns (api,
    params, launches)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import mamba2_scan as MS
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.models.transformer import n_shared_apps
    from repro_torch.utils import tree_flatten

    cfg = get_config(HYBRID)
    api = get_api(cfg)
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[1])
    # the config's count leaves out the final norm and counts each Mamba2
    # layer's norms (ln1, the gated norm's d_inner weights) as 2 d_model
    n_norms = cfg.n_layers * (1 + cfg.ssm_expand - 2) * cfg.d_model \
        + cfg.d_model
    print(f"hybrid: {HYBRID} full width ({cfg.n_layers} Mamba2 layers, "
          f"d_model {cfg.d_model}, {n_shared_apps(cfg)} shared-block "
          f"applications, hd {cfg.hd}), {n_params} parameters "
          f"(param_count() {cfg.param_count()} + {n_norms} norm weights) in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    if n_params != cfg.param_count() + n_norms:
        fail(f"hybrid: {n_params} parameters, want "
             f"{cfg.param_count() + n_norms}")
    B, S, runs = 2, 2048, 3
    tokens = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")
    torch.cuda.synchronize()
    MS.mamba2_scan.launches = 0
    FA.flash_attention.launches = 0
    FD.flash_decode.launches = 0
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        last, caches = api.prefill_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {"mamba2_scan": MS.mamba2_scan.launches,
                "flash_attention": FA.flash_attention.launches,
                "flash_decode": FD.flash_decode.launches}
    G = n_shared_apps(cfg)
    print(f"hybrid prefill: {B}x{S} tokens, bf16, {runs} runs: wall "
          f"{', '.join(f'{w:.4f}' for w in walls)} s (best "
          f"{B * S / min(walls[1:]):.1f} tok/s); launches {launches}")
    if launches != {"mamba2_scan": cfg.n_layers * runs,
                    "flash_attention": G * runs, "flash_decode": 0}:
        fail(f"hybrid prefill: launches {launches}, want "
             f"{cfg.n_layers} mamba2_scan and {G} flash_attention a forward")
    if (tuple(last.shape) != (B, cfg.vocab_size)
            or not torch.isfinite(last.float()).all()
            or tuple(caches["layers"]["k"].shape)
            != (G, B, S, cfg.n_kv_heads, cfg.hd)):
        fail(f"hybrid prefill: logits {tuple(last.shape)}, caches "
             f"{tuple(caches['layers']['k'].shape)}")
    del last, caches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rel = cross_check(api, params, [256, 141], seed=4)
    print(f"hybrid cross-check: {HYBRID} full width and depth, bf16, "
          f"lengths [256, 141]: prefill_full_fn vs prefill_state_fn "
          f"next-token logits relative L2 {rel:.3e} (bound "
          f"{CROSS_BF16_BOUND}) in {time.perf_counter() - t0:.2f} s")
    if not rel <= CROSS_BF16_BOUND:
        fail(f"hybrid cross-check bf16: relative L2 {rel}")
    torch.cuda.empty_cache()
    return api, params, launches


def phase_hybrid_serve(api, params) -> dict:
    """zamba2-7b at full width through ServeEngine: batch 4, window 256,
    8 prompts of 4..200 tokens (recurrent bulk admission in several
    length and group buckets, slot reuse) plus one of 300 (past the
    window: the sequential path and its fresh-slot reset), 16 new tokens
    each."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import mamba2_scan as MS
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = api.cfg
    eng = ServeEngine(api, params, batch=4, window=256)
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(4, 201, 8)] + [300]
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new=16)
            for i, n in enumerate(lengths)]
    for r in reqs:
        eng.submit(r)
    spent = {"rec": 0.0, "sequential": 0.0}

    def timed(fn, key):
        def run(*args):
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
        return run

    eng._admit_bulk_recurrent = timed(eng._admit_bulk_recurrent, "rec")
    eng._admit_sequential = timed(eng._admit_sequential, "sequential")
    torch.cuda.synchronize()
    MS.mamba2_scan.launches = 0
    FA.flash_attention.launches = 0
    FD.flash_decode.launches = 0
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mamba2_scan": MS.mamba2_scan.launches,
                "flash_attention": FA.flash_attention.launches,
                "flash_decode": FD.flash_decode.launches}
    if not all(r.done and len(r.out) == r.max_new for r in reqs):
        fail("hybrid serve: not every request finished")
    if not all(0 <= tok < cfg.vocab_size for r in reqs for tok in r.out):
        fail("hybrid serve: a token outside the vocabulary")
    if not launches["flash_decode"] > 0:
        fail(f"hybrid serve: flash_decode was never launched: {launches}")
    snap = eng.metrics.snapshot()
    counters = snap["counters"]
    if (counters.get("serve.admit.rec") != 8
            or counters.get("serve.admit.sequential") != 1):
        fail(f"hybrid serve: admissions {counters}")
    dec = snap["hists"]["serve.decode.token_seconds"]
    decoded = sum(len(r.out) - 1 for r in reqs)
    rec_toks = sum(n for n in lengths if n <= 256)
    seq_toks = sum(lengths) - rec_toks
    print(f"hybrid serve: {HYBRID} full width bf16, batch 4, window 256: "
          f"{len(reqs)} requests (prompts {lengths}, {sum(lengths)} prompt "
          f"tokens, {sum(len(r.out) for r in reqs)} generated) in "
          f"{wall:.3f} s: recurrent bulk admission {spent['rec']:.3f} s "
          f"({rec_toks / spent['rec']:.1f} prompt tok/s), sequential "
          f"admission {spent['sequential']:.3f} s ({seq_toks / spent['sequential']:.1f}"
          f" tok/s), {dec['count']} decode steps {dec['total']:.3f} s")
    print(f"hybrid serve: decode {decoded / dec['total']:.1f} tok/s "
          f"({1e3 * dec['total'] / dec['count']:.3f} ms/step, batch 4 incl. "
          f"inactive slots); serve counters "
          f"{ {k: v for k, v in counters.items() if k.startswith('serve.')} }"
          f"; epochs {eng.epoch}; launches {launches}")
    B = eng.batch
    tok = torch.zeros((B,), dtype=torch.int32, device="cuda")
    t = torch.full((B,), 200, dtype=torch.int32, device="cuda")
    prompt = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 2048)), device="cuda")
    profile_work({
        "hybrid decode step": (3, lambda: api.decode_fn(
            params, eng.state, {"token": tok, "t": t})),
        "hybrid prefill 2x2048": (1, lambda: api.prefill_fn(
            params, {"tokens": prompt})),
    }, "hybrid_profile.txt")
    return launches

# ---------------------------------------------------------- xLSTM phases
XLSTM = "xlstm-125m"
# the kernel against its plain version, by y's dtype: in f32 relative to
# max(1, max|ref|); in bf16 element-wise, relative to each |ref| plus
# MLSTM_BF16_ATOL (one bf16 rounding either side)
MLSTM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
MLSTM_BF16_ATOL = 1e-2


def _mlstm_inputs(gen, B, NH, S, hd, dtype):
    """The model's layout at xlstm's widths: q, k, v (B, NH, S, hd) views
    of (B, S, NH, hd) projections (k scaled by 1/sqrt(hd)), logi and logf
    (B, NH, S) views of (B, S, NH) f32; the reference kernel test's
    distributions."""
    import torch
    import torch.nn.functional as F
    q, k, v = (torch.randn((B, S, NH, hd), generator=gen, device="cuda")
               for _ in range(3))
    k = k / math.sqrt(hd)
    logi = 0.5 * torch.randn((B, S, NH), generator=gen, device="cuda")
    logf = F.logsigmoid(torch.randn((B, S, NH), generator=gen,
                                    device="cuda") + 2.0)
    return tuple(t.to(dtype).transpose(1, 2) for t in (q, k, v)) + (
        logi.transpose(1, 2), logf.transpose(1, 2))


def phase_xlstm_parity():
    """mlstm_chunkwise against its plain version at xlstm-125m's
    full-width prefill (B=8, NH=4, S=2048, hd=384), at a ragged S=1000,
    one short chunk (S=40), S=1, and at hd 64; q/k/v in bf16 and f32, y
    in f32 (2e-4 of max(1, max|ref|)) and bf16 (element-wise, 2e-2 of
    |ref| plus 1e-2). Then
    the kernel and its plain version timed (no PyTorch call computes the
    mLSTM: its library time is null); returns the timing row."""
    import torch
    from repro_torch.kernels import mlstm_kernel as MK

    gen = torch.Generator("cuda").manual_seed(5)
    err = 0.0
    for B, NH, S, hd in ((8, 4, 2048, 384), (2, 4, 1000, 384),
                         (2, 4, 40, 384), (2, 4, 1, 384), (2, 2, 256, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            ins = _mlstm_inputs(gen, B, NH, S, hd, dtype)
            for out in (torch.float32, torch.bfloat16):
                got = MK.mlstm_chunkwise(*ins, out_dtype=out)
                want = MK.mlstm_chunkwise_plain(*ins, out_dtype=out)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                e = diff.max().item()
                scale = max(1.0, want.float().abs().max().item())
                oname = str(out).split(".")[1]
                if out == torch.float32:
                    ok = e <= MLSTM_TOL[oname] * scale
                else:
                    ok = bool((diff <= MLSTM_TOL[oname] * want.float().abs()
                               + MLSTM_BF16_ATOL).all())
                print(f"parity mlstm_chunkwise {str(dtype).split('.')[1]} "
                      f"q/k/v, {oname} y, B={B} NH={NH} S={S} hd={hd}: "
                      f"max_abs_err={e:.3e} (max |y| {scale:.3e})")
                if not ok or not torch.isfinite(got.float()).all():
                    fail(f"mlstm_chunkwise {dtype} -> {out} B={B} S={S} "
                         f"hd={hd} err {e}")
                if dtype == torch.bfloat16 and out == torch.float32:
                    err = max(err, e)
                del got, want, diff
            del ins
    torch.cuda.empty_cache()

    # the kernel at the full-width prefill, as the model calls it
    B, NH, S, hd = 8, 4, 2048, 384
    ins = _mlstm_inputs(gen, B, NH, S, hd, torch.bfloat16)
    ms, host = time_ms(lambda: MK.mlstm_chunkwise(*ins,
                                                  out_dtype=torch.float32),
                       kernels=MLSTM_BF16)
    plain, _ = time_ms(lambda: MK.mlstm_chunkwise_plain(
        *ins, out_dtype=torch.float32), iters=3)
    nbytes, flops = MK.mlstm_cost(B, NH, S, hd)
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    row = {
        "name": "mlstm_chunkwise", "route": "cuda",
        "source": "src/repro_torch/csrc/mlstm_chunkwise.cu",
        "replaces": "src/repro/kernels/mlstm_kernel.py:77",
        "shape": f"B={B} NH={NH} S={S} hd={hd}, q/k/v bf16, y f32",
        "max_abs_err": err, "ms": ms, "host_ms": host, "plain_ms": plain,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "ptxas": ptxas_regs("mlstm_chunkwise", r"mlstm_tc_kernelIfE")}
    del ins
    torch.cuda.empty_cache()
    print(f"timing mlstm_chunkwise ({row['shape']}), device ms per call: "
          f"kernel {ms:.4f} (host-timed {host:.4f}), plain {plain:.4f}, "
          f"library none, bound {row['bound_ms']:.4f} ({row['bound_by']}: "
          f"{nbytes / 1e6:.1f} MB, {flops:.3e} flops); ptxas "
          f"{row['ptxas']}")
    return [row]


def phase_xlstm_reference() -> None:
    """Reduced xlstm-125m in f32: the kernel on the card against the
    plain version on the CPU, from the same parameters. Prefill logits
    (S=300) and the length-masked admission pass's logits within 1e-4;
    the same requests through ServeEngine give identical token streams,
    epochs and serve.* counters."""
    import numpy as np
    import torch
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(XLSTM).reduced()
    api = get_api(cfg)
    params = api.init_params(torch.Generator("cpu").manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 300)).astype(np.int64)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 30, 1, 12, 40, 3, 17, 8)]
    outs, served = {}, {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        tok = torch.tensor(tokens, device=dev)
        logits, _ = api.prefill_full_fn(p, {"tokens": tok})
        nxt, _ = api.prefill_state_fn(p, tok[:, :40], [40, 23], window=48)
        outs[dev] = (logits, nxt)
        eng = ServeEngine(api, p, batch=4, window=32)
        reqs = [Request(i, pr, max_new=5) for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        served[dev] = ([r.out for r in reqs], eng.epoch,
                       eng.metrics.snapshot()["counters"])
    worst = 0.0
    for a, b in zip(outs["cpu"], outs["cuda"]):
        if not torch.isfinite(b).all():
            fail("xlstm reference: non-finite logits on the card")
        worst = max(worst, (a - b.cpu()).abs().max().item())
    print(f"xlstm reference: reduced {XLSTM} f32, card vs CPU plain: "
          f"prefill and admission logits max_abs_err={worst:.3e}; engine "
          f"streams equal: {served['cpu'] == served['cuda']} "
          f"({served['cuda'][2]})")
    if not worst <= 1e-4:
        fail(f"xlstm reference: card and CPU disagree by {worst}")
    if served["cpu"] != served["cuda"]:
        fail(f"xlstm reference: the engine served {served['cuda']} on the "
             f"card, {served['cpu']} on the CPU")


def phase_xlstm_cross_f32() -> float:
    """xlstm-125m at full width and depth, f32: the chunked form
    (``prefill_full_fn``) against the recurrence (``prefill_state_fn``)
    within 1e-3 relative L2, lengths [300, 170]."""
    import dataclasses
    import torch
    from repro_torch.models.registry import get_api, get_config

    cfg = dataclasses.replace(get_config(XLSTM), dtype="float32")
    api = get_api(cfg)
    params = api.init_params(torch.Generator("cuda").manual_seed(1), "cuda")
    t0 = time.perf_counter()
    rel = cross_check(api, params, [300, 170], seed=5)
    torch.cuda.synchronize()
    print(f"xlstm cross-check: {XLSTM} full width and depth, f32, lengths "
          f"[300, 170]: prefill_full_fn vs prefill_state_fn next-token "
          f"logits relative L2 {rel:.3e} (bound {CROSS_F32_BOUND}) in "
          f"{time.perf_counter() - t0:.2f} s")
    if not rel <= CROSS_F32_BOUND:
        fail(f"xlstm cross-check f32: relative L2 {rel}")
    del params
    torch.cuda.empty_cache()
    return rel


def phase_xlstm_prefill():
    """xlstm-125m at full width and depth (9 mLSTM and 3 sLSTM layers,
    bf16, random weights from a seeded generator): the prefill step
    (``prefill_fn``) on 8 x 2048 tokens, three times, with every launch
    counter zeroed just before; then one mLSTM and one sLSTM block timed
    alone at the same shape, and the two admission algorithms at full
    depth in bf16. Returns (api, params, launches)."""
    import numpy as np
    import torch
    from repro_torch.kernels import bucket_combine as BC
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import mamba2_scan as MS
    from repro_torch.kernels import mlstm_kernel as MK
    from repro_torch.models import xlstm as XL
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.utils import tree_flatten

    cfg = get_config(XLSTM)
    api = get_api(cfg)
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_flatten(params)[1])
    G, k = cfg.n_layers // cfg.slstm_every, cfg.slstm_every
    d_in, hd = XL.mlstm_dims(cfg.d_model, cfg.n_heads)
    print(f"xlstm: {XLSTM} full width ({G * (k - 1)} mLSTM layers at d_in "
          f"{d_in}, head dim {hd}; {G} sLSTM layers; d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}), {n_params} parameters "
          f"in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    B, S, runs = 8, 2048, 3
    tokens = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)), device="cuda")
    torch.cuda.synchronize()
    MK.mlstm_chunkwise.launches = 0
    MS.mamba2_scan.launches = 0
    FA.flash_attention.launches = 0
    FA.flash_attention_bwd.launches = 0
    FD.flash_decode.launches = 0
    BC.bucket_combine.launches = 0
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        last, caches = api.prefill_fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {"mlstm_chunkwise": MK.mlstm_chunkwise.launches,
                "mamba2_scan": MS.mamba2_scan.launches,
                "flash_attention": FA.flash_attention.launches,
                "flash_attention_bwd": FA.flash_attention_bwd.launches,
                "flash_decode": FD.flash_decode.launches,
                "bucket_combine": BC.bucket_combine.launches}
    want = {name: 0 for name in launches}
    want["mlstm_chunkwise"] = G * (k - 1) * runs
    print(f"xlstm prefill: {B}x{S} tokens, bf16, {runs} runs: wall "
          f"{', '.join(f'{w:.4f}' for w in walls)} s (best "
          f"{B * S / min(walls[1:]):.1f} tok/s); launches {launches}")
    if launches != want:
        fail(f"xlstm prefill: launches {launches}, want {want}")
    if (tuple(last.shape) != (B, cfg.vocab_size)
            or not torch.isfinite(last.float()).all()
            or caches != {"layers": None}):
        fail(f"xlstm prefill: logits {tuple(last.shape)}, caches {caches}")
    del last, caches
    # one block of each kind alone at the prefill's shape: where a
    # forward's time goes (host wall, synchronised)
    blocks = params["blocks"]
    hn = torch.randn((B, S, cfg.d_model), generator=torch.Generator(
        "cuda").manual_seed(3), device="cuda").to(torch.bfloat16)
    pm = {n: t[0, 0] for n, t in blocks["mlstm"].items()}
    ps = {n: t[0] for n, t in blocks["slstm"].items()}
    for name, fn in (("mLSTM", lambda: XL.mlstm_apply(
            pm, hn, n_heads=cfg.n_heads)), ("sLSTM", lambda: XL.slstm_apply(
                ps, hn, n_heads=cfg.n_heads))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"xlstm prefill: one {name} block at {B}x{S}: "
              f"{1e3 * (time.perf_counter() - t0):.3f} ms host wall")
    del hn
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rel = cross_check(api, params, [300, 170], seed=6)
    print(f"xlstm cross-check: {XLSTM} full width and depth, bf16, "
          f"lengths [300, 170]: prefill_full_fn vs prefill_state_fn "
          f"next-token logits relative L2 {rel:.3e} (bound "
          f"{CROSS_BF16_BOUND}) in {time.perf_counter() - t0:.2f} s")
    if not rel <= CROSS_BF16_BOUND:
        fail(f"xlstm cross-check bf16: relative L2 {rel}")
    torch.cuda.empty_cache()
    return api, params, launches


def phase_xlstm_serve(api, params) -> dict:
    """xlstm-125m at full width through ServeEngine: batch 8, window 256,
    12 prompts of 4..200 tokens (recurrent bulk admission in several
    length and group buckets, slot reuse) plus one of 300 (past the
    window: the sequential path and its fresh-slot reset), 16 new tokens
    each. Admission and decode are decode passes in plain torch ops (the
    reference has no kernel for them), so this path launches no
    kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels import bucket_combine as BC
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import mamba2_scan as MS
    from repro_torch.kernels import mlstm_kernel as MK
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = api.cfg
    eng = ServeEngine(api, params, batch=8, window=256)
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(4, 201, 12)] + [300]
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new=16)
            for i, n in enumerate(lengths)]
    for r in reqs:
        eng.submit(r)
    spent = {"rec": 0.0, "sequential": 0.0}

    def timed(fn, key):
        def run(*args):
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
        return run

    eng._admit_bulk_recurrent = timed(eng._admit_bulk_recurrent, "rec")
    eng._admit_sequential = timed(eng._admit_sequential, "sequential")
    torch.cuda.synchronize()
    MK.mlstm_chunkwise.launches = 0
    MS.mamba2_scan.launches = 0
    FA.flash_attention.launches = 0
    FA.flash_attention_bwd.launches = 0
    FD.flash_decode.launches = 0
    BC.bucket_combine.launches = 0
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mlstm_chunkwise": MK.mlstm_chunkwise.launches,
                "mamba2_scan": MS.mamba2_scan.launches,
                "flash_attention": FA.flash_attention.launches,
                "flash_attention_bwd": FA.flash_attention_bwd.launches,
                "flash_decode": FD.flash_decode.launches,
                "bucket_combine": BC.bucket_combine.launches}
    if not all(r.done and len(r.out) == r.max_new for r in reqs):
        fail("xlstm serve: not every request finished")
    if not all(0 <= tok < cfg.vocab_size for r in reqs for tok in r.out):
        fail("xlstm serve: a token outside the vocabulary")
    if any(launches.values()):
        fail(f"xlstm serve: a kernel launched on the decode path: "
             f"{launches}")
    snap = eng.metrics.snapshot()
    counters = snap["counters"]
    if (counters.get("serve.admit.rec") != 12
            or counters.get("serve.admit.sequential") != 1):
        fail(f"xlstm serve: admissions {counters}")
    dec = snap["hists"]["serve.decode.token_seconds"]
    decoded = sum(len(r.out) - 1 for r in reqs)
    rec_toks = sum(n for n in lengths if n <= 256)
    seq_toks = sum(lengths) - rec_toks
    print(f"xlstm serve: {XLSTM} full width bf16, batch 8, window 256: "
          f"{len(reqs)} requests (prompts {lengths}, {sum(lengths)} prompt "
          f"tokens, {sum(len(r.out) for r in reqs)} generated) in "
          f"{wall:.3f} s: recurrent bulk admission {spent['rec']:.3f} s "
          f"({rec_toks / spent['rec']:.1f} prompt tok/s), sequential "
          f"admission {spent['sequential']:.3f} s "
          f"({seq_toks / spent['sequential']:.1f} tok/s), {dec['count']} "
          f"decode steps {dec['total']:.3f} s")
    print(f"xlstm serve: decode {decoded / dec['total']:.1f} tok/s "
          f"({1e3 * dec['total'] / dec['count']:.3f} ms/step, batch 8 incl. "
          f"inactive slots); serve counters "
          f"{ {k: v for k, v in counters.items() if k.startswith('serve.')} }"
          f"; epochs {eng.epoch}; launches {launches}")
    B = eng.batch
    tok = torch.zeros((B,), dtype=torch.int32, device="cuda")
    t = torch.full((B,), 200, dtype=torch.int32, device="cuda")
    # the prefill profiled at 8 x 512: the sLSTM loop's ~40 launches a
    # token would flood the profiler at 2048
    prompt = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 512)), device="cuda")
    profile_work({
        "xlstm decode step": (3, lambda: api.decode_fn(
            params, eng.state, {"token": tok, "t": t})),
        "xlstm prefill 8x512": (1, lambda: api.prefill_fn(
            params, {"tokens": prompt})),
    }, "xlstm_profile.txt")
    return launches


# ------------------------------------------------------- pipeline phases
# the pipeline reference's two cases: (stages, microbatches, interleave,
# overlap, block_groups, layers)
PIPE_CASES = ((2, 2, 1, "eager", None, 2), (2, 2, 2, "pipelined", 2, 4))
# the full-width pipeline run: churn 2 -> 3 -> 2 over three member sets
PIPE_CHURN = "join@4,leave:0@8"
PIPE_S, PIPE_V, PIPE_M, PIPE_STEPS = 3, 2, 3, 12
PIPE_B, PIPE_SEQ, PIPE_LR, PIPE_WARMUP = 18, 1024, 2e-3, 3


def phase_pipeline_reference() -> None:
    """The 2-D step on the card against the CPU's plain versions, and
    against the card's single-axis ``xla_psum`` program: reduced smollm
    in f32, team 3 with one departed worker."""
    import numpy as np
    import torch
    from repro_torch.collective_exec import build_gradsync_program
    from repro_torch.core.collective import PhaserCollective
    from repro_torch.data import make_batch
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.optim import AdamW
    from repro_torch.pipeline_exec import build_pipeline_program
    from repro_torch.utils import tree_flatten, tree_map

    for S, M, v, ov, bg, L in PIPE_CASES:
        api = get_api(get_config("smollm-135m").reduced(n_layers=L))
        opt = AdamW(lr=1e-3, warmup=10, total_steps=20)
        params = api.init_params(torch.Generator("cpu").manual_seed(0),
                                 "cpu")
        batch = make_batch(api.cfg.vocab_size, 12, 16, seed=0, step=0)
        res = {}
        for dev, kind in (("cpu", "phaser_scsl"), ("cuda", "phaser_scsl"),
                          ("cuda", "xla_psum")):
            pc = PhaserCollective(3, "data", kind=kind, seed=0)
            prog = (build_pipeline_program(
                api, opt, pc, n_stages=S, interleave=v, device=dev,
                microbatches=M, overlap=ov, block_groups=bg)
                if kind != "xla_psum" else
                build_gradsync_program(api, opt, pc, device=dev))
            p = tree_map(lambda t: t.to(dev), params)
            alive = torch.tensor([1, 0, 1], dtype=torch.float32,
                                 device=dev)
            newp, _, pm = prog.step(p, opt.init(p), {
                k: torch.tensor(x, device=dev) for k, x in batch.items()},
                alive)
            m = prog.reduce_metrics(pm)
            res[(dev, kind)] = ([t.cpu() for t in tree_flatten(newp)[1]],
                                m["loss"].item())
        card, cpu = res[("cuda", "phaser_scsl")], res[("cpu", "phaser_scsl")]
        single = res[("cuda", "xla_psum")]
        e = max(abs(card[1] - cpu[1]),
                *((a - b).abs().max().item() for a, b in zip(card[0],
                                                             cpu[0])))
        if not all(torch.isfinite(a).all() for a in card[0]):
            fail(f"pipeline reference S{S}M{M}v{v}: non-finite params")
        if not e <= 1e-4:
            fail(f"pipeline reference S{S}M{M}v{v}: card and CPU disagree "
                 f"by {e}")
        try:
            np.testing.assert_allclose(card[1], single[1], rtol=1e-5,
                                       atol=1e-6)
            for a, b in zip(card[0], single[0]):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                           atol=2e-5)
        except AssertionError as err:
            fail(f"pipeline reference S{S}M{M}v{v} {ov}: the 2-D step and "
                 f"the single-axis program disagree on the card: {err}")
        e_single = max(abs(card[1] - single[1]),
                       *((a - b).abs().max().item()
                         for a, b in zip(card[0], single[0])))
        print(f"pipeline reference: reduced smollm f32 ({L} layers), S={S} "
              f"M={M} v={v} {ov}, team 3, one departed worker: card vs CPU "
              f"plain max_abs_err={e:.3e}; card vs single-axis xla_psum "
              f"max_abs_err={e_single:.3e}")


def profile_ranges(fn, ranges=RANGES):
    """One call of ``fn`` under torch.profiler: (host wall ms, device
    busy ms, {range: {"host_ms", "device_ms", "count"}}, kernels by name,
    the profiler). A range's device ms sums the kernels inside the time
    windows of its device-side marks, over every instance of it."""
    import bisect
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    kern = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(ranges))
    starts = [k[0] for k in kern]
    spans = {}
    for e in events:
        if not e.name.startswith(ranges):
            continue
        sp = spans.setdefault(e.name, {"host_ms": 0.0, "device_ms": 0.0,
                                       "count": 0})
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            sp["host_ms"] += (hi - lo) / 1e3
            sp["count"] += 1
        elif e.device_type == DeviceType.CUDA:
            i = bisect.bisect_left(starts, lo)
            while i < len(kern) and kern[i][0] <= hi:
                if kern[i][1] <= hi:
                    sp["device_ms"] += (kern[i][1] - kern[i][0]) / 1e3
                i += 1
    by_name = {}
    for a, b, name in kern:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    return wall, sum(by_name.values()), spans, by_name, prof


def phase_pipeline_train() -> dict:
    """smollm-135m at full width and depth through ``TrainLoop`` on the
    2-D pipeline program; returns the kernels' launches in the run."""
    import statistics
    import torch
    from repro_torch.collective_exec import build_gradsync_program
    from repro_torch.core.collective import PhaserCollective
    from repro_torch.data import SyntheticLM, make_batch
    from repro_torch.kernels import bucket_combine as BC
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.train import parse_elastic
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.optim import AdamW
    import repro_torch.pipeline_exec as PE
    from repro_torch.runtime_elastic import ElasticPhaserRuntime
    from repro_torch.train import TrainLoop

    cfg = get_config("smollm-135m")
    api = get_api(cfg)
    n0 = 2
    opt = AdamW(lr=PIPE_LR, warmup=PIPE_WARMUP, total_steps=PIPE_STEPS)
    params = api.init_params(torch.Generator("cuda").manual_seed(0), "cuda")
    runtime = ElasticPhaserRuntime(n0, seed=0, kind="phaser_scsl")
    # the first step's single-axis reference: the same parameters, batch
    # and team as the loop's first step
    first = {k: torch.tensor(v, device="cuda") for k, v in make_batch(
        cfg.vocab_size, PIPE_B, PIPE_SEQ, seed=0, step=0).items()}
    single = build_gradsync_program(
        api, opt, PhaserCollective(n0, "data", kind="xla_psum",
                                   keys=runtime.epoch.live), device="cuda")
    _, _, pm = single.step(params, opt.init(params), first)
    m_single = {k: v.item() for k, v in single.reduce_metrics(pm).items()
                if k in ("loss", "grad_norm")}
    del single, pm, first
    torch.cuda.empty_cache()

    proofs = []
    verify = PE.verify_phase_order

    def counted(sched):
        proofs.append(verify(sched))
        return proofs[-1]
    PE.verify_phase_order = counted
    try:
        runtime.verify_epoch()                  # epoch 0, before the run
        PE.verify_phase_order(PE.derive_interleaved(PIPE_S, PIPE_M, PIPE_V))
        loop = TrainLoop(api=api, opt=opt,
                         data=SyntheticLM(vocab=cfg.vocab_size, batch=PIPE_B,
                                          seq=PIPE_SEQ, seed=0),
                         log_every=1, runtime=runtime,
                         elastic_events=parse_elastic(PIPE_CHURN),
                         overlap_sync=True, pipeline_stages=PIPE_S,
                         interleave=PIPE_V, microbatches=PIPE_M,
                         device="cuda")
        torch.cuda.synchronize()
        FA.flash_attention.launches = 0
        FA.flash_attention_bwd.launches = 0
        BC.bucket_combine.launches = 0
        t0 = time.perf_counter()
        params, opt_state = loop.run(PIPE_STEPS, params=params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": FA.flash_attention.launches,
                    "flash_attention_bwd": FA.flash_attention_bwd.launches,
                    "bucket_combine": BC.bucket_combine.launches}
    finally:
        PE.verify_phase_order = verify
    runtime.verify_epoch()
    # bucket_combine at this path's shape: the team-3 epoch's largest
    # readiness group, its stage rows folded into the rows dim, bitwise
    # against the plain version (launches here are not the run's)
    prog = max((ts.program for ts in loop._progs.programs()),
               key=lambda p: p.n)
    rows = PIPE_S * max(hi - lo for lo, hi in prog.layout.groups)
    gen = torch.Generator("cuda").manual_seed(3)
    acc, y = (torch.randn((prog.n, rows, prog.layout.bucket_elems),
                          generator=gen, device="cuda") for _ in range(2))
    gate = torch.tensor([1, 0, 1][:prog.n], dtype=torch.int32,
                        device="cuda")
    for op in ("add", "copy"):
        if not torch.equal(BC.bucket_combine(acc, y, gate, op=op),
                           BC.combine_ref(acc, y, gate, op=op)):
            fail(f"pipeline train: bucket_combine {op} at "
                 f"{tuple(acc.shape)} differs from its plain version")
    print(f"parity bucket_combine add, copy at the pipeline's "
          f"{tuple(acc.shape)} (team {prog.n}, {PIPE_S} stage rows of the "
          f"largest group): bitwise equal")
    del acc, y
    ms = loop.metrics_log
    losses = [m["loss"] for m in ms]
    predicted = sum(int(m["sync_rounds"]) * int(m["bucket_groups"])
                    for m in ms)
    teams = [len(e["live"]) for e in loop.epoch_log]
    loss_err = abs(losses[0] - m_single["loss"]) / m_single["loss"]
    norm_err = (abs(ms[0]["grad_norm"] - m_single["grad_norm"])
                / m_single["grad_norm"])
    print(f"pipeline train: smollm-135m full width and depth bf16, "
          f"{PIPE_S} stages x {PIPE_V} interleave ({PIPE_S * PIPE_V} chunks "
          f"of {cfg.n_layers // (PIPE_S * PIPE_V)} layers), {PIPE_M} "
          f"microbatches, overlap on, {PIPE_B}x{PIPE_SEQ} tokens/step, "
          f"{PIPE_STEPS} steps in {wall:.3f} s, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} ({[round(x, 4) for x in losses]}); epochs "
          f"{[n0] + teams}; program cache {loop._progs.stats()}; "
          f"pipeline_waves {int(ms[0]['pipeline_waves'])}, ring_slots "
          f"{int(ms[0]['ring_slots'])}, bucket_groups "
          f"{int(ms[0]['bucket_groups'])}; phase-order proofs "
          f"{len(proofs)}; launches {launches}; bucket_combine launches "
          f"{launches['bucket_combine']}, the schedule predicts {predicted} "
          f"(rounds x bucket groups, stage rows folded, per step)")
    print(f"pipeline train: first step vs the single-axis program from the "
          f"same parameters and batch: loss {losses[0]:.6f} vs "
          f"{m_single['loss']:.6f} (rel {loss_err:.3e}), grad_norm "
          f"{ms[0]['grad_norm']:.6f} vs {m_single['grad_norm']:.6f} (rel "
          f"{norm_err:.3e})")
    if len(losses) != PIPE_STEPS or not all(math.isfinite(x)
                                            for x in losses):
        fail(f"pipeline train: losses not all finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"pipeline train: loss did not fall: {losses[0]} -> "
             f"{losses[-1]}")
    if not (loss_err <= 2e-2 and norm_err <= 2e-2):
        fail(f"pipeline train: first step off the single-axis program's: "
             f"loss rel {loss_err}, grad_norm rel {norm_err}")
    if runtime.epoch.index != 2 or teams != [3, 2] or len(proofs) != 3:
        fail(f"pipeline train: epochs {runtime.epoch.index + 1}, "
             f"boundaries {teams}, phase-order proofs {len(proofs)}")
    if loop._progs.stats()["misses"] != 3:
        fail(f"pipeline train: program cache {loop._progs.stats()}")
    if not all(n > 0 for n in launches.values()):
        fail(f"pipeline train: a kernel was never launched: {launches}")
    if launches["bucket_combine"] != predicted:
        fail(f"pipeline train: {launches['bucket_combine']} bucket_combine "
             f"launches, the schedule predicts {predicted}")
    # a step belongs to the epoch of the boundaries before it (the log's
    # "epoch" is read after the step's own boundary)
    bounds = [e["step"] for e in loop.epoch_log]
    by_epoch = {}
    for m in ms:
        by_epoch.setdefault(sum(b < m["step"] for b in bounds), []).append(m)
    for ep, rows in sorted(by_epoch.items()):
        med = statistics.median(r["dt"] for r in rows)
        print(f"pipeline train: epoch {ep} (team {int(rows[0]['team'])}): "
              f"{len(rows)} steps, median step {med:.4f} s, "
              f"{PIPE_B * PIPE_SEQ / med:.1f} tokens/s, pipeline_waves "
              f"{int(rows[0]['pipeline_waves'])}")
    phase_pipeline_profile(loop, params, opt_state)
    return launches


def phase_pipeline_profile(loop, params, opt_state) -> None:
    """One more step of the last epoch's pipeline program under
    torch.profiler: host wall and device busy split among the step's
    four ranges (pipeline.fwd, pipeline.bwd, gradsync.sync,
    gradsync.update)."""
    import torch

    ts = loop._build_step()
    n = ts.program.n
    alive = torch.ones((n,), device="cuda")
    batch = {k: torch.tensor(v, device="cuda")
             for k, v in next(loop.data).items()}
    ts.fn(params, opt_state, batch, alive)          # warm: one unprofiled
    torch.cuda.synchronize()
    wall, busy, spans, by_name, prof = profile_ranges(
        lambda: ts.fn(params, opt_state, batch, alive))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    attn = sum(v for k, v in by_name.items()
               if any(m in k for m in PORT_KERNELS["attention"]))
    comb = sum(v for k, v in by_name.items() if "combine_" in k)
    parts = "; ".join(f"{k} x{v['count']} host {v['host_ms']:.3f} ms device "
                      f"{v['device_ms']:.3f} ms"
                      for k, v in sorted(spans.items()))
    print(f"profile pipeline step (team {n}, {PIPE_S} stages x {PIPE_V}, "
          f"{tuple(batch['tokens'].shape)} tokens): host wall {wall:.3f} "
          f"ms, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%); "
          f"attention kernels {attn:.3f} ms, bucket_combine {comb:.3f} ms; "
          f"{parts}; top: "
          + "; ".join(f"{k[:40]} {v:.3f}" for k, v in top[:4]))
    with open(os.path.join(HERE, "chiprun_out", "pipeline_profile.txt"),
              "w") as f:
        f.write(f"== pipeline step, team {n}: wall {wall:.4f} ms, busy "
                f"{busy:.4f} ms\n{json.dumps(spans, indent=1)}\n"
                + "\n".join(f"{v:10.4f} ms  {k}" for k, v in top) + "\n")
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=60) + "\n")


# ------------------------------------------------ the multi-host runtime
# host processes x ranks stacked on each, per-rank batch (as the train
# phase's global 12 x 1024), the churn of whole hosts of each fabric
MH_HOSTS, MH_RANKS, MH_B, MH_SEQ = 3, 2, 2, 1024
MH_STEPS, MH_CHURN = 12, "join@4,fail:1@8"          # 3 -> 4 -> 3 hosts
MH_SOCK_STEPS, MH_SOCK_CHURN = 8, "kill@5"           # 3 -> 2 hosts
MH_LR, MH_WARMUP = 1e-3, 3
# socket fabric: heartbeat period and the silence floor of a death. A
# host's echoes wait behind any large frame it sends the coordinator
# (a 539 MB buffer takes seconds to pickle, check and read), so the floor
# keeps well clear of that
MH_HB, MH_FAILURE_TIMEOUT = 0.5, 20.0
MH_REF_STEPS, MH_REF_CHURN = 4, "join@2"
# the first step's parameters against the flat program's, relative L2
MH_FIRST_TOL = 1e-4
# the full-width phases' device and model (a CPU rehearsal of the phases'
# control flow sets "cpu" and the reduced model)
MH_DEVICE, MH_REDUCED = "cuda", False


def _mh_print(msg: str) -> None:
    """A multi-host result line, with the card it was measured on."""
    print(f"{msg} [{card_line()}]")


def _mh_data(device: str, *, reduced: bool, **kw) -> dict:
    d = {"arch": "smollm-135m", "reduced": reduced, "batch": MH_B,
         "seq": MH_SEQ, "lr": MH_LR, "warmup": MH_WARMUP,
         "steps": MH_STEPS, "devices": MH_RANKS, "device": device,
         "local_kind": "phaser_scsl"}
    d.update(kw)
    return d


def _mh_drive(rt, steps: int, churn: str, *, kill=None, on_step=None):
    """Drive ``steps`` steps of a ``DistCoordinator`` through ``churn``
    as the train CLI does; after every step the loss probe of every live
    host. Returns per-step rows: (step, per-host replies, probes, step
    seconds, live hosts of the step)."""
    from repro_torch.launch.train import parse_elastic
    events = parse_elastic(churn)
    rows = []
    for step in range(steps):
        for kind, wid in events.get(step, []):
            if kind == "join":
                rt.request_join(step=step)
            elif kind == "kill":
                kill(wid if wid is not None else max(rt.live))
            else:
                rt.request_leave(wid if wid is not None else max(rt.live),
                                 fail=kind == "fail", step=step)
        t0 = time.perf_counter()
        out = rt.train_step(step)
        dt = time.perf_counter() - t0
        rt.advance(step=step)
        probes = {p: rt.cluster.call(p, {"op": "loss_probe"})["loss"]
                  for p in sorted(rt.live)}
        rows.append((step, out, probes, dt, sorted(out)))
        if on_step is not None:
            on_step(step)
    return rows


def phase_multihost_reference() -> None:
    """Reduced smollm (2 layers, f32), 3 hosts x 2 ranks in-process,
    4 steps with one join: the kernels on the card against the plain
    versions on the CPU, from the same parameters."""
    from repro_torch.runtime_dist import DistCoordinator, InprocCluster
    res = {}
    for dev in ("cpu", "cuda"):
        rt = DistCoordinator(
            InprocCluster(), MH_HOSTS, seed=0,
            data_for=lambda pid, dev=dev: _mh_data(
                dev, reduced=True, layers=2, seq=64, steps=MH_REF_STEPS))
        rows = _mh_drive(rt, MH_REF_STEPS, MH_REF_CHURN)
        res[dev] = ([{p: r["loss"] for p, r in out.items()}
                     for _, out, _, _, _ in rows], rows[-1][2])
        rt.close()
    (cl, cp), (gl, gp) = res["cpu"], res["cuda"]
    err = max(max(abs(a[p] - b[p]) for p in a) for a, b in zip(gl, cl))
    perr = max(abs(gp[p] - cp[p]) for p in cp)
    _mh_print(f"multihost reference: reduced smollm f32, {MH_HOSTS} hosts x "
              f"{MH_RANKS} ranks in-process, {MH_REF_STEPS} steps, "
              f"{MH_REF_CHURN}: card vs CPU plain per-host losses max_abs_err="
              f"{err:.3e}, final loss probes max_abs_err={perr:.3e}")
    if [sorted(x) for x in gl] != [sorted(x) for x in cl]:
        fail(f"multihost reference: hosts differ: {gl} vs {cl}")
    if not (err <= 1e-4 and perr <= 1e-4):
        fail(f"multihost reference: card and CPU disagree: {err}, {perr}")
    if len(set(gp.values())) != 1:
        fail(f"multihost reference: probes differ on the card: {gp}")


def _mh_first_step_reference(params, api, cfg):
    """The flat ``build_gradsync_program`` over the same 6 ranks and
    batches as the hierarchical run's first step: its parameters."""
    import numpy as np
    import torch
    from repro_torch.collective_exec import build_gradsync_program
    from repro_torch.core.collective import PhaserCollective
    from repro_torch.data import make_batch
    from repro_torch.optim import AdamW
    opt = AdamW(lr=MH_LR, warmup=MH_WARMUP, total_steps=MH_STEPS)
    n = MH_HOSTS * MH_RANKS
    bs = [make_batch(cfg.vocab_size, MH_B, MH_SEQ, seed=1000 + r, step=0)
          for r in range(n)]
    batch = {k: torch.tensor(np.stack([b[k] for b in bs]),
                             device=MH_DEVICE) for k in bs[0]}
    prog = build_gradsync_program(
        api, opt, PhaserCollective(n, "data", kind="phaser_scsl", seed=0),
        device=MH_DEVICE, stacked=True)
    new_p, _, pm = prog.step(params, opt.init(params), batch)
    gn = pm["grad_norm"][0].item()
    torch.cuda.synchronize()
    return new_p, gn


def _rel_l2_tree(a, b) -> float:
    from repro_torch.utils import tree_flatten
    num = den = 0.0
    for x, y in zip(tree_flatten(a)[1], tree_flatten(b)[1]):
        num += (x.float() - y.float()).pow(2).sum().item()
        den += y.float().pow(2).sum().item()
    return math.sqrt(num / max(den, 1e-30))


def _mh_medians(rows, label: str) -> None:
    import statistics
    by = {}
    for step, out, _, dt, live in rows:
        by.setdefault(tuple(live), []).append(dt)
    for live, dts in by.items():
        med = statistics.median(dts)
        tokens = len(live) * MH_RANKS * MH_B * MH_SEQ
        _mh_print(f"multihost {label}: hosts {list(live)}: {len(dts)} "
                  f"steps, median step {med:.4f} s, {tokens / med:.1f} "
                  f"tokens/s")


def _mh_split(rows, label: str) -> None:
    """Median seconds of each part of a step over the run's hosts and
    steps (the agents' replies; host clock around device-synchronized
    work)."""
    import statistics
    parts = {}
    for _, out, _, _, _ in rows:
        for r in out.values():
            for k in ("grads_s", "d2h_s", "exchange_s", "h2d_s",
                      "apply_s"):
                if k in r:
                    parts.setdefault(k, []).append(r[k])
    _mh_print(f"multihost {label}: step split, median over hosts and steps: "
              + ", ".join(f"{k[:-2]} {1e3 * statistics.median(v):.3f} ms"
                          for k, v in parts.items()))


def phase_multihost_inproc() -> dict:
    """smollm-135m at full width and depth (bf16), 3 host processes x 2
    ranks stacked on the card in this process (``InprocCluster``),
    ``phaser_scsl`` at both levels, 12 steps, ``join@4,fail:1@8``.
    Returns the kernels' launches in the run."""
    import torch
    import repro_torch.runtime_dist.coordinator as C
    from repro_torch.core.collective import PhaserCollective
    from repro_torch.kernels import bucket_combine as BC
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.obs import MetricsRegistry
    from repro_torch.runtime_dist import DistCoordinator, InprocCluster
    from repro_torch.utils import tree_map

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = DistCoordinator(InprocCluster(), MH_HOSTS, seed=0,
                         data_for=lambda pid: _mh_data(
                             MH_DEVICE, reduced=MH_REDUCED))
    dp0 = rt.cluster.agents[0]._dp
    api, cfg = dp0["api"], dp0["cfg"]
    _mh_print(f"multihost inproc: {MH_HOSTS} hosts booted with their data "
              f"planes in {time.perf_counter() - t0:.3f} s")
    flat_p, flat_gn = _mh_first_step_reference(dp0["params"], api, cfg)
    torch.cuda.empty_cache()

    # the level-1 exchange runs centrally in-process: time it and count
    # its bytes
    reg = MetricsRegistry()
    central = C.run_schedule_rounds
    ex_s = []

    def timed(sched, bufs, **kw):
        t = time.perf_counter()
        out = central(sched, bufs, metrics=reg)
        ex_s.append((time.perf_counter() - t, len(sched.rounds)))
        return out
    first = {}

    def keep_first(step):
        if step == 0:
            first["params"] = tree_map(torch.clone,
                                       rt.cluster.agents[0]._dp["params"])

    torch.cuda.synchronize()
    FA.flash_attention.launches = 0
    FA.flash_attention_bwd.launches = 0
    BC.bucket_combine.launches = 0
    C.run_schedule_rounds = timed
    try:
        t0 = time.perf_counter()
        rows = _mh_drive(rt, MH_STEPS, MH_CHURN, on_step=keep_first)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        C.run_schedule_rounds = central
    launches = {"flash_attention": FA.flash_attention.launches,
                "flash_attention_bwd": FA.flash_attention_bwd.launches,
                "bucket_combine": BC.bucket_combine.launches}
    local_rounds = len(PhaserCollective(MH_RANKS, "data",
                                        kind="phaser_scsl",
                                        seed=0).unified_schedule().rounds)
    # execute_flat: one launch a local round over the whole stacked buffer
    predicted = sum(len(live) for *_, live in rows) * local_rounds
    first_err = _rel_l2_tree(first["params"], flat_p)
    gn0 = rows[0][1][0]["gnorm"]
    losses = [sum(r["loss"] for r in out.values()) / len(out)
              for _, out, _, _, _ in rows]
    split = [len(set(pr.values())) for _, _, pr, _, _ in rows]
    sets = {}
    for e in rt.epochs:
        for p in e.live:
            sets.setdefault(p, set()).add(e.live)
    misses = {p: a._dp["cache"].stats()["misses"]
              for p, a in rt.cluster.agents.items()}
    want_misses = {p: len(sets[p]) for p in misses}
    events = [[e.step, e.kind, e.pid] for e in rt.events]
    dtype = str(cfg.dtype).split(".")[-1]
    _mh_print(f"multihost inproc: smollm-135m full width and depth "
              f"{dtype}, {MH_HOSTS} hosts x {MH_RANKS} ranks on one card, "
              f"{MH_B}x{MH_SEQ} tokens a rank, "
              f"{MH_STEPS} steps in {wall:.3f} s, {MH_CHURN}: epochs "
              f"{[list(e.live) for e in rt.epochs]}, events {events}; loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({[round(x, 4) for x in losses]}); launches {launches}; "
              f"bucket_combine launches {launches['bucket_combine']}, the "
              f"schedule predicts {predicted} (live hosts x {local_rounds} "
              f"local rounds a step); program-cache misses "
              f"{misses}, distinct process sets {want_misses}")
    _mh_print(f"multihost inproc: first step vs the flat program over "
              f"the same {MH_HOSTS * MH_RANKS} ranks and batches: "
              f"parameters relative L2 {first_err:.3e}, grad_norm "
              f"{gn0:.6f} vs {flat_gn:.6f}; loss "
              f"probes bitwise equal on every live host after each of the "
              f"{len(rows)} steps: {all(n == 1 for n in split)}")
    rounds = reg.snapshot()["counters"]
    mb = rounds.get("exchange.bytes_moved", 0) / max(
        1, rounds.get("exchange.rounds", 1))
    import statistics
    _mh_print(f"multihost inproc: level-1 exchange (central, host numpy): "
              f"median {statistics.median(s for s, _ in ex_s):.4f} s a step "
              f"over {ex_s[0][1]}-{ex_s[-1][1]} rounds, "
              f"{rounds.get('exchange.rounds', 0)} rounds moving "
              f"{mb / 1e6:.1f} MB a round on average; frame buffer "
              f"{dp0['cache'].programs()[0].layout.total_elems * 4} bytes")
    _mh_medians(rows, "inproc")
    _mh_split(rows, "inproc")
    if not all(math.isfinite(x) for x in losses):
        fail(f"multihost inproc: losses not all finite: {losses}")
    if events != [[4, "join", 3], [8, "fail", 1]]:
        fail(f"multihost inproc: events {events}")
    if not first_err <= MH_FIRST_TOL:
        fail(f"multihost inproc: first step's parameters {first_err} "
             "(relative L2) from the flat program's")
    if any(n != 1 for n in split):
        fail(f"multihost inproc: loss probes differ across hosts: "
             f"{[pr for _, _, pr, _, _ in rows]}")
    if launches["bucket_combine"] != predicted:
        fail(f"multihost inproc: {launches['bucket_combine']} "
             f"bucket_combine launches, the schedule predicts {predicted}")
    if not all(n > 0 for n in launches.values()):
        fail(f"multihost inproc: a kernel was never launched: {launches}")
    if misses != want_misses:
        fail(f"multihost inproc: program-cache misses {misses}, distinct "
             f"process sets {want_misses}")
    _mh_profile(rt)
    _mh_print(f"multihost inproc: peak card memory of the process (all "
              f"{len(rt.cluster.agents)} hosts) "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    rt.close()
    return launches


def _mh_profile(rt) -> None:
    """One more in-process step under torch.profiler: host wall against
    device busy, split into the hosts' local grads, local sync and
    update (``gradsync.*`` ranges)."""
    step = MH_STEPS
    wall, busy, spans, by_name, prof = profile_ranges(
        lambda: rt.train_step(step))
    rt.advance(step=step)
    parts = "; ".join(f"{k} x{v['count']} host {v['host_ms']:.3f} ms device "
                      f"{v['device_ms']:.3f} ms"
                      for k, v in sorted(spans.items()))
    _mh_print(f"profile multihost inproc step ({len(rt.live)} hosts x "
              f"{MH_RANKS} ranks): host wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / wall:.1f}%); {parts}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    with open(os.path.join(HERE, "chiprun_out", "multihost_profile.txt"),
              "w") as f:
        f.write(f"== multihost inproc step: wall {wall:.4f} ms, busy "
                f"{busy:.4f} ms\n{json.dumps(spans, indent=1)}\n"
                + "\n".join(f"{v:10.4f} ms  {k}" for k, v in top) + "\n")
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=60) + "\n")


def phase_multihost_socket() -> dict:
    """The same model and layout over real OS processes (``SocketCluster``,
    AF_UNIX; each worker its own CUDA context on the card): 8 steps,
    ``kill@5`` (SIGKILL). Returns the survivors' kernel launches."""
    import hashlib
    import numpy as np
    from repro_torch.runtime_dist import (DistCoordinator, SocketCluster,
                                          run_schedule_rounds)
    from repro_torch.runtime_dist.transport import _pack_frame

    cl = SocketCluster(hb_interval=MH_HB,
                       failure_timeout=MH_FAILURE_TIMEOUT)
    rt = None
    try:
        t0 = time.perf_counter()
        rt = DistCoordinator(
            cl, MH_HOSTS, seed=0, obs=True,
            data_for=lambda pid: _mh_data(MH_DEVICE, reduced=MH_REDUCED,
                                          steps=MH_SOCK_STEPS,
                                          keep_exchange=True))
        _mh_print(f"multihost socket: {MH_HOSTS} worker processes up with "
                  f"their data planes in {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        rows = _mh_drive(rt, MH_SOCK_STEPS, MH_SOCK_CHURN,
                         kill=cl.kill_pid)
        wall = time.perf_counter() - t0
        events = [[e.step, e.kind, e.pid] for e in rt.events]
        hists = rt.obs.merged_metrics()["hists"]
        det = hists.get("failure.detection_seconds", {})
        rec = hists.get("failure.recover_seconds", {})
        stats = {p: rt.cluster.call(p, {"op": "device_stats"})
                 for p in sorted(rt.live)}
        ex = {p: rt.cluster.call(p, {"op": "last_exchange"})
              for p in sorted(rt.live)}
    finally:
        # stops every worker process, whatever failed
        (rt or cl).close()
    losses = [sum(r["loss"] for r in out.values()) / len(out)
              for _, out, _, _, _ in rows]
    split = [len(set(pr.values())) for _, _, pr, _, _ in rows]
    kill_step = next(r for r in rows if r[0] == 5)
    # the level-1 exchange of the last step: the workers' peer-to-peer
    # rounds against the central executor on the same host buffers
    pids = ex[min(ex)]["pids"]
    from repro_torch.core.collective import PhaserCollective
    sched = PhaserCollective(len(pids), "data", kind="phaser_scsl",
                             seed=0, keys=tuple(pids)).unified_schedule()
    central = run_schedule_rounds(sched, {p: ex[p]["local"] for p in pids})
    same = all(hashlib.sha256(central[p].view(np.uint8)).hexdigest()
               == ex[p]["reduced_sha256"] for p in pids)
    buf = ex[pids[0]]["local"]
    t = time.perf_counter()
    frame = len(_pack_frame(0, 0, "red", (0, 0, 0, buf)))
    pack_s = time.perf_counter() - t
    launches = {}
    for s in stats.values():
        for k, v in s["launches"].items():
            launches[k] = launches.get(k, 0) + v
    _mh_print(f"multihost socket: smollm-135m full width and depth, "
              f"{MH_HOSTS} worker processes x {MH_RANKS} ranks on one card, "
              f"{MH_SOCK_STEPS} steps in {wall:.3f} s, {MH_SOCK_CHURN}: "
              f"events {events}; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({[round(x, 4) for x in losses]}); the killed step took "
              f"{kill_step[3]:.3f} s; detection "
              f"{det.get('total', math.nan):.3f} s of silence (failure "
              f"timeout {MH_FAILURE_TIMEOUT} s), recovery "
              f"{rec.get('total', math.nan):.3f} s; survivors' loss probes "
              f"bitwise equal after every step: {all(n == 1 for n in split)}")
    _mh_print(f"multihost socket: level-1 exchange of step "
              f"{ex[pids[0]]['step']} over {len(sched.rounds)} rounds, "
              f"peer-to-peer vs central on the same card-produced host "
              f"buffers: bitwise equal (SHA-256) {same}; a round "
              f"moves {buf.nbytes} bytes, one frame {frame} bytes (pickle + "
              f"CRC32 in {pack_s:.3f} s)")
    for p, s in sorted(stats.items()):
        _mh_print(f"multihost socket: worker {p} peak card memory "
                  f"{s['peak_bytes'] / 2**30:.3f} GiB, launches "
                  f"{s['launches']}")
    _mh_medians(rows, "socket")
    _mh_split(rows, "socket")
    if not all(math.isfinite(x) for x in losses):
        fail(f"multihost socket: losses not all finite: {losses}")
    if events != [[5, "dead", 2]]:
        fail(f"multihost socket: events {events}")
    if [len(live) for *_, live in rows] != [3] * 5 + [2] * 3:
        fail(f"multihost socket: hosts a step "
             f"{[live for *_, live in rows]}")
    if any(n != 1 for n in split):
        fail(f"multihost socket: loss probes differ across hosts: "
             f"{[pr for _, _, pr, _, _ in rows]}")
    if not same:
        fail("multihost socket: the peer-to-peer exchange differs from the "
             "central executor's on the same buffers")
    if not all(launches.get(k, 0) > 0 for k in
               ("flash_attention", "flash_attention_bwd", "bucket_combine")):
        fail(f"multihost socket: a kernel was never launched: {launches}")
    return launches

# ------------------------------------------------- the remaining families
MIXTRAL, LLAMA4, WHISPER, LLAVA = ("mixtral-8x7b", "llama4-scout-17b-a16e",
                                   "whisper-small", "llava-next-34b")
# depth on the card (full width): the model's bf16 weights at that depth
# take the rest of the 80 GB with room for the run (PERF.md section 4)
FAM_DEPTH = {MIXTRAL: 8, LLAVA: 16, LLAMA4: 2, "qwen2-72b": 4}
# a full-width bf16 model's prefill logits against its decode of the same
# position through the cache: relative L2, the two paths rounding at
# other points (PERF.md section 4)
FAM_BF16_BOUND = 5e-2
AUX_TOL = 1e-5
# the attention kernels in bf16 at the families' shapes, beside TOL's
# absolute 2e-2 (about a typical output there): the largest over output
# rows of |got - want| / |want| (L2 over a row's hd values), a few times
# the sound bf16 error (PERF.md section 6; ``--planted`` shows what it
# catches)
FAM_ROW_TOL = 1e-2


def _rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _family_batch(api, B, S, seed, device="cuda"):
    """``api.make_inputs`` of a prefill of B x S positions (VLM: 576 of
    them patches, enc-dec: 1500 frames beside), made from ``seed`` on
    ``device``."""
    from repro_torch.configs import ShapeConfig
    return api.make_inputs(ShapeConfig("prefill", S, B, "prefill"),
                           seed=seed, device=device)


def phase_families_reference() -> None:
    """Reduced mixtral, llama4-scout (top-1 of 16 experts), whisper and
    llava in f32, the kernels on the card against the plain versions on
    the CPU from the same parameters: prefill logits and 24 decode steps
    (past the window: mixtral's ring wraps) within 1e-4, whisper's with
    the prefill's cross K/V; the MoE aux loss within 1e-5; both attention
    kernels launched on the card."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_api, get_config

    # the family phases' profiles append to one file
    open(os.path.join(HERE, "chiprun_out", "families_profile.txt"),
         "w").close()
    for name, over in ((MIXTRAL, {}), (LLAMA4, {"n_experts": 16}),
                       (WHISPER, {}), (LLAVA, {})):
        cfg = get_config(name).reduced(moe_group_size=16, **over)
        api = get_api(cfg)
        params = api.init_params(torch.Generator("cpu").manual_seed(0),
                                 "cpu")
        outs, aux = {}, {}
        batch = _family_batch(api, 2, 13 + cfg.vision_tokens, 1, "cpu")
        for dev in ("cpu", "cuda"):
            p = _to(params, dev)
            b = _to(batch, dev)
            if dev == "cuda":
                torch.cuda.synchronize()
                FA.flash_attention.launches = 0
                FD.flash_decode.launches = 0
            logits, caches = api.prefill_full_fn(p, b)
            if cfg.family == "moe":
                aux[dev] = transformer.forward(cfg, p, b["tokens"])[1]
            state = api.init_decode_state(2, 20, dev)
            if cfg.is_encdec:
                state["cross_k"].copy_(caches["cross_k"])
                state["cross_v"].copy_(caches["cross_v"])
            got = [logits]
            for s in range(24):
                t = torch.tensor([s, s + 1], dtype=torch.int32, device=dev)
                lg, state = api.decode_fn(p, state, {
                    "token": b["tokens"][:, s % 13], "t": t})
                got.append(lg)
            outs[dev] = got + [state["layers"]["k"]]
        launches = (FA.flash_attention.launches, FD.flash_decode.launches)
        worst = 0.0
        for a, c in zip(outs["cpu"], outs["cuda"]):
            if not torch.isfinite(c).all():
                fail(f"families reference {name}: non-finite on the card")
            worst = max(worst, (a - c.cpu()).abs().max().item())
        e_aux = (abs(aux["cpu"].item() - aux["cuda"].item()) if aux
                 else 0.0)
        print(f"families reference: reduced {name} f32, card vs CPU plain: "
              f"max_abs_err={worst:.3e}, aux err {e_aux:.3e}; launches "
              f"flash_attention {launches[0]}, flash_decode {launches[1]}")
        if not worst <= TOL["float32"]:
            fail(f"families reference {name}: card and CPU disagree by "
                 f"{worst}")
        if not e_aux <= AUX_TOL:
            fail(f"families reference {name}: aux loss err {e_aux}")
        if not min(launches) > 0:
            fail(f"families reference {name}: launches {launches}")


def _row_err(got, want) -> float:
    """The largest over output rows (one query's last-dim values) of
    |got - want|_2 / |want|_2."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1)
            / want.norm(dim=-1).clamp_min(1e-30)).max().item()


def _fam_attn_inputs(gen, B, H, Kh, Sq, Sk, hd, dtype):
    import torch
    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda")
    k = torch.randn((B, Sk, Kh, hd), generator=gen, device="cuda")
    v = torch.randn((B, Sk, Kh, hd), generator=gen, device="cuda")
    return [t.to(dtype).transpose(1, 2) for t in (q, k, v)]


def _fam_decode_inputs(gen, B, H, Kh, W, hd, L, mask, dtype):
    """q, the L layers' (k, v) cache views and the validity mask: all
    valid, or a ring with random holes."""
    import torch
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((L, B, W, Kh, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((L, B, W, Kh, hd), generator=gen, device="cuda").to(dtype)
    if mask == "all":
        valid = torch.ones((B, W), dtype=torch.int32, device="cuda")
    else:
        valid = torch.randint(0, 2, (B, W), generator=gen, device="cuda",
                              dtype=torch.int32)
    views = [(k[l].permute(0, 2, 1, 3), v[l].permute(0, 2, 1, 3))
             for l in range(L)]
    return q, views, valid


def _fam_errors(kernel, ins, causal=None, win=None):
    """(max abs err, ``_row_err``) of one flash_attention (q, k, v) or
    flash_decode (q, k, v, valid) call against its plain version."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    if kernel == "flash_attention":
        got = FA.flash_attention(*ins, causal=causal, sliding_window=win)
        want = FA.attention_ref(*ins, causal=causal, sliding_window=win)
    else:
        got = FD.flash_decode(*ins)
        want = FD.decode_ref(*ins)
    torch.cuda.synchronize()
    return (got.float() - want.float()).abs().max().item(), _row_err(got,
                                                                     want)


def _fam_held(name: str, e_abs: float, e_row: float) -> bool:
    """f32 within TOL; bf16 within TOL and FAM_ROW_TOL."""
    return e_abs <= TOL[name] and (name == "float32" or e_row <= FAM_ROW_TOL)


# (label, B, H, Kh, Sq, Sk, hd, window, causal)
FAM_ATTN = (
    ("mixtral prefill, window 4096", 1, 32, 8, 4608, 4608, 128, 4096, True),
    ("llava g=7", 2, 56, 8, 1088, 1088, 128, None, True),
    ("whisper cross", 4, 12, 12, 448, 1500, 64, None, False),
    ("whisper encoder", 4, 12, 12, 1500, 1500, 64, None, False),
)
# (label, B, H, Kh, W, hd, layers cycled, mask)
FAM_DECODE = (
    ("mixtral ring", 4, 32, 8, 4096, 128, 8, "ring"),
    ("whisper cross", 4, 12, 12, 1500, 64, 12, "all"),
)


def phase_families_parity():
    """Both attention kernels at the new families' shapes against their
    plain versions, f32 within 1e-4 and bf16 within 2e-2 absolute and
    ``FAM_ROW_TOL`` of each output row: the forward at hd 128 over S 4608
    with mixtral's window of 4096, at g = 7 (llava), whisper's non-causal
    cross-attention (Sq 448, Sk 1500) and encoder (S 1500); the decode
    over mixtral's 4096-slot ring (holes, g = 4) and over whisper's 1500
    cross keys, all valid (g = 1). Then each timed in bf16 beside its
    plain version, SDPA and its bound; returns the rows."""
    import torch

    gen = torch.Generator("cuda").manual_seed(5)
    rows = []
    for label, B, H, Kh, Sq, Sk, hd, win, causal in FAM_ATTN:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            q, k, v = _fam_attn_inputs(gen, B, H, Kh, Sq, Sk, hd, dtype)
            err, row = _fam_errors("flash_attention", (q, k, v), causal, win)
            print(f"parity flash_attention {name} {label} (B={B} H={H} "
                  f"Kh={Kh} Sq={Sq} Sk={Sk} hd={hd} window={win} "
                  f"causal={causal}): max_abs_err={err:.3e}, largest row "
                  f"error {row:.3e}")
            if not _fam_held(name, err, row):
                fail(f"flash_attention {name} {label}: err {err}, row {row}")
        shape = (f"B={B} H={H} Kh={Kh} Sq={Sq} Sk={Sk} hd={hd} bf16 "
                 f"{'causal' if causal else 'not causal'}"
                 f"{f' window {win}' if win else ''} ({label})")
        rows.append(_attn_row(q, k, v, causal, win, err, shape))
        del q, k, v
        torch.cuda.empty_cache()
    for label, B, H, Kh, W, hd, L, mask in FAM_DECODE:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            q, views, valid = _fam_decode_inputs(gen, B, H, Kh, W, hd, L,
                                                 mask, dtype)
            err, row = _fam_errors("flash_decode", (q, *views[0], valid))
            print(f"parity flash_decode {name} {label} (B={B} H={H} Kh={Kh}"
                  f" W={W} hd={hd}, {mask}): max_abs_err={err:.3e}, largest "
                  f"row error {row:.3e}")
            if not _fam_held(name, err, row):
                fail(f"flash_decode {name} {label}: err {err}, row {row}")
        rows.append(_decode_row(q, views, valid, err,
                                f"B={B} H={H} Kh={Kh} W={W} hd={hd} bf16 "
                                f"({label}, {L} layers' caches cycled)"))
        del q, views, valid
        torch.cuda.empty_cache()
    for r in rows:
        print_timing(r)
    return rows


# faults planted in the bf16 kernels' sources (``--planted``): the last
# partial key tile dropped, the window one key wider
PLANTED = {
    "flash_attention": {
        "tail_dropped": [("int kt_end = (Sk + BKV - 1) / BKV;",
                          "int kt_end = Sk / BKV;")],
        "window_plus_one": [("(window > 0 && qpos - kpos >= window))",
                             "(window > 0 && qpos - kpos > window))")],
    },
    "flash_decode": {
        "tail_dropped": [("const int ntiles = (a.W + TILE - 1) / TILE;",
                          "const int ntiles = a.W / TILE;")],
    },
}


def planted() -> int:
    """The bf16 check of the families' shapes against faults planted in
    the kernels' sources: each variant of ``PLANTED`` is compiled
    (``tools/source_variants.py``) and swapped in for the wrapper's bf16
    entry point, and must fail ``FAM_ROW_TOL`` at one shape at least;
    each shape's reading under TOL's absolute 2e-2 is printed beside.
    The kernels as built must hold both."""
    import ctypes
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from source_variants import build_variants

    bf16 = torch.bfloat16
    main_fns = {"flash_attention": FA._kernel("flash_attention", bf16),
                "flash_decode": FD._kernel(bf16)}

    def swap(kernel, fn):
        if kernel == "flash_attention":
            FA._fns["flash_attention"][bf16] = fn
        else:
            FD._lib[bf16] = fn

    gen = torch.Generator("cuda").manual_seed(5)
    cases = {"flash_attention": [
        (label, _fam_attn_inputs(gen, B, H, Kh, Sq, Sk, hd, bf16),
         causal, win)
        for label, B, H, Kh, Sq, Sk, hd, win, causal in FAM_ATTN],
        "flash_decode": []}
    for label, B, H, Kh, W, hd, _, mask in FAM_DECODE:
        q, views, valid = _fam_decode_inputs(gen, B, H, Kh, W, hd, 1, mask,
                                             bf16)
        cases["flash_decode"].append((label, (q, *views[0], valid), None,
                                      None))
    caught = {}
    for kernel, edits in PLANTED.items():
        entry = f"{kernel}_bf16"
        fns = {"as built": main_fns[kernel]}
        for var, (fn, _) in build_variants(kernel, edits, entry,
                                           lambda log: None).items():
            fn.argtypes = main_fns[kernel].argtypes
            fn.restype = ctypes.c_int
            fns[var] = fn
        for var, fn in fns.items():
            swap(kernel, fn)
            missed = []
            for label, ins, causal, win in cases[kernel]:
                e_abs, e_row = _fam_errors(kernel, ins, causal, win)
                held = _fam_held("bfloat16", e_abs, e_row)
                old = "within" if e_abs <= TOL["bfloat16"] else "past"
                print(f"planted {kernel} {var}, {label}: max_abs_err="
                      f"{e_abs:.3e} ({old} 2e-2 alone), largest row error "
                      f"{e_row:.3e} ({'holds' if held else 'fails'} the "
                      f"check)")
                if not held:
                    missed.append(label)
            caught[f"{kernel} {var}"] = missed
        swap(kernel, main_fns[kernel])
    print(json.dumps({"planted": caught, "row_tol": FAM_ROW_TOL}))
    for var, missed in caught.items():
        if var.endswith("as built") and missed:
            fail(f"planted: {var} fails the check at {missed}")
        if not var.endswith("as built") and not missed:
            fail(f"planted: {var} holds the check at every shape")
    print("planted: every planted fault fails the bf16 check, the kernels "
          "as built hold it")
    return 0


def _free() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _build(name: str, layers=None):
    """(api, params): ``name`` at full width, bf16, ``layers`` deep
    (default: whole), random weights from a seeded generator."""
    import dataclasses
    import torch
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.utils import tree_flatten
    cfg = get_config(name)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    api = get_api(cfg)
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator("cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_flatten(params)[1])
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_flatten(params)[1])
    print(f"{name}: full width (d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"/ {cfg.n_kv_heads} KV, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}), {cfg.n_layers} layers"
          f"{f' of {get_config(name).n_layers}' if layers else ''}: {n} "
          f"parameters, {nbytes / 1e9:.2f} GB, built in "
          f"{time.perf_counter() - t0:.2f} s")
    return api, params


def _fam_profile(label: str, fn) -> dict:
    """One call of ``fn`` under the profiler with its attention and MoE
    layers marked (``fam.`` ranges): host wall against device busy, and
    the device time of the ranges and of the port's attention kernels. A
    profile counts only if it holds as many launches of each attention
    kernel as the wrappers counted in that call; after ``PROFILE_TRIES``
    that do not, the run fails. The ranges wrap the model's functions
    for the profiled call only: a range in the model itself would cost
    every decode step its host time."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import encdec as ED
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF

    saved = {}

    def mark(mod, fname, rng):
        f = getattr(mod, fname)
        saved[(mod, fname)] = f

        def run(*a, **k):
            with torch.profiler.record_function(rng):
                return f(*a, **k)
        setattr(mod, fname, run)
    mark(MOE, "moe_apply", "fam.moe")
    mark(TF, "mlp_apply", "fam.mlp")
    mark(ED, "mlp_apply", "fam.mlp")
    for fname in ("attention", "decode_attention", "cross_attention"):
        mark(A, fname, "fam.attention")
    try:
        fn()
        torch.cuda.synchronize()
        for attempt in range(1, PROFILE_TRIES + 1):
            _zero_launches()
            wall, busy, spans, by_name, prof = profile_ranges(
                fn, ranges=("fam.",))
            # the wrappers' launches in this call, each of which the
            # profile must hold
            want = _launches()
            names = [n for n, _ in cuda_kernels(prof)]
            seen = {k: sum(any(m in n for m in marks) for n in names)
                    for k, marks in FAM_KERNELS.items()}
            if busy > 0 and spans and seen == want:
                break
            print(f"_fam_profile: profile {attempt} of {PROFILE_TRIES} of "
                  f"{label} recorded launches {seen}, ranges "
                  f"{sorted(spans)}; the wrappers launched {want}")
        else:
            fail(f"{label}: {PROFILE_TRIES} profiles lost their records")
    finally:
        for (mod, fname), f in saved.items():
            setattr(mod, fname, f)
    attn = sum(v for k, v in by_name.items()
               if any(m in k for m in PORT_KERNELS["attention"]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    parts = "; ".join(f"{k} x{v['count']} device {v['device_ms']:.3f} ms"
                      for k, v in sorted(spans.items()))
    print(f"profile {label}: host wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f}%), port attention "
          f"kernels {attn:.3f} ms; {parts}; top: "
          + "; ".join(f"{k[:40]} {v:.3f}" for k, v in top[:4]))
    with open(os.path.join(HERE, "chiprun_out", "families_profile.txt"),
              "a") as f:
        f.write(f"== {label}: wall {wall:.4f} ms, busy {busy:.4f} ms\n"
                f"{json.dumps(spans, indent=1)}\n"
                + "\n".join(f"{v:10.4f} ms  {k}" for k, v in top) + "\n\n")
    return {"wall_ms": wall, "busy_ms": busy}


# the CUDA functions one call of each attention wrapper launches once
FAM_KERNELS = {"flash_attention": ("attn_kernel",) + ATTN_FWD_BF16,
               "flash_decode": DECODE}


def _launches():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    return {"flash_attention": FA.flash_attention.launches,
            "flash_decode": FD.flash_decode.launches}


def _zero_launches() -> None:
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import flash_decode as FD
    torch.cuda.synchronize()
    FA.flash_attention.launches = 0
    FD.flash_decode.launches = 0


def phase_mixtral_serve() -> dict:
    """mixtral-8x7b at full width, 8 of 32 layers, bf16, through
    ``ServeEngine`` (4 slots, window 4096 = its sliding window, so the
    cache is a 4096-slot ring): 8 prompts of 512..4000 tokens through
    bulk KV admission, 64 new tokens each, and one of 4000 tokens with 160
    new, whose decode wraps the ring. Every request drained with
    in-vocabulary tokens, 9 bulk admissions, both kernels launched, the
    ring wrapped; a profiled decode step and admission prefill."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import Request, ServeEngine

    api, params = _build(MIXTRAL, FAM_DEPTH[MIXTRAL])
    cfg = api.cfg
    eng = ServeEngine(api, params, batch=4, window=4096)
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(512, 4001, 8)] + [4000]
    max_new = [64] * 8 + [160]
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new=m)
            for i, (n, m) in enumerate(zip(lengths, max_new))]
    for r in reqs:
        eng.submit(r)
    spent = [0.0]
    bulk = eng._admit_bulk

    def timed(*args):
        t = time.perf_counter()
        bulk(*args)
        spent[0] += time.perf_counter() - t
    eng._admit_bulk = timed
    _zero_launches()
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    if not all(r.done and len(r.out) == r.max_new for r in reqs):
        fail("mixtral serve: not every request finished")
    if not all(0 <= tok < cfg.vocab_size for r in reqs for tok in r.out):
        fail("mixtral serve: a token outside the vocabulary")
    if not min(launches.values()) > 0:
        fail(f"mixtral serve: a kernel was never launched: {launches}")
    counters = eng.metrics.snapshot()["counters"]
    if counters.get("serve.admit.kv") != len(reqs):
        fail(f"mixtral serve: admissions {counters}")
    # the last request decoded past position 4096: its slot's ring holds
    # positions beyond the window
    top = int(eng.state["layers"]["pos"].max())
    if not 4096 <= top < lengths[-1] + max_new[-1]:
        fail(f"mixtral serve: the ring did not wrap (largest position "
             f"{top})")
    dec = eng.metrics.snapshot()["hists"]["serve.decode.token_seconds"]
    decoded = sum(len(r.out) - 1 for r in reqs)
    print(f"mixtral serve: {MIXTRAL} full width, {cfg.n_layers} layers, "
          f"bf16, batch 4, 4096-slot ring: {len(reqs)} requests (prompts "
          f"{lengths}, {sum(lengths)} prompt tokens) in {wall:.3f} s: bulk "
          f"admission {spent[0]:.3f} s ({sum(lengths) / spent[0]:.1f} prompt "
          f"tok/s); {dec['count']} decode steps {dec['total']:.3f} s "
          f"({1e3 * dec['total'] / dec['count']:.3f} ms/step, "
          f"{decoded / dec['total']:.1f} tok/s); the ring wrapped (largest "
          f"position {top}); launches {launches}; counters "
          f"{ {k: v for k, v in counters.items() if 'admit' in k} }")
    B = eng.batch
    tok = torch.zeros((B,), dtype=torch.int32, device="cuda")
    t = torch.full((B,), 4200, dtype=torch.int32, device="cuda")
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 4096)),
                          device="cuda")
    _fam_profile("mixtral decode step (batch 4, ring full)",
                 lambda: api.decode_fn(params, eng.state,
                                       {"token": tok, "t": t}))
    _fam_profile("mixtral admission prefill 4x4096",
                 lambda: api.prefill_full_fn(params, {"tokens": prompt}))
    del eng, params, api
    _free()
    return launches


def _prefill_then_decode(api, params, batch, n_dec, window, label):
    """``prefill_full_fn`` over ``batch``, the prefill's KV of all but the
    last position spliced into a decode state (enc-dec: its cross K/V,
    the decoder's prompt decoded from position 0), the last prompt token
    decoded through the cache and held against the prefill's last logits
    (relative L2, ``FAM_BF16_BOUND``; MoE excepted: a prefill token's
    experts depend on its group's capacity), then ``n_dec`` greedy decode
    steps. Returns (the decode state, prefill s, decode s a step,
    launches)."""
    import torch
    cfg = api.cfg
    B, S = batch["tokens"].shape
    _zero_launches()
    t0 = time.perf_counter()
    logits, caches = api.prefill_full_fn(params, batch)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    n = logits.shape[1]
    if tuple(logits.shape) != (B, n, cfg.vocab_size) \
            or not torch.isfinite(logits[:, -1].float()).all():
        fail(f"{label}: prefill logits {tuple(logits.shape)} not finite")
    state = api.init_decode_state(B, window, "cuda")
    if cfg.is_encdec:
        state["cross_k"].copy_(caches["cross_k"])
        state["cross_v"].copy_(caches["cross_v"])
        start = 0
    else:
        st = state["layers"]
        for leaf in ("k", "v"):
            st[leaf][:, :, :n - 1] = caches["layers"][leaf][:, :, :n - 1]
        st["pos"][:, :, :n - 1] = torch.arange(n - 1, dtype=torch.int32,
                                               device="cuda")
        start = n - 1
    del caches
    tok = batch["tokens"][:, 0 if cfg.is_encdec else -1]
    rel = None
    for i in range(start, n):
        t = torch.full((B,), i, dtype=torch.int32, device="cuda")
        lg, state = api.decode_fn(params, state, {"token": tok, "t": t})
        if cfg.is_encdec and i + 1 < n:
            tok = batch["tokens"][:, i + 1]
    if cfg.family != "moe":
        rel = _rel_l2(lg, logits[:, -1])
        if not rel <= FAM_BF16_BOUND:
            fail(f"{label}: decode through the cache vs prefill logits "
                 f"relative L2 {rel}")
    del logits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n, n + n_dec):
        tok = torch.argmax(lg, dim=-1)
        t = torch.full((B,), i, dtype=torch.int32, device="cuda")
        lg, state = api.decode_fn(params, state, {"token": tok, "t": t})
        if not torch.isfinite(lg.float()).all():
            fail(f"{label}: non-finite decode logits at position {i}")
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / n_dec
    launches = _launches()
    if not min(launches.values()) > 0:
        fail(f"{label}: a kernel was never launched: {launches}")
    rel_s = "not compared (MoE capacity)" if rel is None else f"{rel:.3e}"
    print(f"{label}: prefill {B}x{n} positions {1e3 * t_pre:.3f} ms, "
          f"decode {1e3 * t_dec:.3f} ms a step ({n_dec} steps, batch {B}); "
          f"last prompt token through the cache vs prefill logits relative "
          f"L2 {rel_s} (bound {FAM_BF16_BOUND}); launches {launches}")
    return state, t_pre, t_dec, launches


def phase_whisper() -> dict:
    """whisper-small whole (12 + 12 layers), bf16: 4 requests of 1500
    frames, the prefill (encode, then the decoder over a 4-token prompt)
    through ``prefill_full_fn``, its cross K/V copied into the decode
    state, the prompt decoded from position 0 (the last token's logits
    against the prefill's), then 64 greedy decode tokens each; encode
    timed alone; a profiled decode step."""
    import torch
    from repro_torch.models import encdec

    api, params = _build(WHISPER)
    cfg = api.cfg
    batch = _family_batch(api, 4, 4, seed=6)
    encdec.encode(cfg, params, batch["frames"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = encdec.encode(cfg, params, batch["frames"])
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    if tuple(enc.shape) != (4, 1500, cfg.d_model) \
            or not torch.isfinite(enc.float()).all():
        fail(f"whisper: encoder output {tuple(enc.shape)}")
    del enc
    state, _, t_dec, launches = _prefill_then_decode(
        api, params, batch, 64, 128, "whisper")
    tok = torch.zeros((4,), dtype=torch.int32, device="cuda")
    t = torch.full((4,), 60, dtype=torch.int32, device="cuda")
    prof = _fam_profile("whisper decode step (batch 4, 1500 cross keys)",
                        lambda: api.decode_fn(params, state,
                                              {"token": tok, "t": t}))
    print(f"whisper: encode 4x1500 frames {1e3 * t_enc:.3f} ms, decode "
          f"{1e3 * t_dec:.3f} ms a step, device busy "
          f"{100 * prof['busy_ms'] / prof['wall_ms']:.1f}% of a profiled "
          f"step")
    del state, params, api
    _free()
    return launches


def phase_llava() -> dict:
    """llava-next-34b at full width, 16 of 60 layers, bf16: 2 requests of
    576 patch embeddings + 512 tokens through ``prefill_full_fn``, the
    KV of the first 1087 positions spliced into the decode state, the
    last prompt token decoded at 1087 (against the prefill's logits),
    then 32 greedy steps from position 1088; a profiled decode step."""
    import torch

    api, params = _build(LLAVA, FAM_DEPTH[LLAVA])
    batch = _family_batch(api, 2, 576 + 512, seed=7)
    state, t_pre, t_dec, launches = _prefill_then_decode(
        api, params, batch, 32, 1152, "llava")
    tok = torch.zeros((2,), dtype=torch.int32, device="cuda")
    t = torch.full((2,), 1100, dtype=torch.int32, device="cuda")
    prof = _fam_profile("llava decode step (batch 2, 1100 positions)",
                        lambda: api.decode_fn(params, state,
                                              {"token": tok, "t": t}))
    print(f"llava: prefill 2x(576+512) {1e3 * t_pre:.3f} ms, decode "
          f"{1e3 * t_dec:.3f} ms a step, device busy "
          f"{100 * prof['busy_ms'] / prof['wall_ms']:.1f}% of a profiled "
          f"step")
    del state, params, api
    _free()
    return launches


def phase_config_sweep() -> dict:
    """llama4-scout (2 of 48 layers), qwen2-72b (4 of 80), granite-3-2b
    and qwen2.5-3b (whole), full width, bf16: one prefill of 1024 tokens
    and 8 decode steps each, finite logits, both kernels launched (the
    dense configs' last prompt token through the cache against the
    prefill's logits). Each model is freed before the next is built."""
    total = {"flash_attention": 0, "flash_decode": 0}
    for name in (LLAMA4, "qwen2-72b", "granite-3-2b", "qwen2.5-3b"):
        api, params = _build(name, FAM_DEPTH.get(name))
        batch = _family_batch(api, 1, 1024, seed=8)
        state, _, _, launches = _prefill_then_decode(
            api, params, batch, 8, 1040, f"sweep {name}")
        for k, v in launches.items():
            total[k] += v
        del state, params, api, batch
        _free()
    return total


# --------------------------------------------------- dry-run vs the card
# measured peak bytes over the dry-run's prediction for the same rank's
# step (PERF.md section 6 derives it from the allocator's rounding and
# the kernels' workspaces)
DRYRUN_PEAK_BAND = (0.95, 1.10)
DRYRUN_STEPS = 5
DRYRUN_DEVICE = "cuda"           # a CPU rehearsal sets "cpu"
FLAT_SHAPE = (2055, 65536)       # the multi-host flat buffer, f32


def phase_dryrun_check() -> dict:
    """29. The dry-run of smollm-135m x train_4k (dp over model, 16x16)
    held against rank 0's program on the card; then int8 compression on
    the card against the CPU, and the perf sentry. Returns the step's
    launches."""
    import gc
    import statistics
    import torch
    from repro_torch.configs import SHAPES_BY_NAME, ShapeConfig
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import meta
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HW
    from repro_torch.models.registry import get_api, get_config
    from repro_torch.optim import AdamW
    from repro_torch.optim import compression as comp
    from repro_torch.roofline.analytical import analytic_terms
    from repro_torch.train.step import build_train_step

    t0 = time.perf_counter()
    res = dryrun.run_cell("smollm-135m", "train_4k", dp_over_model=True)
    if res["status"] != "ok":
        fail(f"dryrun: {res.get('error')}\n{res.get('trace', '')}")
    t_trace = time.perf_counter() - t0
    cfg = get_config("smollm-135m")
    shape = SHAPES_BY_NAME["train_4k"]
    pred_flops = res["roofline"]["flops"] / 256
    bound = analytic_terms(cfg, shape, HW, chips=256, tp=1)

    api, opt = get_api(cfg), AdamW()
    step = build_train_step(api, opt, remat=True)
    dev = DRYRUN_DEVICE
    params = api.init_params(torch.Generator(dev).manual_seed(0), dev)
    opt_state = opt.init(params)
    batch = api.make_inputs(ShapeConfig("rank", shape.seq_len, 1, "train"),
                            seed=0, device=dev)
    # one step first: kernel loads and the cuBLAS workspace are set-up;
    # its garbage collected, so none is freed inside the measured step
    params, opt_state, _ = step.fn(params, opt_state, batch)
    gc.collect()
    torch.cuda.synchronize()
    args = sum(t.numel() * t.element_size() for t in
               dryrun._tensors((params, opt_state, batch)))
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention.launches = 0
    FA.flash_attention_bwd.launches = 0
    ledger = dryrun.Ledger((params, opt_state, batch))
    with meta.count_work() as work, ledger:
        new_p, new_o, m = step.fn(params, opt_state, batch)
        del new_p, new_o
    torch.cuda.synchronize()
    measured = args + torch.cuda.max_memory_allocated() - held
    launches = {"flash_attention": FA.flash_attention.launches,
                "flash_attention_bwd": FA.flash_attention_bwd.launches}
    counted = ledger.flops.get_total_flops() + sum(
        w["flops"] for w in work.values())
    loss = m["loss"].item()
    ledger_peak = ledger.peak
    del ledger, m
    dts = []
    for _ in range(DRYRUN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = step.fn(params, opt_state, batch)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t1)
        del out
    med = statistics.median(dts)
    ratio = measured / res["peak_bytes"]
    print(f"dryrun: smollm-135m x train_4k, dp over model on 16x16, rank 0 "
          f"traced in {t_trace:.1f} s; predicted peak {res['peak_bytes']} "
          f"bytes (arguments {res['argument_bytes']}), measured on the "
          f"card {measured} (arguments {args}, held before the step "
          f"{held}, the step's own "
          f"{measured - args} against {res['bytes_per_device']} "
          f"predicted): measured/predicted {ratio:.4f}, band "
          f"{DRYRUN_PEAK_BAND}")
    print(f"dryrun: FLOPs a step predicted {pred_flops:.6e}, counted on the "
          f"card {counted:.6e} (ratio {counted / pred_flops:.6f}; kernels "
          f"{ {k: w['flops'] for k, w in work.items()} }); the same "
          f"ledger over the card's tensors: the step's own peak "
          f"{ledger_peak} bytes")
    print(f"dryrun: median step {med:.4f} s over {DRYRUN_STEPS} (all "
          f"{[round(x, 4) for x in dts]}), analytic per-GPU bound "
          f"{bound['step_time']:.4f} s ({bound['bottleneck']}; compute "
          f"{bound['t_compute']:.4f}, memory {bound['t_memory']:.4f}, "
          f"collective {bound['t_collective']:.4f}), "
          f"{med / bound['step_time']:.2f}x the bound; loss {loss:.4f}; "
          f"launches {launches}")
    if not DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1]:
        fail(f"dryrun: measured/predicted peak {ratio} outside "
             f"{DRYRUN_PEAK_BAND}")
    if not all(n > 0 for n in launches.values()):
        fail(f"dryrun: an attention kernel was not launched: {launches}")
    if not math.isfinite(loss):
        fail(f"dryrun: loss {loss}")
    del params, opt_state, batch
    torch.cuda.empty_cache()

    # int8 compression with error feedback at the flat buffer's shape
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(FLAT_SHAPE, generator=gen) * 1e-2
    r0 = torch.randn(FLAT_SHAPE, generator=gen) * 1e-5
    q_c, s_c, st_c = comp.compress(g, comp.EFState(residual=r0))
    gd, rd = g.to(dev), r0.to(dev)
    q_d, s_d, st_d = comp.compress(gd, comp.EFState(residual=rd))
    torch.cuda.synchronize()
    x = (g + r0) / s_c
    tie = (x - x.floor() - 0.5).abs() <= torch.finfo(torch.float32).eps \
        * x.abs().clamp_min(1.0)
    s_err = abs(s_d.item() - s_c.item()) / s_c.item()
    q_bad = int(((q_d.cpu() != q_c) & ~tie).sum())
    r_err = (st_d.residual.cpu() - st_c.residual).abs().max().item()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        q, s, _ = comp.compress(gd, comp.EFState(residual=rd))
        comp.decompress(q, s)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 10
    print(f"compression: {FLAT_SHAPE} f32 on the card vs the CPU: scale "
          f"rel err {s_err:.3e}, q mismatches off the .5 ties {q_bad} "
          f"({int(tie.sum())} ties), residual max err {r_err:.3e}; "
          f"compress + decompress "
          f"{ms:.4f} ms on the card ({4 * g.numel() / 1e6:.1f} MB f32 -> "
          f"{comp.compressed_bytes(g)[1] / 1e6:.1f} MB int8)")
    if not (s_err <= 1e-7 and q_bad == 0 and r_err <= 1e-6):
        fail("compression: the card disagrees with the CPU")
    del gd, rd, q_d, st_d, q, s

    r = subprocess.run([sys.executable, "-m", "repro_torch.obs.regress",
                        "--fresh", HERE], capture_output=True, text=True,
                       timeout=120, cwd=HERE,
                       env=dict(os.environ, PYTHONPATH=SRC))
    print(f"regress: exit {r.returncode}: "
          f"{r.stdout.strip().splitlines()[-1] if r.stdout else r.stderr}")
    if r.returncode != 0:
        fail(f"regress over the committed BENCH_*.json: {r.stdout}"
             f"{r.stderr}")
    print(f"dryrun phase: {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    phase_build()
    if sys.argv[1:] == ["--planted"]:
        return planted()
    rows = phase_parity()
    rows += phase_train_parity()
    rows += phase_hybrid_parity()
    # before the training phases: after their profiles torch.profiler
    # loses most short sessions' records (PERF.md section 7)
    rows += phase_xlstm_parity()
    rows += phase_families_parity()
    phase_reference()
    # the families' profiles too run before the training phases'
    phase_families_reference()
    families = {"mixtral_serve": phase_mixtral_serve(),
                "whisper": phase_whisper(), "llava": phase_llava(),
                "config_sweep": phase_config_sweep()}
    phase_train_reference()
    phase_hybrid_reference()
    phase_hybrid_cross_f32()
    by_path = {"serve": phase_serve()}
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    by_path["train"] = phase_train()
    gc.collect()
    torch.cuda.empty_cache()
    api, params, by_path["hybrid_prefill"] = phase_hybrid_prefill()
    by_path["hybrid_serve"] = phase_hybrid_serve(api, params)
    del api, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_xlstm_reference()
    phase_xlstm_cross_f32()
    api, params, by_path["xlstm_prefill"] = phase_xlstm_prefill()
    by_path["xlstm_serve"] = phase_xlstm_serve(api, params)
    del api, params
    gc.collect()
    torch.cuda.empty_cache()
    phase_pipeline_reference()
    by_path["pipeline"] = phase_pipeline_train()
    gc.collect()
    torch.cuda.empty_cache()
    phase_multihost_reference()
    by_path["multihost"] = phase_multihost_inproc()
    gc.collect()
    torch.cuda.empty_cache()
    for k, v in phase_multihost_socket().items():
        by_path["multihost"][k] += v
    gc.collect()
    torch.cuda.empty_cache()
    by_path["dryrun_check"] = phase_dryrun_check()
    by_path.update(families)
    for r in rows:
        r["launches_by_path"] = {p: c.get(r["name"], 0)
                                 for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
