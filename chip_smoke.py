"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no result is printed:

1. build: compile every CUDA source of ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once), timed;
2. parity: each kernel against its plain PyTorch version on the card,
   at the serving path's shapes (smollm-135m: H=9, Kh=3, hd=64), in
   bf16 (tolerance 2e-2) and f32 (1e-4); then timing of each kernel,
   its plain version and one PyTorch library call as a yardstick;
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
   the model asks, within 3e-2 / 1e-3 (relative and absolute, the
   reference kernel test's); flash_attention and flash_decode at the
   shared block's hd 112 (32 heads) within 2e-2 / 1e-4; then each timed
   (no PyTorch call computes the scan: its library time is null);
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
   step and prefill (full tables in ``hybrid_profile.txt`` beside the
   other logs).
13. xlstm parity: ``mlstm_chunkwise`` against its plain version at
   xlstm-125m's full-width prefill (B=8, NH=4, S=2048, hd=384), at a
   ragged S=1000, one short chunk (S=40), S=1 and at hd 64, q/k/v in
   bf16 and f32, y in f32 (2e-4 of max(1, max|ref|)) and bf16
   (element-wise, 2e-2 of |ref| plus 1e-2); then timed (no PyTorch call computes the mLSTM:
   its library time is null);
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
   in ``xlstm_profile.txt``).

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(the counterparts of all five TPU kernels and the attention backward,
plus the attention kernels' rows at hd 112; ``launches`` sums the serve,
train, hybrid prefill, hybrid serve, xlstm prefill and xlstm serve
runs, split in ``launches_by_path``), prefill, decode and training
rates, the whole run's time, and as the last line
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

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and bf16 / f32 flop/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


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


def cuda_kernels(prof):
    """(name, milliseconds) of every CUDA kernel a profiler recorded (the
    device-side marks of ``record_function`` ranges are not kernels)."""
    from torch.autograd import DeviceType
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
            for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(RANGE_PREFIX)]


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


def phase_parity():
    """Each kernel against its plain version at the main path's shapes;
    returns the kernels' timing rows."""
    import torch
    import torch.nn.functional as F
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
    flops = 4 * B * H * hd * S * (S + 1) // 2          # causal half
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * Kh * hd)
    ms, host = time_ms(lambda: FA.flash_attention(q, k, v, causal=True),
                       kernels=("attn_kernel",))
    plain, _ = time_ms(lambda: FA.attention_ref(q, k, v, causal=True),
                       iters=3)
    lib, _ = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "shape": f"B={B} H={H} Kh={Kh} S={S} hd={hd} bf16 causal",
        "max_abs_err": err["flash_attention"], "ms": ms, "host_ms": host,
        "plain_ms": plain,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib})

    # decode: cycle the 30 layers of a full-size cache, as a decode step
    # does, so each launch finds its K/V cold in L2 (30 x 12.6 MB)
    B, W, L = 8, 1024, 30
    q, k, v, valid = _decode_inputs(B, W, torch.bfloat16, gen, L=L)
    valid[0] = 1
    views = [(k[l].permute(0, 2, 1, 3), v[l].permute(0, 2, 1, 3))
             for l in range(L)]
    mask = (valid[:, None, None, :] > 0)
    # only valid slots' K/V rows are needed: count this run's mask
    n_valid = int(valid.sum())
    flops = 4 * H * hd * n_valid
    nbytes = 2 * (2 * n_valid * Kh * hd + 2 * B * H * hd) + 4 * B * W

    def cycle(fn):
        return lambda: [fn(kk, vv) for kk, vv in views]

    ms, host = time_ms(cycle(lambda kk, vv: FD.flash_decode(q, kk, vv,
                                                           valid)), calls=L,
                       kernels=("decode_partial", "decode_merge"))
    plain, _ = time_ms(cycle(lambda kk, vv: FD.decode_ref(q, kk, vv, valid)),
                       calls=L, iters=3)
    q4 = q[:, :, None, :]
    lib, _ = time_ms(cycle(lambda kk, vv: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=mask, enable_gqa=True)), calls=L)
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    rows.append({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:63",
        "shape": f"B={B} H={H} Kh={Kh} W={W} hd={hd} bf16, "
                 f"{n_valid}/{B * W} slots valid",
        "max_abs_err": err["flash_decode"], "ms": ms, "host_ms": host,
        "plain_ms": plain,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib})
    for r in rows:
        print(f"timing {r['name']} ({r['shape']}), device ms per call: "
              f"kernel {r['ms']:.4f} (host-timed {r['host_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")
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
PORT_KERNELS = {"attention": ("attn_kernel", "decode_partial",
                              "decode_merge"), "ssd scan": ("ssd_kernel",),
                "mlstm": ("mlstm_kernel",)}


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
        ours = "; ".join(
            f"{group} kernels {sum(v for k, v in by_name.items() if any(m in k for m in marks)):.3f} ms"  # noqa: E501
            for group, marks in PORT_KERNELS.items())
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
                       kernels=("bwd_dot", "bwd_dkdv", "bwd_dq"))
    plain, _ = time_ms(lambda: FA.attention_bwd_ref(q, k, v, do), iters=3)
    sq = [x.detach().requires_grad_(True) for x in (q, k, v)]
    so = F.scaled_dot_product_attention(*sq, is_causal=True, enable_gqa=True)
    lib, _ = time_ms(lambda: torch.autograd.grad(so, sq, do,
                                                 retain_graph=True))
    flops = 5 * B * H * hd * S * (S + 1)        # 5 products, causal half
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
        "library_ms": lib})
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
        print(f"timing {r['name']} ({r['shape']}), device ms per call: "
              f"kernel {r['ms']:.4f} (host-timed {r['host_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")
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
    parts = "; ".join(f"{k[len(RANGE_PREFIX):]} host "
                      f"{v.get('host_ms', float('nan')):.3f} ms device "
                      f"{v.get('device_ms', float('nan')):.3f} ms"
                      for k, v in sorted(spans.items()))
    print(f"profile train step (team {n}, {tuple(batch['tokens'].shape)} "
          f"tokens): host wall "
          f"{1e3 * wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / (1e3 * wall):.1f}%); {parts}; top: "
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
SCAN_TOL = {"bfloat16": 3e-2, "float32": 1e-3}
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
    import torch.nn.functional as F
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
                       kernels=("ssd_kernel",))
    plain, _ = time_ms(lambda: MS.mamba2_scan_plain(
        *ins, out_dtype=torch.float32), iters=3)
    nbytes = (2 * B * NH * S * P + 4 * B * NH * S * P + 2 * 4 * B * NH * S
              + 2 * 2 * B * S * N)
    # the reference's 256-row chunks: C B^T, its mask, W (x dt), the
    # incoming state's term and the state update
    per_chunk = 2 * c * c * N + c * c + 2 * c * c * P + 4 * c * N * P
    flops = B * NH * math.ceil(S / c) * per_chunk
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
    flops = 4 * B * H * hd * S * (S + 1) // 2
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * H * hd)
    ms, host = time_ms(lambda: FA.flash_attention(q, k, v, causal=True,
                                                  sliding_window=4096),
                       kernels=("attn_kernel",))
    plain, _ = time_ms(lambda: FA.attention_ref(
        q, k, v, causal=True, sliding_window=4096), iters=3)
    lib, _ = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73",
        "shape": f"B={B} H=Kh={H} S={S} hd={hd} bf16 causal (zamba2 shared)",
        "max_abs_err": err["fa112"], "ms": ms, "host_ms": host,
        "plain_ms": plain, "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib})
    del q, k, v

    # the shared block's decode over the serve cell's 27 applications'
    # caches (batch 4, window 256), each cold in L2 when it is read
    B, W, L = 4, 256, 27
    q, k, v, valid = _decode_inputs(B, W, torch.bfloat16, gen, L=L,
                                    **SHARED)
    valid[0] = 1
    views = [(k[l].permute(0, 2, 1, 3), v[l].permute(0, 2, 1, 3))
             for l in range(L)]
    mask = (valid[:, None, None, :] > 0)
    n_valid = int(valid.sum())
    flops = 4 * H * hd * n_valid
    nbytes = 2 * (2 * n_valid * H * hd + 2 * B * H * hd) + 4 * B * W

    def cycle(fn):
        return lambda: [fn(kk, vv) for kk, vv in views]

    ms, host = time_ms(cycle(lambda kk, vv: FD.flash_decode(q, kk, vv,
                                                           valid)), calls=L,
                       kernels=("decode_partial", "decode_merge"))
    plain, _ = time_ms(cycle(lambda kk, vv: FD.decode_ref(q, kk, vv, valid)),
                       calls=L, iters=3)
    q4 = q[:, :, None, :]
    lib, _ = time_ms(cycle(lambda kk, vv: F.scaled_dot_product_attention(
        q4, kk, vv, attn_mask=mask)), calls=L)
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    rows.append({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:63",
        "shape": f"B={B} H=Kh={H} W={W} hd={hd} bf16 (zamba2 shared), "
                 f"{n_valid}/{B * W} slots valid",
        "max_abs_err": err["fd112"], "ms": ms, "host_ms": host,
        "plain_ms": plain, "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib})
    del q, k, v, views
    torch.cuda.empty_cache()
    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        print(f"timing {r['name']} ({r['shape']}), device ms per call: "
              f"kernel {r['ms']:.4f} (host-timed {r['host_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f}, library {lib}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")
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
MLSTM_CHUNK = 64                 # the mLSTM kernel's chunk rows


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


def mlstm_cost(B, NH, S, hd, in_bytes=2, out_bytes=4):
    """(bytes, flops) the chunkwise mLSTM needs: q, k, v read once, logi
    and logf read once, y written once; per 64-row chunk the causal half
    of q kᵀ and of W v, q C, the state update of C, q n and n."""
    nbytes = B * NH * S * (3 * hd * in_bytes + 2 * 4 + hd * out_bytes)
    flops = 0
    for s0 in range(0, S, MLSTM_CHUNK):
        c = min(MLSTM_CHUNK, S - s0)
        tri = c * (c + 1) // 2
        flops += 2 * tri * hd * 2 + 2 * c * hd * hd * 2 + 2 * c * hd * 2
    return nbytes, B * NH * flops


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
                       kernels=("mlstm_kernel",))
    plain, _ = time_ms(lambda: MK.mlstm_chunkwise_plain(
        *ins, out_dtype=torch.float32), iters=3)
    nbytes, flops = mlstm_cost(B, NH, S, hd)
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    row = {
        "name": "mlstm_chunkwise", "route": "cuda",
        "source": "src/repro_torch/csrc/mlstm_chunkwise.cu",
        "replaces": "src/repro/kernels/mlstm_kernel.py:77",
        "shape": f"B={B} NH={NH} S={S} hd={hd}, q/k/v bf16, y f32",
        "max_abs_err": err, "ms": ms, "host_ms": host, "plain_ms": plain,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None}
    del ins
    torch.cuda.empty_cache()
    print(f"timing mlstm_chunkwise ({row['shape']}), device ms per call: "
          f"kernel {ms:.4f} (host-timed {host:.4f}), plain {plain:.4f}, "
          f"library none, bound {row['bound_ms']:.4f} ({row['bound_by']}: "
          f"{nbytes / 1e6:.1f} MB, {flops:.3e} flops)")
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
    rows = phase_parity()
    rows += phase_train_parity()
    rows += phase_hybrid_parity()
    phase_reference()
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
    rows += phase_xlstm_parity()
    phase_xlstm_reference()
    phase_xlstm_cross_f32()
    api, params, by_path["xlstm_prefill"] = phase_xlstm_prefill()
    by_path["xlstm_serve"] = phase_xlstm_serve(api, params)
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
