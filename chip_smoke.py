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

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(all four kernels; ``launches`` sums the serve and train runs, split in
``launches_by_path``), prefill, decode and training rates, and as the
last line ``{"ok": true, "device": {...}}``. f32 matmuls run without
TF32 (``allow_tf32`` off) wherever f32 results are compared.
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


def time_ms(fn, calls: int = 1, iters: int = 10):
    """Per call of the timed function (``fn`` makes ``calls`` calls):
    (device ms, host ms). Device ms sums the CUDA kernels the profiler
    records; host ms is CUDA-event time over back-to-back runs, which
    for a short kernel is the host's launch rate, not the kernel."""
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device = sum(ms for _, ms in cuda_kernels(prof)) / (iters * calls)
    return device, host


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


def _attn_inputs(B, S, dtype, gen):
    import torch
    H, Kh, hd = 9, 3, 64
    # the model's layout: (B, S, heads, hd) projections, passed transposed
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, Kh, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, Kh, hd), generator=gen, device="cuda").to(dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _decode_inputs(B, W, dtype, gen, L=1):
    import torch
    H, Kh, hd = 9, 3, 64
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
    ms, host = time_ms(lambda: FA.flash_attention(q, k, v, causal=True))
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
                                                           valid)), calls=L)
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

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    for dev in ("cpu", "cuda"):
        p = to(params, dev)
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
    from torch.profiler import ProfilerActivity, profile

    B = eng.batch
    tok = torch.zeros((B,), dtype=torch.int32, device="cuda")
    t = torch.full((B,), 900, dtype=torch.int32, device="cuda")
    prompt = torch.tensor(np.random.default_rng(1).integers(
        0, api.cfg.vocab_size, (B, 1024)), device="cuda")
    work = {
        "decode step": (5, lambda: api.decode_fn(
            params, eng.state, {"token": tok, "t": t})),
        "prefill 8x1024": (2, lambda: api.prefill_full_fn(
            params, {"tokens": prompt})),
    }
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
        for kname, ms in cuda_kernels(prof):
            by_name[kname] = by_name.get(kname, 0.0) + ms / n
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        attn = sum(v for k, v in by_name.items()
                   if "decode_partial" in k or "decode_merge" in k
                   or "attn_kernel" in k)
        print(f"profile {name}: host wall {1e3 * wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / (1e3 * wall):.1f}%), "
              f"attention kernels {attn:.3f} ms, {len(by_name)} kernel "
              f"names; top: " + "; ".join(f"{k[:40]} {v:.3f}"
                                          for k, v in top[:4]))
        report.append(f"== {name}: wall {1e3 * wall:.4f} ms/iter, busy "
                      f"{busy:.4f} ms/iter\n" + "\n".join(
                          f"{v:10.4f} ms  {k}" for k, v in top))
    with open(os.path.join(HERE, "chiprun_out", "profile.txt"), "w") as f:
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
                                                   retain_graph=True))
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
    ms, host = time_ms(lambda: BC.bucket_combine(acc, y, gate, op="add"))
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


def main() -> int:
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
    phase_reference()
    phase_train_reference()
    by_path = {"serve": phase_serve()}
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    by_path["train"] = phase_train()
    for r in rows:
        r["launches_by_path"] = {p: c.get(r["name"], 0)
                                 for p, c in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
