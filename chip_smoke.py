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
   and both kernels' launch counters, zeroed just before, must be > 0.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
prefill and decode rates, and as the last line
``{"ok": true, "device": {...}}``. f32 matmuls run without TF32
(``allow_tf32`` off) wherever f32 results are compared.
"""
from __future__ import annotations

import json
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


def cuda_kernels(prof):
    """(name, milliseconds) of every CUDA kernel a profiler recorded."""
    from torch.autograd import DeviceType
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


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
    phase_reference()
    launches = phase_serve()
    for r in rows:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
